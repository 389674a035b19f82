"""The port's ray/mesh intersection against the JAX package (CPU, f32).

Meshes and rays are made with numpy from a seed and handed to both sides.
The sweeps do the same f32 arithmetic in another order of fusion, so hit
masks and triangle indices are compared exactly on rays clear of an edge and
``t`` to rtol 1e-6 (the JAX package's own tolerance between its sweeps).
The plain version of the closest-hit kernel K3 is held to the Pallas kernel
in interpret mode, as ``tests/test_pallas_intersect.py`` runs it; there ``t``
is held to rtol 1e-5: the plain version rounds after every multiply and add,
the compiled Pallas body contracts them, and ``t`` moves by two or three
units in its last place.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nunerf_tpu.ops.pallas_intersect import pallas_ray_mesh_intersect
from nunerf_tpu.tracing import intersect as ji
from nunerf_tpu_torch.ops import ray_intersect as ri
from nunerf_tpu_torch.tracing import intersect as pi
from nunerf_tpu_torch.tracing.mesh_ops import extract_geometry
from port_helpers import t


@pytest.fixture(scope="module")
def mesh():
    def sdf(p):
        r = np.linalg.norm(p, axis=-1)
        return r - (0.5 + 0.05 * np.sin(7 * p[..., 0]) * np.cos(7 * p[..., 1]))
    return extract_geometry(sdf, resolution=20)


def _rays(n, seed=0):
    """A third each: towards the mesh from outside, from inside it, away."""
    rs = np.random.RandomState(seed)
    d = rs.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    target = rs.randn(n, 3).astype(np.float32) * 0.2
    k = (np.arange(n) % 3)[:, None]
    o = np.where(k == 0, target - 2.0 * d,
                 np.where(k == 1, rs.rand(n, 3).astype(np.float32) * 0.4 - 0.2,
                          target + 2.0 * d)).astype(np.float32)
    return o, d


def _assert_hits_equal(port, jax_hit, check_idx=True, rtol=1e-6):
    pt, pidx, phit = (np.asarray(a) for a in port)
    jt, jidx, jhit = (np.asarray(a) for a in jax_hit)
    np.testing.assert_array_equal(phit, jhit)
    np.testing.assert_allclose(pt, jt, rtol=rtol)
    if check_idx:
        np.testing.assert_array_equal(pidx, jidx)
    assert pidx.dtype == np.int32 and (pidx[~phit] == 0).all()
    assert (pt[~phit] == np.float32(pi.MISS_T)).all()


def test_pad_triangles_and_constants(mesh):
    verts, tris = mesh
    assert pi.MISS_T == ji.MISS_T == ri.MISS_T
    for tile in (256, 2048):
        for a, b in zip(pi.pad_triangles(verts, tris, tile), ji.pad_triangles(verts, tris, tile)):
            assert a.dtype == np.float32 and a.shape[0] % tile == 0
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("tile", [256, 1024])
def test_brute_sweep_matches_jax(mesh, tile):
    verts, tris = mesh
    v0, e1, e2 = pi.pad_triangles(verts, tris, tile)
    o, d = _rays(300)
    port = pi.ray_mesh_intersect(t(o), t(d), t(v0), t(e1), t(e2), tile=tile)
    jhit = ji.ray_mesh_intersect(o, d, v0, e1, e2, tile=tile)
    assert 0.25 < np.asarray(jhit.hit).mean() < 0.75
    _assert_hits_equal(port, jhit)


def test_tile_index_and_auto_params_match_jax(mesh):
    verts, tris = mesh
    for n in (100, 30000, 117000, 500000, 2_000_000, 40_000_000):
        assert pi.auto_tile_params(n) == ji.auto_tile_params(n)
    q = np.random.RandomState(0).randint(0, 1024, (50, 3)).astype(np.uint32)
    np.testing.assert_array_equal(ri._morton3(q), ji._morton3(q))
    a = pi.build_tile_index(verts, tris, tile=32, group=4)
    b = ji.build_tile_index(verts, tris, tile=32, group=4)
    for name in a._fields:
        np.testing.assert_array_equal(getattr(a, name).numpy(), np.asarray(getattr(b, name)),
                                      err_msg=name)


def test_culled_descent_matches_jax_and_brute(mesh):
    verts, tris = mesh
    o, d = _rays(300, seed=1)
    pidx = pi.build_tile_index(verts, tris, tile=32, group=4)
    jidx = ji.build_tile_index(verts, tris, tile=32, group=4)
    rounds = []
    port = pi.ray_mesh_intersect_culled(t(o), t(d), pidx, group=4, rounds_out=rounds)
    jhit = ji.ray_mesh_intersect_culled(o, d, jidx, group=4)
    # the early exit is live: fewer rounds than groups of tiles
    assert 1 <= rounds[0] < pidx.v0.shape[0] // 4
    _assert_hits_equal(port, jhit)
    v0, e1, e2 = pi.pad_triangles(verts, tris, 256)
    brute = pi.ray_mesh_intersect(t(o), t(d), t(v0), t(e1), t(e2), tile=256)
    # tri_idx may differ from the brute sweep's where two triangles share t
    _assert_hits_equal(port, brute, check_idx=False)
    assert (port.tri_idx == brute.tri_idx).float().mean() > 0.99


def test_diff_intersect_values_and_gradients_match_jax(mesh):
    verts, tris = mesh
    rs = np.random.RandomState(2)
    n = 64
    tri = tris[rs.randint(0, len(tris), n)]
    tv = [verts[tri[:, k]] for k in range(3)]
    bary = rs.dirichlet(np.ones(3), n).astype(np.float32)
    target = sum(b[:, None] * v for b, v in zip(bary.T, tv))
    d = rs.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = (target - 1.5 * d).astype(np.float32)
    d[0] = tv[1][0] - tv[0][0]  # a ray in its triangle's plane: guarded determinant
    w = rs.randn(n, 3).astype(np.float32)

    def jloss(o_, d_, a, b, c):
        tt, u, v, valid = ji.diff_intersect(o_, d_, a, b, c)
        m = valid[:, None]
        return jnp.sum(jnp.where(m, jnp.concatenate([tt, u, v], -1), 0.0) * w)

    jout = ji.diff_intersect(o, d, *tv)
    jg = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(o, d, *tv)
    leaves = [t(a).requires_grad_(True) for a in (o, d, *tv)]
    pout = pi.diff_intersect(*leaves)
    np.testing.assert_array_equal(pout[3].numpy(), np.asarray(jout[3]))
    assert not bool(pout[3][0]) and bool(pout[3][1:].all())
    valid = np.asarray(jout[3])
    for a, e in zip(pout[:3], jout[:3]):  # f32 sums in another order
        np.testing.assert_allclose(a.detach().numpy()[valid], np.asarray(e)[valid],
                                   rtol=1e-5, atol=1e-6)
    m = pout[3][:, None]
    torch.sum(torch.where(m, torch.cat(pout[:3], -1), torch.zeros(())) * t(w)).backward()
    for a, e in zip(leaves, jg):
        e = np.asarray(e)
        assert np.isfinite(a.grad.numpy()).all()
        np.testing.assert_allclose(a.grad.numpy(), e, rtol=1e-4, atol=1e-5 * np.abs(e).max())


@pytest.mark.parametrize("n_rays", [1, 300, 1100])
def test_plain_closest_hit_matches_pallas_kernel(mesh, n_rays):
    """The plain version of K3 against the Pallas kernel in interpret mode:
    a single ray, a ragged count and one past the kernel's 1024-ray block."""
    verts, tris = mesh
    v0, e1, e2 = pi.pad_triangles(verts, tris, 256)
    o, d = _rays(n_rays, seed=3)
    o[0], d[0] = (0.0, 3.0, 0.0), (0.0, 1.0, 0.0)  # an all-miss ray
    jhit = pallas_ray_mesh_intersect(jnp.asarray(o), jnp.asarray(d), jnp.asarray(v0),
                                     jnp.asarray(e1), jnp.asarray(e2), interpret=True)
    port = ri.ray_mesh_closest_hit(t(o), t(d), t(v0), t(e1), t(e2))
    _assert_hits_equal(port, jhit, rtol=1e-5)
    assert not bool(port[2][0]) and int(port[1][0]) == 0
    # skipping the padding rows changes nothing; other tilings neither
    n = len(tris)
    for alt in (ri.ray_mesh_closest_hit(t(o), t(d), t(v0[:n]), t(e1[:n]), t(e2[:n])),
                ri.closest_hit_reference(t(o), t(d), t(v0), t(e1), t(e2), tile=96)):
        for a, b in zip(alt, port):
            assert torch.equal(a, b)
    # ... and against the brute sweep, which allows a barycentric tolerance,
    # on the rays where both agree on the hit (all but edge grazers)
    brute = pi.ray_mesh_intersect(t(o), t(d), t(v0), t(e1), t(e2), tile=256)
    same = (brute.hit == port[2]).numpy()
    assert same.mean() > 0.99
    # (the sweep sums its three products in another order: rtol 1e-5)
    np.testing.assert_allclose(port[0].numpy()[same], brute.t.numpy()[same], rtol=1e-5)


def test_edge_ray_shows_the_missing_tolerance():
    """Two triangles sharing the edge x = 0; a ray aimed a hair outside the
    first triangle's edge (u = -5e-7): the brute sweep's -1e-6 tolerance
    takes it, K3's plain version and the Pallas kernel do not.  A tie on t
    goes to the lowest index."""
    v0 = np.array([[0, 0, 1], [5, 5, 1]], np.float32)
    e1 = np.array([[1, 0, 0], [1, 0, 0]], np.float32)
    e2 = np.array([[0, 1, 0], [0, 1, 0]], np.float32)
    pad = 254
    v0p = np.concatenate([v0, np.full((pad, 3), 1e8, np.float32)])
    e1p = np.concatenate([e1, np.zeros((pad, 3), np.float32)])
    e2p = np.concatenate([e2, np.zeros((pad, 3), np.float32)])
    o = np.array([[-5e-7, 0.25, 0.0], [0.25, 0.25, 0.0]], np.float32)
    d = np.array([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]], np.float32)

    brute = pi.ray_mesh_intersect(t(o), t(d), t(v0p), t(e1p), t(e2p), tile=256)
    jbrute = ji.ray_mesh_intersect(o, d, v0p, e1p, e2p, tile=256)
    plain = ri.ray_mesh_closest_hit(t(o), t(d), t(v0p), t(e1p), t(e2p))
    jk = pallas_ray_mesh_intersect(jnp.asarray(o), jnp.asarray(d), jnp.asarray(v0p),
                                   jnp.asarray(e1p), jnp.asarray(e2p), interpret=True)
    assert brute.hit.tolist() == np.asarray(jbrute.hit).tolist() == [True, True]
    assert plain[2].tolist() == np.asarray(jk[2]).tolist() == [False, True]
    assert float(plain[0][0]) == np.float32(ri.MISS_T) and int(plain[1][0]) == 0

    # coincident triangles: the first one wins in both, across tiles too
    v0c = np.concatenate([np.repeat(v0[:1], 300, 0), np.full((212, 3), 1e8, np.float32)])
    e1c = np.concatenate([np.repeat(e1[:1], 300, 0), np.zeros((212, 3), np.float32)])
    e2c = np.concatenate([np.repeat(e2[:1], 300, 0), np.zeros((212, 3), np.float32)])
    plain = ri.ray_mesh_closest_hit(t(o[1:]), t(d[1:]), t(v0c), t(e1c), t(e2c))
    jk = pallas_ray_mesh_intersect(jnp.asarray(o[1:]), jnp.asarray(d[1:]), jnp.asarray(v0c),
                                   jnp.asarray(e1c), jnp.asarray(e2c), interpret=True)
    assert int(plain[1][0]) == int(jk[1][0]) == 0 and bool(plain[2][0])


def test_closest_hit_wrapper_refuses_what_the_kernel_does_not_take():
    from nunerf_tpu_torch.ops.ray_intersect import _validate, closest_hit_cuda
    z = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="CUDA"):
        closest_hit_cuda(z, z, ri.build_cull_index(z, z, z))
    with pytest.raises(ValueError, match="CUDA"):
        _validate(z, z, z, z, z)
    # the plain version counts no launch
    before = dict(ri.launches)
    ri.ray_mesh_closest_hit(z, z + 1.0, z, z, z)
    assert ri.launches == before
