"""K3's two modes on the CPU: the exact mode of the Pallas kernel and the
tolerant mode of the sweeps (``ops/ray_intersect.py``, ``tol``).

The JAX package's default closest hit (the brute sweep and the culled
descent of ``nunerf_tpu/tracing/intersect.py``) accepts ``u, v >= -1e-6``
and ``u + v <= 1 + 1e-6``; the port's ``Scene`` runs K3 in that mode on the
card.  Here the tolerant plain version of K3 is held to the port's brute
sweep and to the JAX one, as ``tests/test_pallas_intersect.py`` holds the
JAX pair: ``hit`` equal on every ray, ``t`` within rtol 1e-6 where both hit,
and the index equal where both hit but for counted ties (the sweep's own
``t`` for the other triangle equals its chosen ``t`` within rtol 1e-6: a
shared edge reached at the same depth, whose winner depends on the order of
operations).  Cases: a marched lumpy sphere with random rays, and the
adversarial box of ``tracing/probes.py`` (rays along its faces, through its
edges and vertices).  The culled candidates, of the flat box test and of the
kernel's two-level walk (groups, then their tiles), hold every pair the
tolerant version accepts; the answer built from either equals the brute
plain version bit for bit in both modes, and agrees with the sweeps as the
brute one does; the exact mode is unchanged.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nunerf_tpu.tracing.intersect import ray_mesh_intersect as j_ray_mesh_intersect
from nunerf_tpu_torch.ops import ray_intersect as ri
from nunerf_tpu_torch.tracing import intersect as ti
from nunerf_tpu_torch.tracing.mesh_ops import extract_geometry
from nunerf_tpu_torch.tracing.probes import adversarial_rays, box_mesh
from nunerf_tpu_torch.tracing.scene import Scene
from port_helpers import t


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small CPU tensors gain nothing from torch's threads, and the suite's
    workers share the machine's cores: one thread each keeps them from
    oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = ri.BARY_TOL


def _lumpy():
    def sdf(p):
        r = np.linalg.norm(p, axis=-1)
        return r - (0.5 + 0.05 * np.sin(7 * p[..., 0]) * np.cos(7 * p[..., 1]))
    return extract_geometry(sdf, resolution=20)


def _random_rays(n, seed):
    rs = np.random.RandomState(seed)
    d = rs.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    target = rs.randn(n, 3).astype(np.float32) * 0.2
    k = np.arange(n) % 3
    o = np.where((k == 0)[:, None], target - 2.0 * d,
                 np.where((k == 1)[:, None], rs.rand(n, 3).astype(np.float32) * 0.4 - 0.2,
                          target + 2.0 * d)).astype(np.float32)
    return o, d


MESHES = {"lumpy": _lumpy(), "box": box_mesh()}
TILES = {"lumpy": 64, "box": 8}
GROUPS = {"lumpy": 8, "box": 5}  # several groups on each mesh, the last one short


def _setup(name):
    verts, tris = MESHES[name]
    v0, e1, e2 = (t(a) for a in ti.pad_triangles(verts, tris, 256))
    index = ri.build_cull_index(v0, e1, e2, tile=TILES[name], group=GROUPS[name])
    if name == "box":
        o, d = adversarial_rays(verts, index.box.numpy())
    else:
        o, d = _random_rays(1500, seed=11)
    return v0, e1, e2, index, t(o), t(d)


def _agreement(got, ref_t, ref_idx, ref_hit, o, d, tri):
    """The counts of ``tests/test_pallas_intersect.py``'s comparison, with
    the ties: (rays whose index differs, of them ties, max relative t)."""
    kt, kidx, khit = (np.asarray(a) for a in got)
    assert khit.tolist() == ref_hit.tolist(), "hit differs"
    both = khit & ref_hit
    rel = np.abs(kt[both] - ref_t[both]) / np.abs(ref_t[both])
    differ = np.flatnonzero(both & (kidx != ref_idx))
    # the sweep's own t for K3's triangle, where the two differ
    i = torch.as_tensor(kidx[differ]).long()
    t_own = ti._mt_per_ray(o[differ], d[differ], tri[0][i][:, None], tri[1][i][:, None],
                           tri[2][i][:, None])[:, 0].numpy()
    ties = np.abs(t_own - ref_t[differ]) <= 1e-6 * np.abs(ref_t[differ])
    assert ties.all(), f"{int((~ties).sum())} rays take another triangle at another depth"
    return len(differ), int(ties.sum()), float(rel.max()) if rel.size else 0.0


CANDIDATES = {"flat": ri.cull_candidates_reference,
              "two_level": ri.cull_candidates_two_level_reference}


@pytest.mark.parametrize("level", ["brute", "two_level"])
@pytest.mark.parametrize("name", ["lumpy", "box"])
def test_tolerant_k3_agrees_with_the_sweeps(name, level):
    """The tolerant plain K3 against the port's brute sweep and the JAX
    package's default closest hit: hit equal, t within rtol 1e-6, index equal
    but for counted ties.  ``level`` is how the plain K3 finds its answer:
    every triangle, or the triangles of the kernel's two-level walk."""
    v0, e1, e2, index, o, d = _setup(name)
    if level == "brute":
        got = ri.closest_hit_reference(o, d, v0, e1, e2, tol=TOL)
    else:
        got = ri.closest_hit_culled_reference(
            o, d, index, cand=ri.cull_candidates_two_level_reference(o, d, index), tol=TOL)
    port = ti.ray_mesh_intersect(o, d, v0, e1, e2, tile=256)
    jax_hit = j_ray_mesh_intersect(*(jnp.asarray(a.numpy()) for a in (o, d, v0, e1, e2)),
                                   tile=256)
    for ref in ((port.t.numpy(), port.tri_idx.numpy(), port.hit.numpy()),
                tuple(np.asarray(a) for a in (jax_hit.t, jax_hit.tri_idx, jax_hit.hit))):
        differ, ties, rel = _agreement(got, *ref, o, d, (v0, e1, e2))
        assert rel <= 1e-6, rel
        assert differ == ties
    assert got[2].any() and not got[2].all()


@pytest.mark.parametrize("name", ["lumpy", "box"])
def test_exact_mode_misses_what_the_tolerance_catches(name):
    """The exact mode is the plain version with no tolerance (what K3 did
    before it had one): on the adversarial box it misses rays through edges
    and vertices that the sweeps and the tolerant mode hit, and it never hits
    where the tolerant mode misses."""
    v0, e1, e2, index, o, d = _setup(name)
    exact = ri.closest_hit_reference(o, d, v0, e1, e2, tol=0.0)
    tolerant = ri.closest_hit_reference(o, d, v0, e1, e2, tol=TOL)
    for a, b in zip(exact, ri.closest_hit_reference(o, d, v0, e1, e2)):
        assert torch.equal(a, b)  # the default is the exact mode
    assert not (exact[2] & ~tolerant[2]).any()
    missed = int((tolerant[2] & ~exact[2]).sum())
    if name == "box":
        assert missed > 0, "no adversarial ray separates the modes"


@pytest.mark.parametrize("level", ["flat", "two_level"])
@pytest.mark.parametrize("mode", ["exact", "tolerant"])
@pytest.mark.parametrize("name", ["lumpy", "box"])
def test_culled_answer_and_candidates_in_each_mode(name, mode, level):
    """Every (ray, triangle) pair the mode accepts lies in a tile whose box
    test passes, and the answer built from the candidates alone (of the flat
    test, or of the kernel's two-level walk, which equal each other) equals
    the brute plain version bit for bit."""
    tol = TOL if mode == "tolerant" else 0.0
    v0, e1, e2, index, o, d = _setup(name)
    cand = CANDIDATES[level](o, d, index)
    if level == "two_level":
        assert torch.equal(cand, ri.cull_candidates_reference(o, d, index))
    (ox, oy, oz), (dx, dy, dz) = ri._components(o, d)
    _, valid = ri._mt(ox, oy, oz, dx, dy, dz, index.v0, index.e1, index.e2, tol)
    tile_of = torch.arange(valid.shape[1]) // index.tile
    assert valid.any()
    assert not (valid & ~cand[:, tile_of]).any(), "culling drops an accepted pair"
    got = ri.closest_hit_culled_reference(o, d, index, cand=cand, tol=tol)
    ref = ri.closest_hit_reference(o, d, v0, e1, e2, tol=tol)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and torch.equal(a, b)
    on_cpu = ri.ray_mesh_closest_hit(o, d, v0, e1, e2, tol=tol)
    for a, b in zip(on_cpu, ref):
        assert torch.equal(a, b)


def test_tolerance_constants_round_as_the_sweeps():
    """Both versions hold u, v and u + v to the f32 nearest -tol and 1 + tol,
    which is what a comparison of an f32 tensor with the Python floats of
    the sweeps (``u >= -1e-6``, ``u + v <= 1.0 + 1e-6``) does."""
    lo, hi = ri.bary_bounds(TOL)
    assert lo == float(np.float32(-1e-6)) and hi == float(np.float32(1.0 + 1e-6))
    assert hi == 1.0000009536743164 and ri.bary_bounds(0.0) == (-0.0, 1.0)
    grid = torch.tensor(np.nextafter(np.float32(hi), np.float32(np.inf), dtype=np.float32)
                        - np.arange(-8, 9, dtype=np.float32) * np.float32(2 ** -23))
    assert torch.equal(grid <= hi, grid <= 1.0 + 1e-6)
    small = torch.tensor(np.float32(lo) + np.arange(-8, 9, dtype=np.float32) * np.float32(2 ** -40))
    assert torch.equal(small >= lo, small >= -1e-6)
    with pytest.raises(ValueError):
        ri.bary_bounds(-1e-6)


def test_scene_runs_the_tolerant_mode():
    verts, tris = MESHES["box"]
    scene = Scene((verts, tris), device="cpu")
    assert scene.kernel_tol == TOL and not scene.use_kernel
