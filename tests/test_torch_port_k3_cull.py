"""K3's culling on the CPU: the index, the box test and the answer built from
its candidates.

The kernel tests each ray against the boxes of groups of tiles, then against
the inflated boxes of the tiles of the groups that pass, and sweeps only the
triangles of the tiles that pass (``csrc/ray_intersect.cu``).
``cull_candidates_reference`` is the plain version of the flat box test
(every tile's box, the kernel's f32 operations and margin) and
``cull_candidates_two_level_reference`` of the kernel's walk, which finds
the same tiles bit for bit.  Here the candidates hold every (ray,
triangle) pair that the brute plain version accepts, on a marched mesh and
on an adversarial axis-aligned box mesh (rays along its faces, through its
edges and vertices, with zero direction components, from origins on box
planes); the answer built from the candidates alone equals
``closest_hit_reference`` bit for bit, and the Pallas kernel in interpret
mode on the rays clear of every edge (index and hit exactly, ``t`` to rtol
1e-5: the compiled Pallas body contracts multiplies and adds, see
``tests/test_torch_port_intersect.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nunerf_tpu.ops.pallas_intersect import pallas_ray_mesh_intersect
from nunerf_tpu_torch.ops import ray_intersect as ri
from nunerf_tpu_torch.tracing.intersect import pad_triangles
from nunerf_tpu_torch.tracing.mesh_ops import extract_geometry
from nunerf_tpu_torch.tracing.probes import adversarial_rays, box_mesh
from port_helpers import t


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


def _cases():
    verts, tris = _lumpy()
    bv, bt = box_mesh()
    return {"lumpy": (verts, tris, 64), "box": (bv, bt, 8)}


# tiles a group: several groups on each small mesh, the last one short
GROUPS = {"lumpy": 8, "box": 5}


CASES = _cases()


CANDIDATES = {"flat": ri.cull_candidates_reference,
              "two_level": ri.cull_candidates_two_level_reference}


def _setup(name):
    verts, tris, tile = CASES[name]
    v0, e1, e2 = (t(a) for a in pad_triangles(verts, tris, 256))
    index = ri.build_cull_index(v0, e1, e2, tile=tile, group=GROUPS[name])
    if name == "box":
        o, d = adversarial_rays(verts, index.box.numpy())
    else:
        o, d = _random_rays(1500, seed=7)
    return v0, e1, e2, index, t(o), t(d)


@pytest.mark.parametrize("group", [3, 8])
@pytest.mark.parametrize("name", ["lumpy", "box"])
def test_index_keeps_every_triangle_and_its_bits(name, group):
    verts, tris, tile = CASES[name]
    v0, e1, e2 = (t(a) for a in pad_triangles(verts, tris, 256))
    index = ri.build_cull_index(v0, e1, e2, tile=tile, group=group)
    n = len(tris)
    n_tiles = -(-n // tile)
    n_groups = -(-n_tiles // group)
    assert index.box.shape == (n_tiles, 6) and index.v0.shape == (n_tiles * tile, 3)
    assert index.group == group and index.gbox.shape == (n_groups, 6) and n_groups > 1
    orig = index.orig[:n].long()
    # every real triangle once, the padding rows (e1 = e2 = 0) left out
    assert torch.equal(orig.sort().values, torch.arange(n))
    for a, b in ((index.v0, v0), (index.e1, e1), (index.e2, e2)):
        assert torch.equal(a[:n].view(torch.int32), b[orig].view(torch.int32))
    assert (index.v0[n:] == 1e8).all() and not index.e1[n:].any() and not index.e2[n:].any()
    # each tile's box holds its triangles' corners, with room to spare
    tv = torch.stack([index.v0, index.v0 + index.e1, index.v0 + index.e2], 1)[:n]
    tile_of = torch.arange(n) // tile
    lo, hi = index.box[tile_of, :3], index.box[tile_of, 3:]
    assert (tv.amin(1) > lo).all() and (tv.amax(1) < hi).all()
    # each group's box is the least lo and the largest hi of its tiles'
    # inflated boxes, the last group's tiles too
    group_of = torch.arange(n_tiles) // group
    glo, ghi = index.gbox[group_of, :3], index.gbox[group_of, 3:]
    assert (glo <= index.box[:, :3]).all() and (ghi >= index.box[:, 3:]).all()
    for g in range(n_groups):
        tiles = index.box[g * group:(g + 1) * group]
        assert torch.equal(index.gbox[g, :3], tiles[:, :3].amin(0))
        assert torch.equal(index.gbox[g, 3:], tiles[:, 3:].amax(0))
    with pytest.raises(ValueError):
        ri.build_cull_index(v0, e1, e2, tile=tile, group=ri.MAX_CULL_GROUP + 1)


@pytest.mark.parametrize("level", ["flat", "two_level"])
@pytest.mark.parametrize("name", ["lumpy", "box"])
def test_candidates_hold_every_accepted_pair(name, level):
    """Every (ray, triangle) pair the brute plain version accepts (a valid
    Möller–Trumbore hit, whichever is closest) lies in a tile whose box test
    passes; the box test is a superset of the exact slab test in float64.
    The kernel's walk (groups, then their tiles) finds the flat test's tiles
    bit for bit."""
    v0, e1, e2, index, o, d = _setup(name)
    cand = CANDIDATES[level](o, d, index)
    if level == "two_level":
        assert torch.equal(cand, ri.cull_candidates_reference(o, d, index))
        groups = ri.group_candidates_reference(o, d, index)
        assert groups.float().mean() < 1.0 and (~groups).any(1).any()
    (ox, oy, oz), (dx, dy, dz) = ri._components(o, d)
    _, valid = ri._mt(ox, oy, oz, dx, dy, dz, index.v0, index.e1, index.e2)
    tile_of = torch.arange(valid.shape[1]) // index.tile
    assert valid.any(), "no ray hits the mesh"
    assert not (valid & ~cand[:, tile_of]).any(), "culling drops an accepted pair"
    # the exact slab test on the boxes without margin, in float64
    o64, d64 = o.double()[:, None, :], d.double()[:, None, :]
    margin_free = ri.CULL_MARGIN * 0.5
    lo = index.box[:, :3].double()[None] + margin_free
    hi = index.box[:, 3:].double()[None] - margin_free
    with np.errstate(divide="ignore", invalid="ignore"):
        t0, t1 = (lo - o64) / d64, (hi - o64) / d64
    zero = d64 == 0
    inside = (lo <= o64) & (o64 <= hi)
    tn = torch.where(zero, torch.where(inside, -np.inf, np.inf), torch.minimum(t0, t1))
    tf = torch.where(zero, torch.where(inside, np.inf, -np.inf), torch.maximum(t0, t1))
    exact = tn.amax(-1).clamp_min(0.0) <= tf.amin(-1)
    assert not (exact & ~cand).any()
    # and the culling does cull
    assert cand.float().mean() < (0.5 if name == "lumpy" else 0.9)


def _edge_distance(o, d, verts, tris):
    """Per ray, the float64 distance of its line to the nearest triangle
    edge of the mesh."""
    o, d = o.numpy().astype(np.float64), d.numpy().astype(np.float64)
    e = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]])
    a, b = verts[e[:, 0]].astype(np.float64), verts[e[:, 1]].astype(np.float64)
    u = b - a                                                   # [S, 3]
    w0 = o[:, None] - a[None]                                   # [R, S, 3]
    dd = (d * d).sum(-1)[:, None]
    uu = (u * u).sum(-1)[None]
    du = d @ u.T
    dw, uw = (d[:, None] * w0).sum(-1), (u[None] * w0).sum(-1)
    den = np.maximum(dd * uu - du ** 2, 1e-30)
    sc = np.clip((dd * uw - du * dw) / den, 0.0, 1.0)          # on the segment
    tc = (du * sc - dw) / dd                                    # on the line
    gap = w0 + tc[..., None] * d[:, None] - sc[..., None] * u[None]
    return np.sqrt((gap ** 2).sum(-1)).min(1)


@pytest.mark.parametrize("level", ["flat", "two_level"])
@pytest.mark.parametrize("name", ["lumpy", "box"])
def test_culled_answer_equals_the_plain_version_and_pallas(name, level):
    """Bit for bit the plain version's answer on every ray.  The Pallas
    kernel contracts multiplies and adds into FMAs, so on a ray through an
    edge or a vertex it can take the neighbouring triangle or miss where the
    plain version (and K3) hit: the comparison with it is exact on the rays
    whose line keeps 1e-5 from every edge: nearly all the random rays of the
    marched mesh, and a share of the adversarial ones.  ``level`` is the
    culling the answer is built from: the flat box test or the kernel's
    two-level walk."""
    v0, e1, e2, index, o, d = _setup(name)
    got = ri.closest_hit_culled_reference(o, d, index, cand=CANDIDATES[level](o, d, index))
    ref = ri.closest_hit_reference(o, d, v0, e1, e2)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and torch.equal(a, b)
    jt, jidx, jhit = pallas_ray_mesh_intersect(
        jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), jnp.asarray(v0.numpy()),
        jnp.asarray(e1.numpy()), jnp.asarray(e2.numpy()), interpret=True)
    verts, tris, _ = CASES[name]
    clear = _edge_distance(o, d, verts, tris) > 1e-5
    assert clear.mean() > (0.99 if name == "lumpy" else 0.2)
    assert got[2].numpy()[clear].tolist() == np.asarray(jhit)[clear].tolist()
    assert got[1].numpy()[clear].tolist() == np.asarray(jidx)[clear].tolist()
    np.testing.assert_allclose(got[0].numpy()[clear], np.asarray(jt)[clear], rtol=1e-5)
    assert got[2].any() and not got[2].all()


def test_empty_inputs():
    """No rays; no tiles (every row padding); rays that pass no tile."""
    v0, e1, e2, index, o, d = _setup("box")
    z = o[:0]
    for a in ri.closest_hit_culled_reference(z, z, index):
        assert a.shape == (0,)
    pad = torch.full((256, 3), 1e8), torch.zeros((256, 3)), torch.zeros((256, 3))
    empty = ri.build_cull_index(*pad)
    assert empty.box.shape == (0, 6) and empty.v0.shape == (0, 3)
    assert empty.gbox.shape == (0, 6)
    assert ri.cull_candidates_two_level_reference(o, d, empty).shape == (len(o), 0)
    tt, ii, hh = ri.closest_hit_culled_reference(o, d, empty)
    assert (tt == ri.MISS_T).all() and not ii.any() and not hh.any()
    away = torch.tensor([[0.0, 0.0, 3.0]]), torch.tensor([[0.0, 0.0, 1.0]])
    assert not ri.cull_candidates_reference(*away, index).any()
    assert not ri.group_candidates_reference(*away, index).any()
    tt, ii, hh = ri.closest_hit_culled_reference(*away, index)
    assert float(tt[0]) == ri.MISS_T and int(ii[0]) == 0 and not bool(hh[0])
