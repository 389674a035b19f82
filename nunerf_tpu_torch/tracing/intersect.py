"""Ray/triangle-mesh intersection in plain PyTorch; counterpart of
``nunerf_tpu/tracing/intersect.py`` (the reference ships rays to OptiX,
``network/tracing_optix.py:154-158``).

* ``ray_mesh_intersect``: the brute sweep, a loop over triangle tiles
  carrying each ray's best hit;
* ``ray_mesh_intersect_culled``: nearest-first descent over Morton-sorted
  triangle tiles with per-tile boxes (the stand-in for the reference's BVH,
  ``raytracing/src/bvh.cu:255-301``);
* ``diff_intersect``: the differentiable re-intersection of each ray with its
  hit triangle (``DiffRender.py:62-125``), where the gradients come from.

The closest-hit queries have no gradient.  The hand-written closest-hit
kernel is in ``ops/ray_intersect.py``; its default mode in ``Scene`` has the
barycentric tolerance these two sweeps allow, and its exact mode, that of the
Pallas kernel, has none.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from nunerf_tpu_torch.ops.ray_intersect import morton_tiles

MISS_T = 1e7  # reference miss depth sentinel (cuda/triangle.cu miss = 10000000)


class Hit(NamedTuple):
    t: torch.Tensor        # [R] hit distance (MISS_T where miss)
    tri_idx: torch.Tensor  # [R] int32 triangle index (0 where miss)
    hit: torch.Tensor      # [R] bool


def _mt_per_ray(rays_o, rays_d, v0, e1, e2, eps=1e-9):
    """Möller–Trumbore of rays [R,3] against per-ray candidates [R,C,3] (or
    anything that broadcasts to it) -> t [R,C] (MISS_T where miss).  No
    backface culling (glass needs both sides).

    The small negative barycentric tolerance keeps rays through shared
    vertices and edges from missing every adjacent triangle once f32
    rounding pushes u or v epsilon-negative.  It is absolute, so fine for
    closest-hit on unit-bound scenes but not for hit-count parity queries: a
    shared edge can register two hits at the same t."""
    d = rays_d[:, None, :]
    pvec = torch.linalg.cross(d, e2)
    det = torch.sum(pvec * e1, dim=-1)
    ok = torch.abs(det) > eps
    inv_det = torch.where(ok, 1.0 / det, torch.zeros_like(det))
    tvec = rays_o[:, None, :] - v0
    u = torch.sum(tvec * pvec, dim=-1) * inv_det
    qvec = torch.linalg.cross(tvec, e1)
    v = torch.sum(qvec * d, dim=-1) * inv_det
    t = torch.sum(qvec * e2, dim=-1) * inv_det
    tol = 1e-6
    valid = ok & (u >= -tol) & (v >= -tol) & (u + v <= 1.0 + tol) & (t > 1e-5)
    return torch.where(valid, t, torch.full_like(t, MISS_T))


def _moller_trumbore_tile(rays_o, rays_d, v0, e1, e2, eps=1e-9):
    """All-pairs test: rays [R,3] x triangle tile [T,3] -> t [R,T]."""
    return _mt_per_ray(rays_o, rays_d, v0[None], e1[None], e2[None], eps)


def _first_argmin(t):
    """(min, index of the first minimum) over the last axis."""
    tmin = torch.min(t, dim=-1).values
    ar = torch.arange(t.shape[-1], device=t.device, dtype=torch.int32)
    first = torch.where(t == tmin[..., None], ar, torch.full_like(ar, t.shape[-1]))
    return tmin, torch.min(first, dim=-1).values


@torch.no_grad()
def ray_mesh_intersect(rays_o, rays_d, v0, e1, e2, tile: int = 2048) -> Hit:
    """Closest-hit query, the brute sweep.  v0/e1/e2: [T,3] padded to a
    multiple of ``tile`` (``pad_triangles``).  Not differentiable (use
    ``diff_intersect`` on the hit triangle for gradients)."""
    rays_o, rays_d = rays_o.detach(), rays_d.detach()
    rn = rays_o.shape[0]
    best_t = torch.full((rn,), MISS_T, dtype=rays_o.dtype, device=rays_o.device)
    best_i = torch.zeros((rn,), dtype=torch.int32, device=rays_o.device)
    for base in range(0, v0.shape[0], tile):
        sl = slice(base, base + tile)
        t = _moller_trumbore_tile(rays_o, rays_d, v0[sl], e1[sl], e2[sl])
        tmin, imin = _first_argmin(t)
        better = tmin < best_t
        best_t = torch.where(better, tmin, best_t)
        best_i = torch.where(better, imin + base, best_i)
    return Hit(t=best_t, tri_idx=best_i, hit=best_t < MISS_T * 0.5)


def pad_triangles(verts, tris, tile: int = 2048):
    """(v0, e1, e2) numpy arrays padded to a tile multiple with far-away
    degenerate triangles that can never be hit."""
    v0 = verts[tris[:, 0]]
    e1 = verts[tris[:, 1]] - v0
    e2 = verts[tris[:, 2]] - v0
    n = len(v0)
    pad = (-n) % tile
    if pad:
        v0 = np.concatenate([v0, np.full((pad, 3), 1e8, np.float32)], 0)
        e1 = np.concatenate([e1, np.zeros((pad, 3), np.float32)], 0)
        e2 = np.concatenate([e2, np.zeros((pad, 3), np.float32)], 0)
    return (v0.astype(np.float32), e1.astype(np.float32), e2.astype(np.float32))


# ---------------------------------------------------------------------------
# Tile-culled traversal.  Triangles are Morton-sorted into spatially coherent
# fixed-size tiles with precomputed boxes; every ray slab-tests all boxes,
# sorts the tiles by entry distance, and a loop sweeps them nearest first,
# ``group`` tiles a round, until no ray's next tile can beat its best hit.
# Exact: a hit is accepted only over tiles whose entry precedes it.
# ---------------------------------------------------------------------------


class TileIndex(NamedTuple):
    v0: torch.Tensor    # [n_tiles, T, 3] tile-grouped triangle origin
    e1: torch.Tensor    # [n_tiles, T, 3]
    e2: torch.Tensor    # [n_tiles, T, 3]
    lo: torch.Tensor    # [n_tiles, 3] tile box min (+inf for padding tiles)
    hi: torch.Tensor    # [n_tiles, 3] tile box max (-inf for padding tiles)
    perm: torch.Tensor  # [n_tiles * T] int32: padded slot -> original tri idx


def build_tile_index(verts, tris, tile: int = 128, group: int = 16,
                     device="cpu") -> TileIndex:
    """Host-side build (construction time only): Morton-sort triangles by
    centroid, group into ``tile``-sized tiles, record per-tile boxes
    (``morton_tiles``, shared with K3's index).  The tile count is padded to
    a multiple of ``group`` with never-hit tiles."""
    verts = np.asarray(verts, np.float32)
    tris = np.asarray(tris, np.int32)
    corners = verts[tris]                         # [n, 3verts, 3]
    n = len(tris)
    n_tiles = -(-n // tile)
    n_tiles += (-n_tiles) % group
    slots = n_tiles * tile
    order, lo, hi = morton_tiles(corners.mean(1), corners.min(1), corners.max(1),
                                 n_tiles, tile)
    perm = np.zeros(slots, np.int32)
    perm[:n] = order

    tv = corners[order]
    v0 = np.full((slots, 3), 1e8, np.float32)     # degenerate padding
    e1 = np.zeros((slots, 3), np.float32)
    e2 = np.zeros((slots, 3), np.float32)
    v0[:n] = tv[:, 0]
    e1[:n] = tv[:, 1] - tv[:, 0]
    e2[:n] = tv[:, 2] - tv[:, 0]

    def dev(a):
        return torch.as_tensor(a, device=device)

    return TileIndex(
        v0=dev(v0.reshape(n_tiles, tile, 3)), e1=dev(e1.reshape(n_tiles, tile, 3)),
        e2=dev(e2.reshape(n_tiles, tile, 3)), lo=dev(lo), hi=dev(hi), perm=dev(perm))


@torch.no_grad()
def ray_mesh_intersect_culled(rays_o, rays_d, index: TileIndex,
                              group: int = 16, rounds_out: list = None) -> Hit:
    """Closest-hit via nearest-first tile descent.

    Same results as ``ray_mesh_intersect`` (``tri_idx`` may differ where two
    triangles share the exact same t, e.g. along shared edges).  The loop's
    condition is an ``any`` over rays, read on the host: one synchronisation
    a round.  ``rounds_out``, when given, receives the number of rounds."""
    rays_o, rays_d = rays_o.detach(), rays_d.detach()
    n_tiles, T, _ = index.v0.shape
    rn = rays_o.shape[0]
    dev = rays_o.device

    # slab entry-t for every (ray, tile), in chunks that bound the
    # [R, chunk, 3] temporaries at mask-render ray counts
    tiny = torch.where(rays_d >= 0, torch.full_like(rays_d, 1e-12),
                       torch.full_like(rays_d, -1e-12))
    safe_d = torch.where(torch.abs(rays_d) < 1e-12, tiny, rays_d)
    inv_d = 1.0 / safe_d
    chunk = min(n_tiles, 512)
    entries = []
    for c0 in range(0, n_tiles, chunk):
        lo, hi = index.lo[c0:c0 + chunk], index.hi[c0:c0 + chunk]
        t0 = (lo[None] - rays_o[:, None, :]) * inv_d[:, None, :]
        t1 = (hi[None] - rays_o[:, None, :]) * inv_d[:, None, :]
        tn = torch.clamp(torch.max(torch.minimum(t0, t1), dim=-1).values, min=0.0)
        tf = torch.min(torch.maximum(t0, t1), dim=-1).values
        entries.append(torch.where(tf >= tn, tn, torch.full_like(tn, MISS_T)))
    entry = torch.cat(entries, dim=1)

    order_entry, order_idx = torch.sort(entry, dim=-1, stable=True)
    n_groups = n_tiles // group

    best_t = torch.full((rn,), MISS_T, dtype=rays_o.dtype, device=dev)
    best_i = torch.zeros((rn,), dtype=torch.int32, device=dev)
    g = 0
    while g < n_groups and bool(torch.any(order_entry[:, g * group] < best_t)):
        tiles = order_idx[:, g * group:(g + 1) * group]          # [R, group]
        tent = order_entry[:, g * group:(g + 1) * group]
        t = _mt_per_ray(rays_o, rays_d,
                        index.v0[tiles].reshape(rn, group * T, 3),
                        index.e1[tiles].reshape(rn, group * T, 3),
                        index.e2[tiles].reshape(rn, group * T, 3))
        # a tile whose entry can't beat the current best can't improve:
        # masking it keeps the early exit conservative and exact
        live = tent < best_t[:, None]
        t = torch.where(torch.repeat_interleave(live, T, dim=1), t,
                        torch.full_like(t, MISS_T))
        tmin, c = _first_argmin(t)
        c = c.long()
        tile_of = torch.gather(tiles, 1, (c // T)[:, None])[:, 0]
        oid = index.perm[tile_of * T + (c % T)]
        better = tmin < best_t
        best_t = torch.where(better, tmin, best_t)
        best_i = torch.where(better, oid, best_i)
        g += 1
    if rounds_out is not None:
        rounds_out.append(g)
    return Hit(t=best_t, tri_idx=best_i, hit=best_t < MISS_T * 0.5)


def diff_intersect(rays_o, rays_d, tv0, tv1, tv2):
    """Differentiable Möller–Trumbore re-intersection against known triangles
    (one per ray), the reference's gradient-recovery trick
    (DiffRender.py:62-125 ``JIT_Dintersect``).

    tv0/tv1/tv2: [R,3] vertices of each ray's hit triangle.
    Returns (t [R,1], u [R,1], v [R,1], valid [R])."""
    e1 = tv1 - tv0
    e2 = tv2 - tv0
    pvec = torch.linalg.cross(rays_d, e2)
    det = torch.sum(pvec * e1, dim=-1, keepdim=True)
    safe_det = torch.where(torch.abs(det) > 1e-12, det, torch.full_like(det, 1e-12))
    inv_det = 1.0 / safe_det
    tvec = rays_o - tv0
    u = torch.sum(tvec * pvec, dim=-1, keepdim=True) * inv_det
    qvec = torch.linalg.cross(tvec, e1)
    v = torch.sum(qvec * rays_d, dim=-1, keepdim=True) * inv_det
    t = torch.sum(qvec * e2, dim=-1, keepdim=True) * inv_det
    valid = torch.abs(det[..., 0]) > 1e-12
    return t, u, v, valid


def auto_tile_params(n_tris: int) -> Tuple[int, int]:
    """√n tile law: the tile grows with the mesh so that the tile count, and
    with it the per-ray slab sweep and the nearest-first sort, stays ~√n
    instead of linear.  The 2.7 divisor keeps tile=128 at 117k triangles;
    ``group`` shrinks for big tiles so that a round's candidate gather stays
    about 4k triangles.  Returns (tile, group)."""
    t_pow = int(round(np.log2(max(np.sqrt(n_tris) / 2.7, 128.0))))
    tile = int(np.clip(2 ** t_pow, 128, 2048))
    group = max(4, min(16, 4096 // tile))
    return tile, group
