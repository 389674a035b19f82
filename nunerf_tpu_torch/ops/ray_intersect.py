"""Ray / triangle-soup closest hit: CUDA kernel K3 with its plain PyTorch
version.

Counterpart of ``nunerf_tpu/ops/pallas_intersect.py``.  Both versions compute,
for every ray, the closest Möller–Trumbore hit over triangles given as
``v0``, ``e1 = v1 - v0``, ``e2 = v2 - v0``:

* det eps 1e-9, ``inv_det = 0`` where ``|det| <= eps``; a hit needs
  ``u >= -tol``, ``v >= -tol``, ``u + v <= 1 + tol`` and ``t > 1e-5``, else
  ``t = MISS_T``.  ``tol`` selects the mode: ``0``, the exact mode of the
  Pallas kernel (which has no barycentric tolerance, so a ray through a
  shared edge can miss every adjacent triangle), or ``BARY_TOL`` (1e-6), the
  tolerance of the brute sweep and the culled descent of
  ``tracing/intersect.py`` and of the JAX package's default closest hit.
  Both versions compare with the same f32 constants, ``bary_bounds(tol)``;
* ties on ``t`` go to the lowest triangle index; an all-miss ray keeps
  index 0; ``hit = t < MISS_T / 2``;
* no gradient: the inputs are detached, the differentiable hit comes from
  ``tracing.intersect.diff_intersect``.

``closest_hit_reference`` is the plain version (a loop over triangle tiles,
the same comparisons, one rounding an operation).  The kernel
(``csrc/ray_intersect.cu``) culls: it runs over a ``CullIndex``, built once
per mesh by ``build_cull_index`` (triangles Morton-sorted into tiles with
inflated boxes, each keeping its f32 bits and its original index), tests
every ray against every tile's box, and sweeps only the triangles of the
tiles that pass.  ``cull_candidates_reference`` is the plain version of that
box test and ``closest_hit_culled_reference`` the answer built from its
candidates alone; culling changes how the answer is found, not the answer.
``ray_mesh_closest_hit`` is the entry point (``Scene.intersect`` calls it):
on CUDA tensors it launches the kernel over the index it is given, and raises
without one; on CPU tensors, and only there, it runs the brute plain
version.  The kernel multiplies and adds without FMA contraction, so on the
card ``t``, the index and ``hit`` equal the plain version's exactly.

``launches["closest_hit"]`` adds one per kernel call; ``launches["cull_bin"]``
one per launch of the bin pass alone (``cull_candidates_cuda``, which reads
the kernel's candidate lists back for the card checks).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

MISS_T = 1e7
BARY_TOL = 1e-6     # the sweeps' barycentric tolerance (tracing/intersect.py)
TRI_TILE = 256      # triangles per tile of the plain version's loop
OPS_PER_PAIR = 46   # f32 multiplies, adds, subtracts and the divide of a pair
OPS_PER_BOX = 16    # f32 operations of a ray-box slab test (3 divides, 6 subtracts, 6 multiplies, compares)
CULL_TILE = 64      # triangles a tile of the kernel's index
CULL_MARGIN = 1e-3  # box inflation, of the mesh's size (csrc/ray_intersect.cu)
SMALL_D = 1e-20     # direction components below this take no reciprocal
LIST_BYTES = 256 << 20  # the kernel's ray lists: rays go through in chunks under this
MAX_CULL_TILE = 128     # MAX_TILE in csrc/ray_intersect.cu

launches = {"closest_hit": 0, "cull_bin": 0}


def reset_launches():
    for k in launches:
        launches[k] = 0


def bary_bounds(tol: float):
    """(lo, hi): the f32 values that ``u``, ``v`` and ``u + v`` are held to in
    the mode ``tol`` (``u >= lo``, ``v >= lo``, ``u + v <= hi``), the nearest
    f32 to ``-tol`` and to ``1 + tol``, as a comparison of an f32 tensor with
    a Python float rounds them (1e-6 gives -9.99999997e-7 and 1.00000095)."""
    if not 0.0 <= tol < 0.5:
        raise ValueError(f"barycentric tolerance {tol}: 0 (exact) up to 0.5")
    return float(np.float32(-tol)), float(np.float32(1.0 + tol))


def _mt(ox, oy, oz, dx, dy, dz, v0, e1, e2, tol: float = 0.0):
    """Möller–Trumbore of rays (components [R, 1]) against triangles ([T, 3])
    -> (t [R, T], valid [R, T]), component by component in the kernel's order
    of operations, so that each value carries the same roundings."""
    lo, hi = bary_bounds(tol)
    v0x, v0y, v0z = (v0[:, i][None, :] for i in range(3))
    e1x, e1y, e1z = (e1[:, i][None, :] for i in range(3))
    e2x, e2y, e2z = (e2[:, i][None, :] for i in range(3))
    # pvec = d x e2
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = pvx * e1x + pvy * e1y + pvz * e1z
    ok = torch.abs(det) > 1e-9
    inv_det = torch.where(ok, 1.0 / det, torch.zeros_like(det))
    # tvec = o - v0
    tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    # qvec = tvec x e1
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (qvx * dx + qvy * dy + qvz * dz) * inv_det
    t = (qvx * e2x + qvy * e2y + qvz * e2z) * inv_det
    return t, ok & (u >= lo) & (v >= lo) & (u + v <= hi) & (t > 1e-5)


def _components(rays_o, rays_d):
    return ([rays_o[:, i:i + 1] for i in range(3)],
            [rays_d[:, i:i + 1] for i in range(3)])


@torch.no_grad()
def closest_hit_reference(rays_o, rays_d, v0, e1, e2, tile: int = TRI_TILE,
                          tol: float = 0.0):
    """Plain PyTorch version of K3 in the mode ``tol``: (t [R] f32, tri_idx
    [R] i32, hit [R] bool).

    Written component by component, in the kernel's order of operations, so
    that each value carries the same roundings."""
    rays_o, rays_d = rays_o.detach(), rays_d.detach()
    rn, dev = rays_o.shape[0], rays_o.device
    o, d = _components(rays_o, rays_d)
    best_t = torch.full((rn,), MISS_T, dtype=rays_o.dtype, device=dev)
    best_i = torch.zeros((rn,), dtype=torch.int32, device=dev)
    for base in range(0, v0.shape[0], tile):
        sl = slice(base, base + tile)
        t, valid = _mt(*o, *d, v0[sl], e1[sl], e2[sl], tol)
        t = torch.where(valid, t, torch.full_like(t, MISS_T))
        # the first arg-min inside the tile, a strict '<' across tiles
        tmin = torch.min(t, dim=-1).values
        ar = torch.arange(t.shape[-1], device=dev, dtype=torch.int32)
        imin = torch.min(torch.where(t == tmin[:, None], ar,
                                     torch.full_like(ar, t.shape[-1])), dim=-1).values
        better = tmin < best_t
        best_i = torch.where(better, imin + base, best_i)
        best_t = torch.where(better, tmin, best_t)
    return best_t, best_i, best_t < MISS_T * 0.5


class CullIndex(NamedTuple):
    """K3's culling index of a triangle soup (``build_cull_index``)."""
    v0: torch.Tensor    # [n_tiles * tile, 3] f32, tile order (padding: 1e8)
    e1: torch.Tensor    # [n_tiles * tile, 3] (padding: 0)
    e2: torch.Tensor    # [n_tiles * tile, 3] (padding: 0)
    orig: torch.Tensor  # [n_tiles * tile] int32: a slot's original index
    box: torch.Tensor   # [n_tiles, 6] f32: inflated lo (x, y, z), hi (x, y, z)
    tile: int


def _morton3(q: np.ndarray) -> np.ndarray:
    """Interleave 10-bit x/y/z (q: [N,3] uint32 in [0,1024)) -> 30-bit code."""
    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x
    return (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])


def morton_tiles(cent, tri_lo, tri_hi, n_tiles: int, tile: int):
    """Triangles in Morton order of their centroids, cut into tiles of
    ``tile``: ``(order [n] int64, lo [n_tiles, 3], hi [n_tiles, 3])``.

    ``cent``, ``tri_lo`` and ``tri_hi`` ([n, 3], n >= 1) are each triangle's
    centroid and the least and largest of its corners' coordinates.  The
    centroids are quantised to 10 bits an axis over their own bounds; a
    tile's box is the least and largest corner of its triangles, in
    ``tri_lo``'s dtype, and a tile past the last triangle has ``lo = +inf``,
    ``hi = -inf``.  Shared by K3's index and the culled descent's
    (``tracing/intersect.py:build_tile_index``)."""
    n = len(cent)
    c_lo, c_hi = cent.min(0), cent.max(0)
    span = np.where(c_hi > c_lo, c_hi - c_lo, 1.0)
    q = np.clip((cent - c_lo) / span * 1023.0, 0, 1023).astype(np.uint32)
    order = np.argsort(_morton3(q), kind="stable")
    vmin = np.full((n_tiles * tile, 3), np.inf, tri_lo.dtype)
    vmax = np.full((n_tiles * tile, 3), -np.inf, tri_hi.dtype)
    vmin[:n] = tri_lo[order]
    vmax[:n] = tri_hi[order]
    return (order, vmin.reshape(n_tiles, tile, 3).min(1),
            vmax.reshape(n_tiles, tile, 3).max(1))


@torch.no_grad()
def build_cull_index(v0, e1, e2, tile: int = CULL_TILE) -> CullIndex:
    """K3's index of the triangles ``(v0, e1, e2)`` [T, 3] f32, on their
    device: built once per mesh, on the host.

    Rows with ``e1 == 0`` or ``e2 == 0`` (the padding of ``pad_triangles``)
    have ``det == 0`` for every ray and are left out.  The others go into
    tiles of ``tile`` by ``morton_tiles``, from their corners ``v0``,
    ``v0 + e1``, ``v0 + e2`` in float64; each tile's box is widened by
    ``CULL_MARGIN`` of the mesh's size (the larger of its extent and its
    largest coordinate) on every side.  ``v0``/``e1``/``e2`` of the tile order
    are gathered from the given tensors, so every triangle keeps its f32
    bits; the last tile's free slots are never-hit padding."""
    if not 1 <= tile <= MAX_CULL_TILE:
        raise ValueError(f"tile {tile}: 1 to {MAX_CULL_TILE} triangles")
    dev = v0.device
    a0, a1, a2 = (a.detach().cpu().numpy().astype(np.float64) for a in (v0, e1, e2))
    real = np.flatnonzero((a1 != 0).any(1) & (a2 != 0).any(1))
    n = len(real)
    n_tiles = -(-n // tile)
    slots = n_tiles * tile
    order = np.zeros(slots, np.int64)
    box = np.zeros((n_tiles, 6), np.float32)
    if n:
        corners = np.stack([a0[real], a0[real] + a1[real], a0[real] + a2[real]], 1)
        tri_lo, tri_hi = corners.min(1), corners.max(1)
        pos, lo, hi = morton_tiles(corners.mean(1), tri_lo, tri_hi, n_tiles, tile)
        order[:n] = real[pos]
        lo_all, hi_all = tri_lo.min(0), tri_hi.max(0)
        margin = CULL_MARGIN * max(float((hi_all - lo_all).max()),
                                   float(np.abs(corners).max()))
        box[:, :3] = lo - margin
        box[:, 3:] = hi + margin
    idx = torch.as_tensor(order, device=dev)
    pad = torch.arange(slots, device=dev) >= n

    def gather(a, fill):
        out = a.detach()[idx].to(torch.float32).contiguous()
        out[pad] = fill
        return out

    return CullIndex(v0=gather(v0, 1e8), e1=gather(e1, 0.0), e2=gather(e2, 0.0),
                     orig=torch.as_tensor(order.astype(np.int32), device=dev),
                     box=torch.as_tensor(box, device=dev), tile=tile)


@torch.no_grad()
def cull_candidates_reference(rays_o, rays_d, index: CullIndex):
    """Plain version of the kernel's box test: bool [R, n_tiles], the (ray,
    tile) pairs whose slab test against the inflated box passes, in the
    kernel's f32 operations."""
    (ox, oy, oz), (dx, dy, dz) = _components(rays_o.detach(), rays_d.detach())
    box = index.box
    tn = torch.zeros((rays_o.shape[0], box.shape[0]), device=rays_o.device)
    tf = torch.full_like(tn, float("inf"))
    ok = torch.ones_like(tn, dtype=torch.bool)
    for k, (o, d) in enumerate(((ox, dx), (oy, dy), (oz, dz))):
        lo, hi = box[:, k][None, :], box[:, 3 + k][None, :]
        small = torch.abs(d) < SMALL_D
        inv = 1.0 / torch.where(small, torch.ones_like(d), d)
        t0, t1 = (lo - o) * inv, (hi - o) * inv
        tn = torch.where(small, tn, torch.maximum(tn, torch.minimum(t0, t1)))
        tf = torch.where(small, tf, torch.minimum(tf, torch.maximum(t0, t1)))
        ok = ok & (~small | ((lo <= o) & (o <= hi)))
    return ok & (tn <= tf)


@torch.no_grad()
def closest_hit_culled_reference(rays_o, rays_d, index: CullIndex, cand=None,
                                 tol: float = 0.0):
    """The answer built from the culling's candidates alone: each ray's
    closest hit in the mode ``tol`` over the triangles of the tiles
    ``cull_candidates_reference`` passes (or ``cand``), ties to the lowest
    original index.  Equal to ``closest_hit_reference`` when the culling
    drops no winning hit."""
    rays_o, rays_d = rays_o.detach(), rays_d.detach()
    if cand is None:
        cand = cull_candidates_reference(rays_o, rays_d, index)
    rn, dev = rays_o.shape[0], rays_o.device
    o, d = _components(rays_o, rays_d)
    best_t = torch.full((rn,), MISS_T, dtype=torch.float32, device=dev)
    best_i = torch.zeros((rn,), dtype=torch.int32, device=dev)
    step = max(1, TRI_TILE // index.tile) * index.tile
    for base in range(0, index.v0.shape[0], step):
        sl = slice(base, base + step)
        t, valid = _mt(*o, *d, index.v0[sl], index.e1[sl], index.e2[sl], tol)
        tiles = torch.arange(base, base + t.shape[1], device=dev) // index.tile
        valid = valid & cand[:, tiles]
        t = torch.where(valid, t, torch.full_like(t, MISS_T))
        ids = index.orig[sl].expand_as(t)
        key_t = torch.cat([best_t[:, None], t], 1)
        key_i = torch.cat([best_i[:, None], ids], 1)
        tmin = key_t.min(1).values
        big = torch.iinfo(torch.int32).max
        imin = torch.where(key_t == tmin[:, None], key_i, torch.full_like(key_i, big)).min(1).values
        keep = tmin < MISS_T
        best_t = torch.where(keep, tmin, best_t)
        best_i = torch.where(keep, imin, best_i)
    return best_t, best_i, best_t < MISS_T * 0.5


def _lib():
    from nunerf_tpu_torch.ops.cuda_build import load
    lib = load("ray_intersect")
    if not getattr(lib, "_nunerf_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        cf = ctypes.c_float
        lib.nunerf_ray_closest_hit.argtypes = ([vp] * 7 + [ci, ci, vp, vp, ci]
                                               + [vp] * 5 + [ci, cf, cf, vp])
        lib.nunerf_ray_closest_hit.restype = ci
        lib.nunerf_ray_cull_bin.argtypes = [vp] * 3 + [ci] + [vp] * 3 + [ci, vp]
        lib.nunerf_ray_cull_bin.restype = ci
        lib.nunerf_ray_error_string.argtypes = [ci]
        lib.nunerf_ray_error_string.restype = ctypes.c_char_p
        lib._nunerf_typed = True
    return lib


def _validate(rays_o, rays_d, v0, e1, e2):
    if not rays_o.is_cuda:
        raise ValueError("the closest-hit kernel takes CUDA tensors")
    for name, a in (("rays_o", rays_o), ("rays_d", rays_d), ("v0", v0),
                    ("e1", e1), ("e2", e2)):
        if (a.dtype != torch.float32 or a.dim() != 2 or a.shape[1] != 3
                or a.device != rays_o.device):
            raise ValueError(f"{name} must be f32 [N, 3] on {rays_o.device}, got "
                             f"{tuple(a.shape)} {a.dtype} {a.device}")
    if rays_d.shape != rays_o.shape:
        raise ValueError(f"rays_d {tuple(rays_d.shape)} vs rays_o {tuple(rays_o.shape)}")
    if not (v0.shape == e1.shape == e2.shape):
        raise ValueError("v0, e1, e2 must have one shape")
    if max(rays_o.shape[0], v0.shape[0]) >= 2 ** 31 // 3:
        raise ValueError("too many rays or triangles for 32-bit offsets")


def closest_hit_cuda(rays_o, rays_d, index: CullIndex, stats=None, tol: float = 0.0):
    """K3 on CUDA tensors over a ``CullIndex`` (``build_cull_index``) on the
    rays' device, in the mode ``tol``.  ``stats``, an int64 CUDA tensor [2],
    has added to it the (ray, tile) pairs whose box test passed and the ray-triangle pairs swept."""
    _validate(rays_o, rays_d, index.v0, index.e1, index.e2)
    lo, hi = bary_bounds(tol)
    if index.box.device != rays_o.device or index.orig.device != rays_o.device:
        raise ValueError("the index must lie on the rays' device")
    rays_o, rays_d = rays_o.detach().contiguous(), rays_d.detach().contiguous()
    rn, dev = rays_o.shape[0], rays_o.device
    t = torch.empty((rn,), dtype=torch.float32, device=dev)
    idx = torch.empty((rn,), dtype=torch.int32, device=dev)
    hit = torch.empty((rn,), dtype=torch.bool, device=dev)
    if rn == 0:
        return t, idx, hit
    n_tiles = index.box.shape[0]
    cap = max(1, min(rn, LIST_BYTES // (4 * max(n_tiles, 1))))
    count = torch.empty((max(n_tiles, 1),), dtype=torch.int32, device=dev)
    lists = torch.empty((max(n_tiles, 1) * cap,), dtype=torch.int32, device=dev)
    best = torch.empty((rn,), dtype=torch.int64, device=dev)
    if stats is None:
        stats = torch.zeros((2,), dtype=torch.int64, device=dev)
    elif stats.dtype != torch.int64 or stats.shape != (2,) or stats.device != dev:
        raise ValueError("stats must be int64 [2] on the rays' device")
    lib = _lib()
    err = lib.nunerf_ray_closest_hit(
        rays_o.data_ptr(), rays_d.data_ptr(), index.v0.data_ptr(),
        index.e1.data_ptr(), index.e2.data_ptr(), index.orig.data_ptr(),
        index.box.data_ptr(), n_tiles, index.tile, count.data_ptr(),
        lists.data_ptr(), cap, best.data_ptr(), stats.data_ptr(), t.data_ptr(),
        idx.data_ptr(), hit.data_ptr(), rn, lo, hi,
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        msg = lib.nunerf_ray_error_string(err).decode()
        raise RuntimeError(f"closest_hit launch failed: {msg} ({err})")
    launches["closest_hit"] += 1
    return t, idx, hit


def cull_candidates_cuda(rays_o, rays_d, index: CullIndex):
    """The kernel's bin pass alone, all rays in one chunk: bool [R, n_tiles],
    the (ray, tile) pairs in its lists (the card's counterpart of
    ``cull_candidates_reference``)."""
    _validate(rays_o, rays_d, index.v0, index.e1, index.e2)
    rays_o, rays_d = rays_o.detach().contiguous(), rays_d.detach().contiguous()
    rn, n_tiles, dev = rays_o.shape[0], index.box.shape[0], rays_o.device
    cand = torch.zeros((rn, n_tiles), dtype=torch.bool, device=dev)
    if rn == 0 or n_tiles == 0:
        return cand
    count = torch.empty((n_tiles,), dtype=torch.int32, device=dev)
    lists = torch.empty((n_tiles, rn), dtype=torch.int32, device=dev)
    stats = torch.zeros((2,), dtype=torch.int64, device=dev)
    lib = _lib()
    err = lib.nunerf_ray_cull_bin(rays_o.data_ptr(), rays_d.data_ptr(),
                                  index.box.data_ptr(), n_tiles, count.data_ptr(),
                                  lists.data_ptr(), stats.data_ptr(), rn,
                                  torch.cuda.current_stream().cuda_stream)
    if err != 0:
        msg = lib.nunerf_ray_error_string(err).decode()
        raise RuntimeError(f"cull_bin launch failed: {msg} ({err})")
    launches["cull_bin"] += 1
    filled = torch.arange(rn, device=dev)[None, :] < count[:, None].long()
    tiles = torch.arange(n_tiles, device=dev)[:, None].expand(n_tiles, rn)[filled]
    cand[lists[filled].long(), tiles] = True
    return cand


def ray_mesh_closest_hit(rays_o, rays_d, v0, e1, e2, index: CullIndex = None,
                         tol: float = 0.0):
    """Closest hit of each ray in the mode ``tol``: (t [R] f32, tri_idx [R]
    i32, hit [R] bool).

    CUDA tensors go through the kernel over ``index``, the ``CullIndex`` of
    ``v0``, ``e1``, ``e2`` (``build_cull_index``, built once per mesh, as
    ``Scene`` does): without it they raise.  CPU tensors, and only they, go
    through ``closest_hit_reference``, which needs no index."""
    if rays_o.is_cuda:
        _validate(rays_o, rays_d, v0, e1, e2)
        if index is None:
            raise ValueError("the closest-hit kernel runs over the triangles' "
                             "CullIndex: build it once per mesh (build_cull_index)")
        return closest_hit_cuda(rays_o, rays_d, index, tol=tol)
    return closest_hit_reference(rays_o, rays_d, v0, e1, e2, tol=tol)
