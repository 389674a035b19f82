"""Ray / triangle-soup closest hit: CUDA kernel K3 with its plain PyTorch
version.

Counterpart of ``nunerf_tpu/ops/pallas_intersect.py``.  Both versions compute,
for every ray, the closest Möller–Trumbore hit over triangles given as
``v0``, ``e1 = v1 - v0``, ``e2 = v2 - v0``:

* det eps 1e-9, ``inv_det = 0`` where ``|det| <= eps``; a hit needs
  ``u >= 0``, ``v >= 0``, ``u + v <= 1`` and ``t > 1e-5``, else ``t = MISS_T``.
  There is **no barycentric tolerance** (the brute sweep of
  ``tracing/intersect.py`` allows -1e-6): a ray through a shared edge can
  hit there and miss here;
* ties on ``t`` go to the lowest triangle index; an all-miss ray keeps
  index 0; ``hit = t < MISS_T / 2``;
* no gradient: the inputs are detached, the differentiable hit comes from
  ``tracing.intersect.diff_intersect``.

``closest_hit_reference`` is the plain version (a loop over triangle tiles,
the same comparisons, one rounding an operation).  ``ray_mesh_closest_hit``
is the entry point: on CUDA tensors it launches the kernel
(``csrc/ray_intersect.cu``), on CPU tensors, and only there, it runs the
plain version.  The kernel multiplies and adds without FMA contraction, so on
the card ``t``, the index and ``hit`` equal the plain version's exactly.

``launches["closest_hit"]`` adds one per kernel launch.
"""

from __future__ import annotations

import ctypes

import torch

MISS_T = 1e7
TRI_TILE = 256      # triangles per tile of the plain version's loop
OPS_PER_PAIR = 46   # f32 multiplies, adds, subtracts and the divide of a pair

launches = {"closest_hit": 0}


def reset_launches():
    for k in launches:
        launches[k] = 0


@torch.no_grad()
def closest_hit_reference(rays_o, rays_d, v0, e1, e2, tile: int = TRI_TILE):
    """Plain PyTorch version of K3: (t [R] f32, tri_idx [R] i32, hit [R] bool).

    Written component by component, in the kernel's order of operations, so
    that each value carries the same roundings."""
    rays_o, rays_d = rays_o.detach(), rays_d.detach()
    rn, dev = rays_o.shape[0], rays_o.device
    ox, oy, oz = (rays_o[:, i:i + 1] for i in range(3))
    dx, dy, dz = (rays_d[:, i:i + 1] for i in range(3))
    best_t = torch.full((rn,), MISS_T, dtype=rays_o.dtype, device=dev)
    best_i = torch.zeros((rn,), dtype=torch.int32, device=dev)
    for base in range(0, v0.shape[0], tile):
        sl = slice(base, base + tile)
        v0x, v0y, v0z = (v0[sl, i][None, :] for i in range(3))
        e1x, e1y, e1z = (e1[sl, i][None, :] for i in range(3))
        e2x, e2y, e2z = (e2[sl, i][None, :] for i in range(3))
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
        valid = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 1e-5)
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


def _lib():
    from nunerf_tpu_torch.ops.cuda_build import load
    lib = load("ray_intersect")
    if not getattr(lib, "_nunerf_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.nunerf_ray_closest_hit.argtypes = [vp] * 9 + [ci, ci, vp]
        lib.nunerf_ray_closest_hit.restype = ci
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


def closest_hit_cuda(rays_o, rays_d, v0, e1, e2):
    """K3 on CUDA tensors (padding rows of ``pad_triangles`` can never be
    hit and are swept like any other)."""
    _validate(rays_o, rays_d, v0, e1, e2)
    rays_o, rays_d = rays_o.detach().contiguous(), rays_d.detach().contiguous()
    v0, e1, e2 = v0.contiguous(), e1.contiguous(), e2.contiguous()
    rn, dev = rays_o.shape[0], rays_o.device
    t = torch.empty((rn,), dtype=torch.float32, device=dev)
    idx = torch.empty((rn,), dtype=torch.int32, device=dev)
    hit = torch.empty((rn,), dtype=torch.bool, device=dev)
    if rn == 0:
        return t, idx, hit
    scratch = torch.empty((rn,), dtype=torch.int64, device=dev)
    lib = _lib()
    err = lib.nunerf_ray_closest_hit(
        rays_o.data_ptr(), rays_d.data_ptr(), v0.data_ptr(), e1.data_ptr(),
        e2.data_ptr(), scratch.data_ptr(), t.data_ptr(), idx.data_ptr(),
        hit.data_ptr(), rn, v0.shape[0], torch.cuda.current_stream().cuda_stream)
    if err != 0:
        msg = lib.nunerf_ray_error_string(err).decode()
        raise RuntimeError(f"closest_hit launch failed: {msg} ({err})")
    launches["closest_hit"] += 1
    return t, idx, hit


def ray_mesh_closest_hit(rays_o, rays_d, v0, e1, e2):
    """Closest hit of each ray: (t [R] f32, tri_idx [R] i32, hit [R] bool).

    CUDA tensors go through the kernel; CPU tensors through
    ``closest_hit_reference``."""
    if rays_o.is_cuda:
        return closest_hit_cuda(rays_o, rays_d, v0, e1, e2)
    return closest_hit_reference(rays_o, rays_d, v0, e1, e2)
