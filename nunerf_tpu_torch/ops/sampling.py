"""Importance sampling along rays (NeRF/NeuS); counterpart of
``nunerf_tpu/ops/sampling.py``.

Reference semantics: ``sample_pdf`` (field.py:468-498), NeuS ``upsample`` /
``cat_z_vals`` (renderer.py:537-583), and the secondary-ray ``get_weights`` /
``get_intersection`` march (field.py:501-554).  Every lane computes and results
are masked (fixed shapes), as in the JAX package.
"""

from __future__ import annotations

import os

import torch

from nunerf_tpu_torch.ops.geometry import get_sphere_intersection


def _searchsorted_right(cdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Batched ``searchsorted(cdf, u, right=True)``: cdf [..., B], u [..., S]."""
    return torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)


def sample_pdf(bins, weights, n_samples: int, det: bool = False,
               generator: torch.Generator | None = None):
    """Inverse-CDF sampling of ``n_samples`` new z values per ray.

    bins: [..., B] sorted sample positions; weights: [..., B-1]."""
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # [..., B]

    if det:
        u = torch.linspace(0.5 / n_samples, 1.0 - 0.5 / n_samples, n_samples,
                           dtype=cdf.dtype, device=cdf.device)
        u = u.expand(cdf.shape[:-1] + (n_samples,))
    else:
        if generator is None:
            raise ValueError("stochastic sample_pdf needs a generator")
        u = torch.rand(cdf.shape[:-1] + (n_samples,), dtype=cdf.dtype,
                       device=cdf.device, generator=generator)

    inds = _searchsorted_right(cdf, u)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)

    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    nb = bins.shape[-1] - 1
    bins_below = torch.gather(bins, -1, torch.clamp(below, max=nb))
    bins_above = torch.gather(bins, -1, torch.clamp(above, max=nb))

    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


@torch.no_grad()
def neus_upsample(rays_o, rays_d, z_vals, sdf, n_importance: int, inv_s):
    """One NeuS hierarchical up-sampling round with fixed inv_s
    (renderer.py:537-567).  Returns [R, n_importance]."""
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., :, None]
    radius = torch.linalg.norm(pts, dim=-1)
    inside_sphere = (radius[:, :-1] < 1.0) | (radius[:, 1:] < 1.0)
    prev_sdf, next_sdf = sdf[:, :-1], sdf[:, 1:]
    prev_z, next_z = z_vals[:, :-1], z_vals[:, 1:]
    mid_sdf = (prev_sdf + next_sdf) * 0.5
    cos_val = (next_sdf - prev_sdf) / (next_z - prev_z + 1e-5)

    prev_cos = torch.cat([torch.zeros_like(cos_val[:, :1]), cos_val[:, :-1]], dim=-1)
    cos_val = torch.minimum(prev_cos, cos_val)
    cos_val = torch.clamp(cos_val, -1e3, 0.0) * inside_sphere

    dist = next_z - prev_z
    prev_esti = mid_sdf - cos_val * dist * 0.5
    next_esti = mid_sdf + cos_val * dist * 0.5
    prev_cdf = torch.sigmoid(prev_esti * inv_s)
    next_cdf = torch.sigmoid(next_esti * inv_s)
    alpha = (prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5)
    trans = torch.cumprod(
        torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-7], dim=-1),
        dim=-1)[:, :-1]
    weights = alpha * trans
    return sample_pdf(z_vals, weights, n_importance, det=True)


def _merge_rank() -> bool:
    return os.environ.get("NUNERF_MERGE_RANK", "0") not in ("0", "false", "")


def merge_z_vals(z_vals, new_z_vals, sdf, new_sdf=None):
    """Sorted merge of sample positions (renderer.py:569-583).

    Returns (z_vals_sorted, sdf_sorted_or_None).  The default is a stable
    argsort (ties keep ``z_vals`` first, as ``jnp.argsort``);
    NUNERF_MERGE_RANK=1 computes the same order from merged ranks of the
    two sorted lists."""
    z = torch.cat([z_vals, new_z_vals], dim=-1)
    s = None if new_sdf is None else torch.cat([sdf, new_sdf], dim=-1)
    if not _merge_rank():
        order = torch.argsort(z, dim=-1, stable=True)
    else:
        s1, s2 = z_vals.shape[-1], new_z_vals.shape[-1]
        dev = z.device
        r1 = torch.arange(s1, device=dev) + torch.sum(
            new_z_vals[..., None, :] < z_vals[..., :, None], dim=-1)
        r2 = torch.arange(s2, device=dev) + torch.sum(
            z_vals[..., None, :] <= new_z_vals[..., :, None], dim=-1)
        rank = torch.cat([r1, r2], dim=-1)           # [.., S] a permutation
        order = torch.empty_like(rank)
        order.scatter_(-1, rank, torch.arange(s1 + s2, device=dev).expand_as(rank))
    z = torch.gather(z, -1, order)
    if s is None:
        return z, None
    return z, torch.gather(s, -1, order)


def get_weights(sdf_fn, inv_s_fn, z_vals, origins, dirs):
    """NeuS weights along secondary rays (field.py:501-521).

    sdf_fn / inv_s_fn: [N,3] -> [N,1]; z_vals [P,S]; origins/dirs [P,3].
    Returns (weights [P,S-1], mid_sdf [P,S-1])."""
    pts = z_vals[..., None] * dirs[:, None, :] + origins[:, None, :]
    p, s = pts.shape[0], pts.shape[1]
    inv_s = inv_s_fn(pts[:, :-1, :].reshape(-1, 3)).reshape(p, s - 1)
    sdf = sdf_fn(pts.reshape(-1, 3)).reshape(p, s)

    prev_sdf, next_sdf = sdf[:, :-1], sdf[:, 1:]
    prev_z, next_z = z_vals[:, :-1], z_vals[:, 1:]
    mid_sdf = (prev_sdf + next_sdf) * 0.5
    cos_val = (next_sdf - prev_sdf) / (next_z - prev_z + 1e-5)
    surface_mask = cos_val < 0
    cos_val = torch.clamp(cos_val, max=0.0)

    dist = next_z - prev_z
    prev_esti = mid_sdf - cos_val * dist * 0.5
    next_esti = mid_sdf + cos_val * dist * 0.5
    prev_cdf = torch.sigmoid(prev_esti * inv_s)
    next_cdf = torch.sigmoid(next_esti * inv_s)
    alpha = (prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5) * surface_mask
    trans = torch.cumprod(
        torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-7], dim=-1),
        dim=-1)[:, :-1]
    weights = alpha * trans
    mid_sdf = torch.where(surface_mask, mid_sdf, torch.full_like(mid_sdf, -1.0))
    return weights, mid_sdf


@torch.no_grad()
def get_intersection(sdf_fn, inv_s_fn, pts, dirs, sn0: int = 128, sn1: int = 9):
    """Secondary-ray NeuS march -> hit distance distribution
    (field.py:524-554), with no gradient (it is the occlusion loss's target).

    Returns (hit_z_vals [P,sn1-1], hit_weights [P,sn1-1], hit_sdf [P,sn1-1])."""
    inside = torch.linalg.norm(pts, dim=-1) < 0.999
    safe_pts = torch.where(inside[:, None], pts, torch.zeros_like(pts))
    max_dist = get_sphere_intersection(safe_pts, dirs)  # [P,1]

    z_vals = torch.linspace(0.0, 1.0, sn0, dtype=pts.dtype,
                            device=pts.device)[None, :] * max_dist
    weights, mid_sdf = get_weights(sdf_fn, inv_s_fn, z_vals, safe_pts, dirs)
    z_new = sample_pdf(z_vals, weights, sn1, det=True)
    weights, mid_sdf = get_weights(sdf_fn, inv_s_fn, z_new, safe_pts, dirs)
    z_mid = (z_new[:, 1:] + z_new[:, :-1]) * 0.5

    inside_f = inside[:, None]
    hit_z = torch.where(inside_f, z_mid, torch.zeros_like(z_mid))
    hit_w = torch.where(inside_f, weights, torch.zeros_like(weights))
    hit_sdf = torch.where(inside_f, mid_sdf, torch.full_like(mid_sdf, -1.0))
    return hit_z, hit_w, hit_sdf
