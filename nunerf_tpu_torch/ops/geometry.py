"""Ray/sphere/refraction geometry primitives; counterpart of
``nunerf_tpu/ops/geometry.py`` (reference ``network/field.py:447-464``,
``network/DiffRender.py:28-58``, ``network/renderer.py:337-344``).

Total internal reflection is reported as a mask, never branched on."""

from __future__ import annotations

import torch


def dot(a, b, keepdims: bool = True):
    return torch.sum(a * b, dim=-1, keepdim=keepdims)


def safe_norm(v, dim=-1, keepdims=False, eps: float = 1e-12):
    """Norm with a finite gradient at v = 0."""
    sq = torch.sum(v * v, dim=dim, keepdim=keepdims)
    return torch.sqrt(torch.clamp(sq, min=eps))


def safe_sqrt(x, eps: float = 1e-12):
    """Square root with a finite gradient at x = 0."""
    return torch.sqrt(torch.clamp(x, min=eps))


def normalize(v, eps: float = 1e-12):
    return v / safe_norm(v, keepdims=True, eps=eps * eps)


def reflect(wo, n):
    """Mirror direction of ``wo`` about normal ``n`` (DiffRender.py:28-30)."""
    return -wo + 2.0 * dot(wo, n) * n


def refract(wi, n, eta):
    """Snell refraction of incident dir ``wi`` (pointing *away* from the
    surface) across normal ``n`` with relative IoR ``eta = n_i / n_t``
    (DiffRender.py:32-46).

    Returns ``(wt, tir_mask)``: the transmitted direction (zeros where TIR)
    and a boolean mask of total internal reflection."""
    cos_i = dot(wi, n)  # [...,1]
    sin2_i = torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    sin2_t = eta * eta * sin2_i
    tir = sin2_t[..., 0] >= 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    wt = eta * -wi + (eta * cos_i - cos_t) * n
    wt = torch.where(tir[..., None], torch.zeros_like(wt), wt)
    return wt, tir


def fresnel_dielectric(cos_i, eta_i, eta_t):
    """Unpolarized Fresnel reflectance of a dielectric interface
    (DiffRender.py:48-58).  ``cos_i`` >= 0 assumed; 1.0 under TIR."""
    cos_i = torch.clamp(cos_i, 0.0, 1.0)
    sin_t = eta_i / eta_t * torch.sqrt(torch.clamp(1.0 - cos_i * cos_i, min=0.0))
    tir = sin_t >= 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin_t * sin_t, min=0.0))
    r_parl = ((eta_t * cos_i - eta_i * cos_t)
              / torch.clamp(eta_t * cos_i + eta_i * cos_t, min=1e-10))
    r_perp = ((eta_i * cos_i - eta_t * cos_t)
              / torch.clamp(eta_i * cos_i + eta_t * cos_t, min=1e-10))
    fr = 0.5 * (r_parl * r_parl + r_perp * r_perp)
    return torch.where(tir, torch.ones_like(fr), fr)


def schlick_weight(no_v):
    """Schlick approximation ``0.04 + 0.96 (1-NoV)^5`` (field.py:708-712)."""
    t = torch.clamp(1.0 - no_v, 0.0, 1.0)
    return torch.clamp(0.04 + (1.0 - 0.04) * t * t * t * t * t, 0.0, 1.0)


def get_sphere_intersection(pts, dirs):
    """Distance along ``dirs`` from ``pts`` (inside the unit sphere) to the
    unit sphere (field.py:458-464).  Shape [..., 1]."""
    dtx = dot(pts, dirs)
    xtx = dot(pts, pts)
    disc = dtx * dtx - xtx + 1.0
    return -dtx + torch.sqrt(torch.clamp(disc, min=0.0) + 1e-6)


def offset_points_to_sphere(points, radius: float = 0.999):
    """Clamp points to lie strictly inside the unit sphere (field.py:447-455)."""
    norm = torch.linalg.norm(points, dim=-1, keepdim=True)
    scaled = points / torch.clamp(norm, min=1e-12) * radius
    return torch.where(norm > radius, scaled, points)


def near_far_from_sphere(rays_o, rays_d):
    """NeuS near/far around the closest approach to the origin
    (renderer.py:337-344)."""
    a = dot(rays_d, rays_d)
    b = 2.0 * dot(rays_o, rays_d)
    mid = 0.5 * (-b) / a
    near = torch.clamp(mid - 1.0, min=1e-3)
    far = mid + 1.0
    return near, far


def ray_sphere_hit(rays_o, rays_d, radius: float = 1.0):
    """Both intersection distances with a ``radius`` sphere at the origin.

    Returns (t_near, t_far, hit_mask); the t's are zero where no hit."""
    b = dot(rays_o, rays_d)[..., 0]
    c = dot(rays_o, rays_o)[..., 0] - radius * radius
    disc = b * b - c
    hit = disc > 0
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    zero = torch.zeros_like(b)
    return torch.where(hit, -b - sq, zero), torch.where(hit, -b + sq, zero), hit
