"""Ray/sphere geometry primitives used by stage 1; counterpart of the
matching functions of ``nunerf_tpu/ops/geometry.py`` (reference
``network/field.py:447-464``, ``network/renderer.py:337-344``)."""

from __future__ import annotations

import torch


def dot(a, b, keepdims: bool = True):
    return torch.sum(a * b, dim=-1, keepdim=keepdims)


def safe_norm(v, dim=-1, keepdims=False, eps: float = 1e-12):
    """Norm with a finite gradient at v = 0."""
    sq = torch.sum(v * v, dim=dim, keepdim=keepdims)
    return torch.sqrt(torch.clamp(sq, min=eps))


def normalize(v, eps: float = 1e-12):
    return v / safe_norm(v, keepdims=True, eps=eps * eps)


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
