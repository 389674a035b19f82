"""SDF sphere tracing; counterpart of ``nunerf_tpu/ops/sphere_tracing.py``
(reference ``network/tracing.py:96-216``): sphere tracing from the bounding
sphere's entry with per-lane convergence masks, and surface normals by
autograd or central differences.

The JAX ``lax.while_loop`` is a Python loop over the same masks: it stops
where the JAX condition stops (``it < max_iters`` and a lane not done), so
``iterations`` is the same count.  With ``ShapeRenderer.sdf`` as ``sdf_fn``
each march step is one K1 launch on the card.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from nunerf_tpu_torch.ops.geometry import normalize, ray_sphere_hit


class SphereTraceResult(NamedTuple):
    points: torch.Tensor  # [R,3] final positions
    depth: torch.Tensor   # [R,1] distance along the ray
    hit: torch.Tensor     # [R] converged mask
    iterations: int       # march steps taken


@torch.no_grad()
def sphere_trace(sdf_fn: Callable, rays_o, rays_d, max_iters: int = 200,
                 threshold: float = 1e-5, bound_radius: float = 1.0,
                 step_scale: float = 1.0) -> SphereTraceResult:
    """March each ray by the SDF value until |sdf| < threshold.

    Rays that miss the bounding sphere or leave it during the march are
    misses (reference tracing.py:96-164)."""
    rays_d = normalize(rays_d)
    t_near, t_far, sphere_hit = ray_sphere_hit(rays_o, rays_d, bound_radius)
    t = torch.clamp(t_near, min=0.0)[:, None]
    t_far = t_far[:, None]
    done = ~sphere_hit
    it = 0
    while it < max_iters and bool(torch.any(~done)):
        d = sdf_fn(rays_o + t * rays_d).to(t.dtype)
        converged = torch.abs(d[..., 0]) < threshold
        escaped = t[..., 0] > t_far[..., 0]
        newly_done = converged | escaped | ~sphere_hit
        t = torch.where((done | newly_done)[:, None], t, t + d * step_scale)
        done = done | newly_done
        it += 1

    pts = rays_o + t * rays_d
    final_sdf = sdf_fn(pts)
    hit = sphere_hit & (torch.abs(final_sdf[..., 0]) < threshold * 10)
    return SphereTraceResult(points=pts, depth=t, hit=hit, iterations=it)


def sdf_normals(sdf_fn: Callable, points, eps: float = 0.0):
    """Surface normals: autograd of the summed first output column (eps=0;
    each point's value depends on that point alone) or central differences
    (the reference's, tracing.py:189-216)."""
    if eps <= 0:
        with torch.enable_grad():
            p = points.detach().requires_grad_(True)
            g, = torch.autograd.grad(sdf_fn(p)[..., 0].sum(), p)
        return normalize(g)
    grads = []
    for i in range(3):
        off = torch.zeros(3, dtype=points.dtype, device=points.device)
        off[i] = eps
        grads.append((sdf_fn(points + off) - sdf_fn(points - off))[..., 0] / (2 * eps))
    return normalize(torch.stack(grads, dim=-1))
