"""Silhouette-edge visibility sampling; counterpart of
``nunerf_tpu/tracing/silhouette.py`` (reference ``network/DiffRender.py``):

* ``silhouette_edges``     — DiffRender.py:469-481
* ``edge_sample_coverage`` — the ``primary_edge_sample`` autograd.Function
                             (:193-285) as a ``torch.autograd.Function``
* ``primary_visibility``   — :483-526

Everything is fixed-shape with validity masks, as in the JAX package: the
reference's boolean compactions become carried masks.  Gradients of the
pixel coverage reach the vertices through the differentiable projection of
the edge endpoints; the coverage's backward is the edge-sampling estimate
(hit(above) - hit(below)) x the 2D edge normal.  The two closest-hit queries
go through ``scene.intersect``: K3 on the card.
"""

from __future__ import annotations

from typing import Dict

import torch

from nunerf_tpu_torch.tracing.mesh_reg import MeshTopology


def silhouette_edges(verts, topo: MeshTopology, origin) -> torch.Tensor:
    """Mask [E] of the edges whose two faces face opposite sides of
    ``origin`` (DiffRender.py:469-481); no gradient (detached in the
    reference)."""
    verts = verts.detach()
    dev = verts.device
    tris = torch.as_tensor(topo.tris, device=dev).long()
    ef = torch.as_tensor(topo.edge_faces, device=dev).long()  # [E,2], -1 pad
    v0, v1, v2 = (verts[tris[:, k]] for k in range(3))
    fn = torch.linalg.cross(v1 - v0, v2 - v0)  # unnormalised: the sign is enough
    origin = origin.to(verts)

    def facing(f):
        return torch.sum(fn[f] * (origin[None, :] - v0[f]), dim=-1) > 0

    has2 = ef[:, 1] >= 0
    return has2 & (facing(ef[:, 0].clamp(min=0)) ^ facing(ef[:, 1].clamp(min=0)))


class EdgeSampleCoverage(torch.autograd.Function):
    """Coverage sample at each edge's midpoint pixel: 0.5 forward
    (primary_edge_sample:271); the backward sends the cotangent ``g`` to
    both projected endpoints as ``g * f * (-N)``, ``N = (ay - by, bx - ax)``
    the 2D normal of the edge (:210-212, 251-257, 282-285).  ``f`` is data:
    no gradient."""

    @staticmethod
    def forward(ctx, e_pos, f):
        ctx.save_for_backward(e_pos, f)
        return 0.5 * torch.ones(e_pos.shape[0], dtype=e_pos.dtype, device=e_pos.device)

    @staticmethod
    def backward(ctx, g):
        e_pos, f = ctx.saved_tensors
        ax, ay = e_pos[:, 0, 0], e_pos[:, 0, 1]
        bx, by = e_pos[:, 1, 0], e_pos[:, 1, 1]
        nx, ny = ay - by, bx - ax
        d_end = torch.stack([-nx, -ny], dim=-1) * (g * f)[:, None]
        return torch.stack([d_end, d_end], dim=1), None


def edge_sample_coverage(e_pos, f):
    """e_pos [E,2,2] projected edge endpoints (pixels); f [E] hit(above) -
    hit(below) along the 2D edge normal.  Returns [E] (0.5 each)."""
    return EdgeSampleCoverage.apply(e_pos, f)


def primary_visibility(scene, pose, K, origin, res_hw, verts=None,
                       detach_depth: bool = False) -> Dict[str, torch.Tensor]:
    """Edge-sampled differentiable primary visibility (DiffRender.py:483-526).

    scene: ``tracing.scene.Scene`` (the closest hit); pose: world->cam [3,4]
    (the NeRO convention of the ray store); K [3,3]; origin: the camera
    position [3]; res_hw: (h, w).  ``verts`` replaces the scene's vertices so
    that a caller can differentiate with respect to its own copy.

    Returns {index [E,2] int32 pixel coordinates, value [E], valid [E]}; the
    gradient of ``value`` reaches ``verts`` through the projected
    endpoints."""
    h, w = res_hw
    verts = scene.verts if verts is None else verts
    topo = scene.topology
    silh = silhouette_edges(verts, topo, origin)

    edges = torch.as_tensor(topo.edges, device=verts.device).long()
    va, vb = verts[edges[:, 0]], verts[edges[:, 1]]
    R, t = pose[:, :3], pose[:, 3]

    def project(v):
        cam = v @ R.T + t  # +z forward (OpenCV)
        z = torch.clamp(cam[:, 2:3], min=1e-6)
        if detach_depth:
            z = z.detach()
        uv = cam[:, :2] / z
        return torch.stack([uv[:, 0] * K[0, 0] + K[0, 2],
                            uv[:, 1] * K[1, 1] + K[1, 2]], dim=-1)

    e_pos = torch.stack([project(va), project(vb)], dim=1)  # [E,2,2]

    # sample the midpoints offset by +-1 px along the 2D normal (:205-218)
    mid = 0.5 * (e_pos[:, 0] + e_pos[:, 1])
    n2 = torch.stack([e_pos[:, 0, 1] - e_pos[:, 1, 1],
                      e_pos[:, 1, 0] - e_pos[:, 0, 0]], dim=-1)
    n2 = n2 / torch.clamp(torch.linalg.norm(n2, dim=-1, keepdim=True), min=1e-8)
    pu = (mid + n2).detach()
    pl = (mid - n2).detach()

    def pixel_rays(p):
        d_cam = torch.stack([(p[:, 0] - K[0, 2]) / K[0, 0],
                             (p[:, 1] - K[1, 2]) / K[1, 1],
                             torch.ones_like(p[:, 0])], dim=-1)
        d = d_cam @ R  # R^T applied to each row: world
        d = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-8)
        return origin[None, :].expand_as(d).contiguous(), d

    hit_u = scene.intersect(*pixel_rays(pu)).hit
    hit_l = scene.intersect(*pixel_rays(pl)).hit
    f = (hit_u.to(torch.float32) - hit_l.to(torch.float32)).detach()

    value = edge_sample_coverage(e_pos, torch.where(silh, f, torch.zeros_like(f)))
    index = mid.detach().to(torch.int32)
    in_view = ((index[:, 0] >= 0) & (index[:, 0] < w - 1)
               & (index[:, 1] >= 0) & (index[:, 1] < h - 1))
    return {"index": index, "value": value,
            "valid": silh & in_view & (torch.abs(f) > 1e-5)}
