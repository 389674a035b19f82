"""Differentiable mesh scene: the stage-2 tracing substrate; counterpart of
``nunerf_tpu/tracing/scene.py`` (reference ``network/DiffRender.py:318-608``).

Mesh load, per-vertex angle-weighted normals and Gaussian curvature, the
closest-hit query, and the differentiable hit: a closest-hit query without
gradient followed by the differentiable Möller–Trumbore re-intersection with
the hit triangle, interpolating the vertex normal and curvature
(``Dintersect``, DiffRender.py:539-549).

Everything the traced path touches is a fixed-shape tensor on the scene's
device; the host side runs only at construction.  The silhouette and
mesh-regulariser queries (``topology``, ``silhouette_edge``,
``primary_visibility``) go through ``tracing/mesh_reg.py`` and
``tracing/silhouette.py``.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple, Union

import numpy as np
import torch

from nunerf_tpu_torch.device import resolve_device
from nunerf_tpu_torch.ops.geometry import dot, normalize, refract
from nunerf_tpu_torch.ops.ray_intersect import (
    BARY_TOL,
    build_cull_index,
    ray_mesh_closest_hit,
)
from nunerf_tpu_torch.tracing.intersect import (
    MISS_T,
    Hit,
    auto_tile_params,
    build_tile_index,
    diff_intersect,
    pad_triangles,
    ray_mesh_intersect,
    ray_mesh_intersect_culled,
)
from nunerf_tpu_torch.tracing.mesh_ops import (
    load_ply,
    smooth_vertex_scalar,
    vertex_normals_curvature,
)
from nunerf_tpu_torch.tracing.mesh_reg import build_topology
from nunerf_tpu_torch.tracing.silhouette import primary_visibility, silhouette_edges


class Scene:
    """``use_kernel`` sends the closest-hit query to the CUDA kernel
    (``ops/ray_intersect.py``), over a culling index (``kernel_index``) built
    here once: the mesh does not change while a scene traces it.  ``None``
    means on for a CUDA device and off on the CPU; ``True`` on the CPU
    raises.  The kernel runs in its tolerant mode (``kernel_tol``, the
    barycentric tolerance ``BARY_TOL`` of the brute sweep and the culled
    descent, which the JAX package's default ``Scene`` has too), not in the
    exact mode of the Pallas kernel.  With the kernel off the query is the
    brute sweep below ``cull_threshold`` triangles and the tile-culled
    descent from there on."""

    kernel_tol = BARY_TOL

    def __init__(self, mesh: Union[str, Tuple[np.ndarray, np.ndarray]],
                 tile: int = 1024, use_kernel: bool = None,
                 cull_threshold: int = None, curv_smooth_iters: int = 0,
                 device="cuda"):
        self.device = resolve_device(device)
        if use_kernel is None:
            use_kernel = self.device.type == "cuda"
        if use_kernel and self.device.type != "cuda":
            raise ValueError("use_kernel=True needs a CUDA device: the "
                             "closest-hit kernel does not run on the CPU")
        if isinstance(mesh, str):
            verts, tris = load_ply(mesh)
        else:
            verts, tris = mesh
        self.verts_np = np.asarray(verts, np.float32)
        self.tris_np = np.asarray(tris, np.int32)
        normals, curvature = vertex_normals_curvature(self.verts_np, self.tris_np)
        if curv_smooth_iters > 0:
            # marched meshes carry sign noise in the raw angle-defect field
            curvature = smooth_vertex_scalar(curvature, self.tris_np,
                                             curv_smooth_iters)
        self.tile = tile
        self.use_kernel = bool(use_kernel)
        # above this triangle count the closest hit switches from the brute
        # sweep to the tile-culled descent: below it the slab test and the
        # sort of the descent's preamble cost more than they save
        if cull_threshold is None:
            cull_threshold = int(os.environ.get("NUNERF_CULL_TRIS", 32768))
        self.tile_index = None
        self.cull_group = 16
        if not self.use_kernel and len(self.tris_np) >= cull_threshold:
            cull_tile, self.cull_group = auto_tile_params(len(self.tris_np))
            self.tile_index = build_tile_index(
                self.verts_np, self.tris_np, tile=cull_tile,
                group=self.cull_group, device=self.device)

        dev = self.device
        v0, e1, e2 = pad_triangles(self.verts_np, self.tris_np, tile)
        self.v0 = torch.as_tensor(v0, device=dev)
        self.e1 = torch.as_tensor(e1, device=dev)
        self.e2 = torch.as_tensor(e2, device=dev)
        self.verts = torch.as_tensor(self.verts_np, device=dev)
        self.tris = torch.as_tensor(self.tris_np, device=dev).long()
        self.vertex_normals = torch.as_tensor(normals, device=dev)
        self.vertex_curvature = torch.as_tensor(curvature, device=dev)
        # the kernel's index of the same triangles (their f32 bits gathered
        # from v0/e1/e2); the brute v0/e1/e2 stay for the plain versions
        self.kernel_index = (build_cull_index(self.v0, self.e1, self.e2)
                             if self.use_kernel else None)

    # ------------------------------------------------------------------
    def intersect(self, rays_o, rays_d) -> Hit:
        """Closest-hit query, without gradient (the OptiX stand-in)."""
        if self.use_kernel:
            t, idx, hit = ray_mesh_closest_hit(rays_o.detach(), rays_d.detach(),
                                               self.v0, self.e1, self.e2,
                                               index=self.kernel_index,
                                               tol=self.kernel_tol)
            return Hit(t=t, tri_idx=idx, hit=hit)
        if self.tile_index is not None:
            return ray_mesh_intersect_culled(rays_o, rays_d, self.tile_index,
                                             group=self.cull_group)
        return ray_mesh_intersect(rays_o, rays_d, self.v0, self.e1, self.e2,
                                  tile=self.tile)

    def dintersect(self, rays_o, rays_d) -> Dict[str, torch.Tensor]:
        """Differentiable intersection (DiffRender.py:539-549 pattern).

        Returns pos [R,3], normal (interpolated, normalized) [R,3],
        geo_normal [R,3], curvature [R,1], t [R,1], hit [R] bool, tri_idx
        [R].  Missed lanes gather triangle 0 and carry safe dummy values."""
        hit = self.intersect(rays_o, rays_d)
        tri = self.tris[hit.tri_idx.long()]  # [R,3]
        tv0, tv1, tv2 = (self.verts[tri[:, k]] for k in range(3))

        t, u, v, valid = diff_intersect(rays_o, rays_d, tv0, tv1, tv2)
        w = 1.0 - u - v
        n0, n1, n2 = (self.vertex_normals[tri[:, k]] for k in range(3))
        normal = normalize(w * n0 + u * n1 + v * n2)
        c0, c1, c2 = (self.vertex_curvature[tri[:, k]] for k in range(3))
        curvature = (w[..., 0] * c0 + u[..., 0] * c1 + v[..., 0] * c2)[..., None]

        geo_normal = normalize(torch.linalg.cross(tv1 - tv0, tv2 - tv0))
        pos = rays_o + t * rays_d

        ok = hit.hit & valid
        okc = ok[:, None]
        return {
            "pos": torch.where(okc, pos, rays_o),
            "normal": torch.where(okc, normal, torch.zeros_like(normal)),
            "geo_normal": torch.where(okc, geo_normal, torch.zeros_like(geo_normal)),
            "curvature": torch.where(okc, curvature, torch.zeros_like(curvature)),
            "t": torch.where(okc, t, torch.full_like(t, MISS_T)),
            "hit": ok,
            "tri_idx": hit.tri_idx,
        }

    # ------------------------------------------------------------------
    @property
    def topology(self):
        """The watertight edge table (DiffRender.py:362-379) of the
        silhouette and regulariser queries, built at first use."""
        if not hasattr(self, "_topology"):
            self._topology = build_topology(self.tris_np, len(self.verts_np))
        return self._topology

    def refract_ray(self, inter: Dict[str, torch.Tensor], rays_d,
                    ext_ior: float = 1.00029, int_ior: float = 1.5):
        """Snell refraction at a ``dintersect`` result (DiffRender.py:551-583):
        entering or exiting by the normal's side, TIR with swapped IoRs on
        exit.  Returns (new_o, new_d, refracted_mask), fixed shape."""
        n = inter["normal"]
        wo = -rays_d
        cos_i = torch.clamp(dot(wo, n), -1.0, 1.0)
        entering = cos_i > 0  # [R,1]
        n = torch.where(entering, n, -n)
        eta = torch.where(entering,
                          torch.full_like(cos_i, ext_ior / int_ior),
                          torch.full_like(cos_i, int_ior / ext_ior))
        wt, tir = refract(wo, n, eta)
        new_o = inter["pos"] + 1e-5 * wt
        ok = inter["hit"] & ~tir
        return new_o, wt, ok

    def trace2(self, rays_o, rays_d, ext_ior: float = 1.00029,
               int_ior: float = 1.5):
        """Two refraction bounces through the mesh (DiffRender.py:585-594).
        Returns (o, d, ok): the exit rays; lanes that missed or TIR'd at
        either interface carry ok=False and keep the original rays."""
        i1 = self.dintersect(rays_o, rays_d)
        o1, d1, ok1 = self.refract_ray(i1, rays_d, ext_ior, int_ior)
        o1 = torch.where(ok1[:, None], o1, rays_o)
        d1 = torch.where(ok1[:, None], d1, rays_d)
        i2 = self.dintersect(o1, d1)
        o2, d2, ok2 = self.refract_ray(i2, d1, ext_ior, int_ior)
        ok = ok1 & ok2
        return (torch.where(ok[:, None], o2, rays_o),
                torch.where(ok[:, None], d2, rays_d), ok)

    def render_transparent(self, rays_o, rays_d, ext_ior: float = 1.00029,
                           int_ior: float = 1.5):
        """Exit rays of transparent two-bounce transport
        (DiffRender.py:444-457): refract in, refract out, and keep only rays
        that then escape the mesh.  Returns (out_o, out_d, mask)."""
        o2, d2, ok = self.trace2(rays_o, rays_d, ext_ior, int_ior)
        escaped = ~self.intersect(o2, d2).hit
        mask = ok & escaped
        z = torch.zeros_like(rays_o)
        return (torch.where(mask[:, None], o2, z),
                torch.where(mask[:, None], d2, z), mask)

    def render_mask(self, rays_o, rays_d):
        """Binary hit mask (DiffRender.py:458-462)."""
        return self.intersect(rays_o, rays_d).hit.to(torch.float32)

    def _tensor(self, x):
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def silhouette_edge(self, origin):
        """The silhouette-edge mask seen from ``origin`` (DiffRender.py:469-481):
        (edges [E,2], mask [E]), fixed shape, no compaction."""
        topo = self.topology
        return (torch.as_tensor(topo.edges, device=self.device),
                silhouette_edges(self.verts, topo, self._tensor(origin)))

    def primary_visibility(self, pose, K, origin, res_hw, verts=None,
                           detach_depth: bool = False):
        """Edge-sampled differentiable visibility (DiffRender.py:483-526)."""
        return primary_visibility(self, self._tensor(pose), self._tensor(K),
                                  self._tensor(origin), res_hw, verts=verts,
                                  detach_depth=detach_depth)

    # ------------------------------------------------------------------
    def unsigned_distance(self, points: np.ndarray, chunk: int = 4096):
        """Point-to-mesh distance, used by the stage-2 mesh postprocess
        (postprocess_stage2_mesh.py:9-26); a tiled sweep on the device."""
        dev = self.device
        v0, v1, v2 = (torch.as_tensor(self.verts_np[self.tris_np[:, k]], device=dev)
                      for k in range(3))
        out = np.empty(len(points), np.float32)
        for i0 in range(0, len(points), chunk):
            p = torch.as_tensor(np.asarray(points[i0:i0 + chunk], np.float32), device=dev)
            out[i0:i0 + chunk] = _point_triangle_dist(p, v0, v1, v2).cpu().numpy()
        return out


@torch.no_grad()
def _point_triangle_dist(p, v0, v1, v2, tile: int = 1024):
    """min over triangles of the point-triangle distance (clamped barycentric
    projection).  p: [P,3]; v*: [T,3] -> [P]."""
    best = torch.full((p.shape[0],), float("inf"), dtype=p.dtype, device=p.device)
    for base in range(0, v0.shape[0], tile):
        t0, t1, t2 = (a[base:base + tile] for a in (v0, v1, v2))
        e0 = t1 - t0  # [tile,3]
        e1 = t2 - t0
        a = torch.sum(e0 * e0, -1)
        b = torch.sum(e0 * e1, -1)
        c = torch.sum(e1 * e1, -1)
        det = torch.clamp(a * c - b * b, min=1e-20)
        diff = p[:, None, :] - t0[None, :, :]  # [P,tile,3]
        d = torch.sum(diff * e0[None], -1)
        e = torch.sum(diff * e1[None], -1)
        s = torch.clamp((c * d - b * e) / det, 0.0, 1.0)
        t = torch.clamp((a * e - b * d) / det, 0.0, 1.0)
        scale = torch.where(s + t > 1, 1.0 / torch.clamp(s + t, min=1e-12),
                            torch.ones_like(s))
        s, t = s * scale, t * scale
        closest = t0[None] + s[..., None] * e0[None] + t[..., None] * e1[None]
        dist2 = torch.sum((p[:, None, :] - closest) ** 2, -1)
        best = torch.minimum(best, torch.min(dist2, dim=1).values)
    return torch.sqrt(torch.clamp(best, min=0.0))
