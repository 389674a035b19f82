"""Outer-surface filter of stage-1 meshes; counterpart of
``nunerf_tpu/tools/outer_filter.py``.

On hollow-glass scenes the stage-1 SDF also puts a zero level on the inner
object, so the marched mesh carries interior junk; stage 2 needs the outer
surface alone (reference network/renderer.py:992-998).  ``filter_outer``
recovers it geometrically: (1) drop the face-connected components under
``min_area_frac`` of the total area; (2) keep the faces whose centroid is
the first hit from at least one of ``n_views`` outside viewpoints (a
Fibonacci sphere of ``radius``), through ``Scene.dintersect``: K3 and the
differentiable re-intersection on the card; (3) drop what is left under
``min_area_frac_final`` of the largest component.  A face is kept only
where the hit's triangle is the face itself, so the closest hit's
tie-break (the lowest index) decides ties.

``convex_hull_mesh`` and ``density_filtered_hull`` (the bootstrap silhouette
prior) run on scipy.
"""

from __future__ import annotations

import numpy as np
import torch

from nunerf_tpu_torch.tracing.scene import Scene


def face_components(tris: np.ndarray) -> np.ndarray:
    """Connected-component label per face (faces sharing an edge are
    connected).  The labels number the components from 0; the partition is
    the JAX function's (its labels are union-find roots)."""
    import scipy.sparse as sp
    import scipy.sparse.csgraph as csg

    n = len(tris)
    if n == 0:
        return np.zeros(0, np.int64)
    edges = np.sort(np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]],
                                    tris[:, [2, 0]]], axis=0), axis=1)
    face_ids = np.tile(np.arange(n), 3)
    key = edges[:, 0].astype(np.int64) * (tris.max() + 1) + edges[:, 1]
    order = np.argsort(key, kind="stable")
    key_s, face_s = key[order], face_ids[order]
    same = key_s[1:] == key_s[:-1]
    a, b = face_s[:-1][same], face_s[1:][same]
    graph = sp.coo_matrix((np.ones(len(a), np.int8), (a, b)), shape=(n, n))
    return csg.connected_components(graph, directed=False)[1]


def _face_areas(verts, tris):
    p = verts[tris]
    return 0.5 * np.linalg.norm(np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]), axis=-1)


def _fibonacci_sphere(n):
    i = np.arange(n) + 0.5
    phi = np.arccos(1 - 2 * i / n)
    theta = np.pi * (1 + 5 ** 0.5) * i
    return np.stack([np.cos(theta) * np.sin(phi),
                     np.sin(theta) * np.sin(phi),
                     np.cos(phi)], -1)


def _component_areas(labels, areas):
    """{label: area}: each component's faces summed as the JAX function sums
    them (numpy's sum of the masked areas)."""
    return {lab: areas[labels == lab].sum() for lab in np.unique(labels)}


def drop_small_components(verts, tris, min_area_frac):
    labels = face_components(tris)
    areas = _face_areas(verts, tris)
    total = areas.sum()
    keep = np.zeros(len(tris), bool)
    for lab, area in _component_areas(labels, areas).items():
        if area >= min_area_frac * total:
            keep[labels == lab] = True
    return keep


def visible_faces(verts, tris, n_views=64, radius=2.0, chunk=65536, device="cuda",
                  scene=None):
    """Boolean per-face mask: the centroid is the first hit from at least one
    outside viewpoint.  ``scene``, a ``Scene`` of ``(verts, tris)``, is built
    on ``device`` when not given."""
    scene = Scene((verts, tris), device=device) if scene is None else scene
    centers = verts[tris].mean(1).astype(np.float32)
    nf = len(centers)
    views = (_fibonacci_sphere(n_views) * radius).astype(np.float32)
    keep = torch.zeros(nf, dtype=torch.bool, device=scene.device)
    ids = torch.arange(nf, device=scene.device)
    for v in views:
        d = centers - v[None, :]
        d /= np.linalg.norm(d, axis=-1, keepdims=True) + 1e-12
        o = np.broadcast_to(v[None, :], d.shape).astype(np.float32)
        o_t = torch.as_tensor(o, device=scene.device)
        d_t = torch.as_tensor(d, device=scene.device)
        for i0 in range(0, nf, chunk):
            sl = slice(i0, min(i0 + chunk, nf))
            with torch.no_grad():
                res = scene.dintersect(o_t[sl], d_t[sl])
            keep[sl] |= res["hit"] & (res["tri_idx"].long() == ids[sl])
    return keep.cpu().numpy()


def filter_outer(verts, tris, n_views=64, radius=2.0, min_area_frac=0.01,
                 min_area_frac_final=0.05, device="cuda"):
    """Returns the filtered (verts, tris) and a stats dict."""
    keep0 = drop_small_components(verts, tris, min_area_frac)
    t1 = tris[keep0]
    keep1 = visible_faces(verts, t1, n_views=n_views, radius=radius, device=device)
    t2 = t1[keep1]
    labels = face_components(t2)
    sizes = _component_areas(labels, _face_areas(verts, t2))
    best = max(sizes.values(), default=0.0)
    keep2 = np.array([sizes[lab] >= min_area_frac_final * best for lab in labels], bool)
    t3 = t2[keep2]
    used = np.unique(t3)
    remap = np.full(len(verts), -1, np.int64)
    remap[used] = np.arange(len(used))
    stats = {"faces_in": int(len(tris)), "after_floaters": int(len(t1)),
             "after_visibility": int(len(t2)), "faces_out": int(len(t3)),
             "verts_out": int(len(used))}
    return verts[used], remap[t3], stats


def taubin_smooth(verts, tris, iters=20, lam=0.5, mu=-0.53):
    """Taubin lambda/mu smoothing (keeps the volume, unlike plain Laplacian):
    the glass surface is smooth, and marching noise feeds the shell's
    angle-defect curvature."""
    v = verts.astype(np.float64).copy()
    n = len(v)
    e = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]],
                        tris[:, [1, 0]], tris[:, [2, 1]], tris[:, [0, 2]]], 0)
    order = np.argsort(e[:, 0], kind="stable")
    src, dst = e[order, 0], e[order, 1]
    deg = np.maximum(np.bincount(src, minlength=n)[:, None].astype(np.float64), 1.0)

    def lap(x):
        s = np.zeros_like(x)
        np.add.at(s, src, x[dst])
        return s / deg - x

    for _ in range(iters):
        v = v + lam * lap(v)
        v = v + mu * lap(v)
    return v.astype(np.float32)


def convex_hull_mesh(verts):
    """The convex hull of a vertex set as a (verts, tris) mesh, faces wound
    outward: the bootstrap mask prior (a first stage-1 pass on a transparent
    container reconstructs fragments that span the object; glass containers
    are near convex)."""
    from scipy.spatial import ConvexHull

    hull = ConvexHull(np.asarray(verts, np.float64))
    v = np.asarray(verts, np.float32)[hull.vertices]
    remap = np.full(len(verts), -1, np.int64)
    remap[hull.vertices] = np.arange(len(hull.vertices))
    tris = remap[hull.simplices].astype(np.int32)
    # qhull's simplices are unordered: flip each face whose normal points
    # toward the hull's centroid
    c = v.mean(0)
    n = np.cross(v[tris[:, 1]] - v[tris[:, 0]], v[tris[:, 2]] - v[tris[:, 0]])
    inward = np.sum(n * (v[tris].mean(1) - c), -1) < 0
    tris[inward] = tris[inward][:, ::-1]
    return v, tris


def density_filtered_hull(points, k: int = 5, thresh: float = 2.0):
    """The convex hull of the points whose k-th-neighbour distance is under
    ``thresh`` x the median: COLMAP object clouds carry sparse outlier halos
    that a raw hull would cover."""
    from scipy.spatial import cKDTree

    pts = np.asarray(points, np.float32)
    dk = cKDTree(pts).query(pts, k=k + 1)[0][:, k]
    return convex_hull_mesh(pts[dk < thresh * np.median(dk)])
