"""Meshes and rays that probe a closest-hit query at its edge cases: an
axis-aligned cube whose faces are grids of triangles, and rays along its
faces, through its edges and vertices, with zero direction components and
from origins on the planes of a culling index's tile boxes.  The CPU tests,
the card tests and ``chip_smoke.py`` hold K3 to its plain version on them."""

from __future__ import annotations

import numpy as np


def box_mesh(n: int = 4, half: float = 0.5):
    """(verts [V, 3] f32, tris [T, 3] i32) of the cube [-half, half]^3, every
    face an n x n grid of squares, two triangles each."""
    g = np.linspace(-half, half, n + 1, dtype=np.float32)
    verts, tris = [], []
    for axis in range(3):
        for side in (-half, half):
            base = len(verts)
            for a in g:
                for b in g:
                    p = [0.0, 0.0, 0.0]
                    p[axis], p[(axis + 1) % 3], p[(axis + 2) % 3] = side, a, b
                    verts.append(p)
            for i in range(n):
                for j in range(n):
                    q = base + i * (n + 1) + j
                    tris += [(q, q + n + 1, q + 1), (q + 1, q + n + 1, q + n + 2)]
    return np.asarray(verts, np.float32), np.asarray(tris, np.int32)


def adversarial_rays(verts: np.ndarray, box: np.ndarray, seed: int = 0):
    """(origins, directions) [R, 3] f32 on ``box_mesh``'s features: through
    its vertices and the midpoints of vertex pairs, from outside and inside,
    along random, axis-aligned and diagonal directions; along its faces, in
    their planes (one direction component 0); from the planes of the tile
    boxes ``box`` [n_tiles, 6] (lo, hi), along and across them; and one ray
    with -0.0 components."""
    rs = np.random.RandomState(seed)
    o, d = [], []
    axes = np.eye(3, dtype=np.float32)
    mids = (verts[:, None] + verts[None]).reshape(-1, 3) / 2
    feats = np.concatenate([verts, mids[rs.choice(len(mids), 200)]])
    for p in feats:
        for dd in (rs.randn(3), axes[rs.randint(3)], axes[rs.randint(3)] + axes[rs.randint(3)]):
            dd = (dd / np.linalg.norm(dd)).astype(np.float32)
            o += [p - 2.0 * dd, p * 0.5]
            d += [dd, dd]
    for axis in range(3):
        for side in (-0.5, 0.5, 0.25):
            for _ in range(20):
                q = rs.rand(3).astype(np.float32) - 0.5
                q[axis] = side
                dd = rs.randn(3).astype(np.float32)
                dd[axis] = 0.0
                dd /= np.linalg.norm(dd)
                o.append(q - 2.0 * dd)
                d.append(dd)
    for b in box[rs.choice(len(box), min(len(box), 20), replace=False)]:
        for k in range(6):
            q = (b[:3] + b[3:]) / 2
            q[k % 3] = b[k]
            for dd in (axes[(k + 1) % 3], -axes[k % 3], axes[k % 3] + axes[(k + 2) % 3]):
                o.append(q.copy())
                d.append((dd / np.linalg.norm(dd)).astype(np.float32))
    o.append(np.array([0.1, 0.1, -2.0], np.float32))
    d.append(np.array([-0.0, -0.0, 1.0], np.float32))
    return np.asarray(o, np.float32), np.asarray(d, np.float32)
