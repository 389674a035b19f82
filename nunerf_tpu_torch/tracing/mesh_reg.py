"""Mesh regularisers and mesh topology; counterpart of
``nunerf_tpu/tracing/mesh_reg.py`` (reference ``network/DiffRender.py``: the
watertight edge table, init_edge :362-379; the uniform Laplacian,
init_weightM :381-394; edge-length variance, edge_var :418-427; face-area
variance, area_var :429-442; the dihedral-angle energy; the Laplacian
smoothing hook, laplac_hook :464-467).

The topology is built once on the host (numpy) and is the JAX function's to
the element; the energies are plain torch functions of the vertex tensor,
differentiable by autograd, on the tensor's device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class MeshTopology(NamedTuple):
    edges: np.ndarray          # [E,2] unique undirected edges, sorted
    edge_faces: np.ndarray     # [E,2] the first two faces on each edge (-1 pad)
    neighbors: np.ndarray      # [V,K] vertex one-ring (padded with self)
    neighbor_mask: np.ndarray  # [V,K] valid-neighbour mask
    tris: np.ndarray           # [F,3]


def _rank_in_group(keys: np.ndarray):
    """(order, rank): ``order`` sorts ``keys`` stably, ``rank[i]`` is the
    place of ``order[i]`` among the entries with its key (in their input
    order)."""
    order = np.argsort(keys, kind="stable")
    k = keys[order]
    start = np.r_[0, np.flatnonzero(k[1:] != k[:-1]) + 1]
    first = np.repeat(start, np.diff(np.r_[start, len(k)]))
    return order, np.arange(len(k)) - first


def build_topology(tris: np.ndarray, n_verts: int) -> MeshTopology:
    """Edge table, edge -> face adjacency and one-rings (DiffRender.py:362-394).

    ``edge_faces`` keeps the first two faces met on each edge in the order of
    the half-edges ``[tris01, tris12, tris20]``; a vertex's one-ring lists its
    neighbours in the order of the sorted unique edges: both as the JAX
    function's loops fill them, here by stable sorts."""
    tris = np.asarray(tris, np.int64).reshape(-1, 3)
    n_f = len(tris)
    raw = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]], 0)
    face_ids = np.tile(np.arange(n_f), 3)
    key = np.sort(raw, axis=1)
    if len(key):
        uniq, inverse = np.unique(key, axis=0, return_inverse=True)
    else:
        uniq, inverse = np.zeros((0, 2), np.int64), np.zeros(0, np.int64)
    inverse = np.asarray(inverse).reshape(-1)

    edge_faces = np.full((len(uniq), 2), -1, np.int64)
    order, rank = _rank_in_group(inverse)
    first2 = rank < 2
    edge_faces[inverse[order][first2], rank[first2]] = face_ids[order][first2]

    # one-rings: edge i gives (a_i -> b_i), then (b_i -> a_i)
    src = uniq.reshape(-1)
    dst = uniq[:, ::-1].reshape(-1)
    degree = np.bincount(src, minlength=n_verts)
    k = int(degree.max()) if n_verts else 1
    neighbors = np.tile(np.arange(n_verts)[:, None], (1, k))
    mask = np.zeros((n_verts, k), bool)
    order, rank = _rank_in_group(src)
    neighbors[src[order], rank] = dst[order]
    mask[src[order], rank] = True
    return MeshTopology(edges=uniq.astype(np.int32),
                        edge_faces=edge_faces.astype(np.int32),
                        neighbors=neighbors.astype(np.int32),
                        neighbor_mask=mask,
                        tris=tris.astype(np.int32))


def _index(a: np.ndarray, verts: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, device=verts.device).long()


def edge_length_variance(verts: torch.Tensor, topo: MeshTopology) -> torch.Tensor:
    """Variance of the edge lengths (DiffRender.py:418-427)."""
    e = _index(topo.edges, verts)
    lengths = torch.linalg.norm(verts[e[:, 0]] - verts[e[:, 1]], dim=-1)
    return torch.var(lengths, correction=0)


def face_area_variance(verts: torch.Tensor, topo: MeshTopology) -> torch.Tensor:
    """Variance of the face areas (DiffRender.py:429-442)."""
    t = _index(topo.tris, verts)
    e1 = verts[t[:, 1]] - verts[t[:, 0]]
    e2 = verts[t[:, 2]] - verts[t[:, 0]]
    areas = 0.5 * torch.linalg.norm(torch.linalg.cross(e1, e2), dim=-1)
    return torch.var(areas, correction=0)


def dihedral_angle_energy(verts: torch.Tensor, topo: MeshTopology) -> torch.Tensor:
    """Mean (1 - cos) of the dihedral angles over edges with two faces:
    penalises creases (DiffRender.py dihedral_angle)."""
    t = _index(topo.tris, verts)
    fn = torch.linalg.cross(verts[t[:, 1]] - verts[t[:, 0]],
                            verts[t[:, 2]] - verts[t[:, 0]])
    fn = fn / torch.clamp(torch.linalg.norm(fn, dim=-1, keepdim=True), min=1e-12)
    ef = _index(topo.edge_faces, verts)
    valid = ((ef[:, 0] >= 0) & (ef[:, 1] >= 0)).to(verts.dtype)
    last = len(topo.tris) - 1
    cos = torch.sum(fn[ef[:, 0].clamp(0, last)] * fn[ef[:, 1].clamp(0, last)], dim=-1)
    return torch.sum((1.0 - cos) * valid) / torch.clamp(torch.sum(valid), min=1)


def laplacian_smooth(verts: torch.Tensor, topo: MeshTopology) -> torch.Tensor:
    """Uniform-Laplacian residual per vertex, v - mean(one-ring)
    (DiffRender.py:381-394, 464-467): [V,3]; its norm is the smoothing
    energy."""
    nb = _index(topo.neighbors, verts)
    m = torch.as_tensor(topo.neighbor_mask, device=verts.device).to(verts.dtype)[..., None]
    ring = verts[nb] * m
    mean = torch.sum(ring, dim=1) / torch.clamp(torch.sum(m, dim=1), min=1e-8)
    return verts - mean


def is_watertight(topo: MeshTopology) -> bool:
    return bool(np.all(topo.edge_faces >= 0))
