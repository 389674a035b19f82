"""Chamfer distance, the geometry evaluation metric; counterpart of
``nunerf_tpu/ops/chamfer.py`` (reference CUDA extension ``chamfer_distance/``,
brute-force nearest neighbours, chamfer_distance.cu:6,158).

A tiled brute-force sweep: the squared distances of every point of one set
to a tile of the other come from one matmul (``|a|^2 - 2 a.b + |b|^2``,
the JAX package's expansion), and each point keeps its running minimum over
the tiles, so memory stays at one ``[A, tile]`` block.  Plain PyTorch: the
JAX function is XLA, not a Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from nunerf_tpu_torch.device import resolve_device


def min_sq_dists(a: torch.Tensor, b: torch.Tensor, tile: int = 4096) -> torch.Tensor:
    """Per-point minimum squared distance from each ``a[i]`` to the set
    ``b``: [A]."""
    aa = torch.sum(a * a, -1, keepdim=True)
    best = torch.full((a.shape[0],), float("inf"), dtype=a.dtype, device=a.device)
    for i0 in range(0, b.shape[0], tile):
        bt = b[i0:i0 + tile]
        d = aa - 2.0 * (a @ bt.T) + torch.sum(bt * bt, -1)[None, :]
        best = torch.minimum(best, torch.min(d, dim=-1).values)
    return torch.clamp(best, min=0.0)


def chamfer_distance(a, b, tile: int = 4096, device="cuda"):
    """Symmetric chamfer: (mean min||a-b||^2, mean min||b-a||^2), as the
    reference module (chamfer_distance.py:56: dist1.mean + dist2.mean).
    ``a``, ``b``: [N,3] arrays or tensors; f32 on ``device``."""
    dev = resolve_device(device)
    a = torch.as_tensor(np.asarray(a, np.float32) if not torch.is_tensor(a) else a,
                        dtype=torch.float32, device=dev)
    b = torch.as_tensor(np.asarray(b, np.float32) if not torch.is_tensor(b) else b,
                        dtype=torch.float32, device=dev)
    return torch.mean(min_sq_dists(a, b, tile)), torch.mean(min_sq_dists(b, a, tile))


def chamfer_distance_np(a: np.ndarray, b: np.ndarray, device="cuda") -> float:
    """Host convenience: scalar chamfer = mean(d1) + mean(d2)."""
    d1, d2 = chamfer_distance(a, b, device=device)
    return float(d1) + float(d2)
