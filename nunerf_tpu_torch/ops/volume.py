"""Volume rendering composition; counterpart of ``nunerf_tpu/ops/volume.py``.

``weights = alpha * cumprod(cat([1, 1-alpha+1e-7]))[:-1]`` (renderer.py:790-792).
"""

from __future__ import annotations

import torch


def exclusive_cumprod(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """cumprod shifted right by one, with leading 1 (transmittance)."""
    ones_shape = list(x.shape)
    ones_shape[dim] = 1
    ones = torch.ones(ones_shape, dtype=x.dtype, device=x.device)
    full = torch.cumprod(torch.cat([ones, x], dim=dim), dim=dim)
    return full.narrow(dim, 0, x.shape[dim])


def alpha_to_weights(alpha: torch.Tensor) -> torch.Tensor:
    """NeuS/NeRF compositing weights from per-sample alphas [..., S]."""
    return alpha * exclusive_cumprod(1.0 - alpha + 1e-7)


def composite(weights: torch.Tensor, values: torch.Tensor, dim: int = -2) -> torch.Tensor:
    """Weighted sum of per-sample values [..., S, C] -> [..., C]."""
    return torch.sum(weights[..., None] * values, dim=dim)
