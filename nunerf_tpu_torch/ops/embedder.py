"""NeRF positional (frequency) encoding; counterpart of
``nunerf_tpu/ops/embedder.py``.

``[x, sin(2^0 x), cos(2^0 x), sin(2^1 x), cos(2^1 x), ...]`` on the last axis
(reference ``network/field.py:14-61``).
"""

from __future__ import annotations

import torch


def posenc_dim(multires: int, d: int = 3) -> int:
    """Output dimension of :func:`posenc`."""
    return d + 2 * multires * d


def posenc(x: torch.Tensor, multires: int) -> torch.Tensor:
    """Frequency-encode ``x`` [..., d] -> [..., d*(1+2*multires)]."""
    if multires <= 0:
        return x
    freqs = 2.0 ** torch.arange(multires, dtype=x.dtype, device=x.device)
    xb = x[..., None, :] * freqs[:, None]                # [..., m, d]
    enc = torch.stack([torch.sin(xb), torch.cos(xb)], dim=-2)
    enc = enc.reshape(*x.shape[:-1], 2 * multires * x.shape[-1])
    return torch.cat([x, enc], dim=-1)
