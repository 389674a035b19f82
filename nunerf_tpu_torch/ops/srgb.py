"""Piecewise sRGB <-> linear conversions (reference ``utils/raw_utils.py:5-35``);
counterpart of ``nunerf_tpu/ops/srgb.py``."""

from __future__ import annotations

import numpy as np
import torch

_EPS = float(np.finfo(np.float32).eps)


def linear_to_srgb(linear):
    srgb0 = 323.0 / 25.0 * linear
    srgb1 = (211.0 * torch.clamp(linear, min=_EPS) ** (5.0 / 12.0) - 11.0) / 200.0
    return torch.where(linear <= 0.0031308, srgb0, srgb1)


def srgb_to_linear(srgb):
    linear0 = 25.0 / 323.0 * srgb
    linear1 = torch.clamp((200.0 * srgb + 11.0) / 211.0, min=_EPS) ** (12.0 / 5.0)
    return torch.where(srgb <= 0.04045, linear0, linear1)
