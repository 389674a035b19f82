"""Small auxiliary field MLPs; counterpart of ``nunerf_tpu/fields/aux.py``
(reference ``network/field.py:1020-1118``).  The IoR/Thickness stacks have no
ReLU between their 3rd and 4th linear layers, as in the reference."""

from __future__ import annotations

import torch
from torch import nn

from nunerf_tpu_torch.fields.mlp import WNMLPStack
from nunerf_tpu_torch.ops.embedder import posenc, posenc_dim


class InfOutNetwork(nn.Module):
    """Direction -> RGB environment MLP (posenc deg 10, 4x256, ReLU out)."""

    def __init__(self, device=None):
        super().__init__()
        self.module0 = WNMLPStack(posenc_dim(10), (256, 256, 256, 256, 3),
                                  (True, True, True, True, False), "relu",
                                  device=device)

    def reset_parameters(self, generator):
        self.module0.reset_parameters(generator)

    def forward(self, dirs):
        return self.module0(posenc(dirs, 10))


class _SurfaceScalar(nn.Module):
    def __init__(self, device=None):
        super().__init__()
        self.module0 = WNMLPStack(posenc_dim(6), (256, 256, 256, 1),
                                  (True, True, False, False), "sigmoid",
                                  device=device)

    def reset_parameters(self, generator):
        self.module0.reset_parameters(generator)

    def forward(self, pts):
        return self.module0(posenc(pts, 6))


class IoRNetwork(_SurfaceScalar):
    """Surface IoR scalar field: posenc(6) -> 256x3 (+1 un-ReLU'd) -> sigmoid."""


class ThicknessNetwork(_SurfaceScalar):
    """Shell thickness scalar field (same topology as IoRNetwork)."""


class MaterialFeatsNetwork(nn.Module):
    """Residual feature MLP (field.py:1089-1118)."""

    def __init__(self, device=None):
        super().__init__()
        e = posenc_dim(8)
        self.module0 = WNMLPStack(e, (256, 256, 256, 256), (True,) * 4,
                                  device=device)
        self.module1 = WNMLPStack(256 + e, (256, 256, 256, 256),
                                  (True, True, True, False), device=device)

    def reset_parameters(self, generator):
        self.module0.reset_parameters(generator)
        self.module1.reset_parameters(generator)

    def forward(self, pts):
        x = posenc(pts, 8)
        h = self.module0(x)
        return self.module1(torch.cat([h, x], dim=-1))
