"""NeRF MLP used as the NeRF++ background model outside the unit sphere;
counterpart of ``nunerf_tpu/fields/nerf.py`` (reference
``network/field.py:212-305``).

Input is ``(x/|x|, 1/|x|)`` (4-D) plus view directions; D=8, W=256, skip at
layer 4, viewdirs head.  The trunk is plain PyTorch: the fused chain kernel
is not wired to it yet (the JAX ``fused_mlp`` gate).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from nunerf_tpu_torch.fields.mlp import Dense
from nunerf_tpu_torch.ops.embedder import posenc, posenc_dim


class NeRFNetwork(nn.Module):
    def __init__(self, d_in: int = 4, d_views: int = 3, depth: int = 8,
                 width: int = 256, multires: int = 10, multires_view: int = 4,
                 skips: Sequence[int] = (4,), rgb_bias_init: float = 0.0,
                 dtype=None, device=None):
        super().__init__()
        self.depth, self.width = depth, width
        self.multires, self.multires_view = multires, multires_view
        self.skips = tuple(skips)
        self.dtype = dtype
        e = posenc_dim(multires, d_in)
        kw = dict(dtype=dtype, device=device)
        for i in range(depth):
            cin = e if i == 0 else (e + width if (i - 1) in self.skips else width)
            self.add_module(f"pts_{i}", Dense(cin, width, **kw))
        h_out = e + width if (depth - 1) in self.skips else width
        self.alpha = Dense(h_out, 1, **kw)
        self.feature = Dense(h_out, width, **kw)
        self.views_0 = Dense(width + posenc_dim(multires_view, d_views),
                             width // 2, **kw)
        self.rgb = Dense(width // 2, 3, bias_const=float(rgb_bias_init), **kw)

    def reset_parameters(self, generator):
        for m in self.children():
            m.reset_parameters(generator)

    def _trunk(self, pts):
        enc = posenc(pts, self.multires)
        h = enc
        for i in range(self.depth):
            h = torch.relu(getattr(self, f"pts_{i}")(h))
            if i in self.skips:
                h = torch.cat([enc, h.to(enc.dtype)], dim=-1)
        return h

    def forward(self, pts, views):
        h = self._trunk(pts)
        alpha = self.alpha(h)
        feature = self.feature(h)
        venc = posenc(views, self.multires_view)
        if self.dtype is not None:
            venc = venc.to(self.dtype)
        hv = torch.cat([feature, venc.to(feature.dtype)], dim=-1)
        hv = torch.relu(self.views_0(hv))
        rgb = self.rgb(hv)
        dt = self.rgb.kernel.dtype  # outputs leave in the parameters' dtype
        return alpha.to(dt), rgb.to(dt)

    def density(self, pts):
        return self.alpha(self._trunk(pts)).to(self.alpha.kernel.dtype)
