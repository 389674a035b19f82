"""NeRF MLP used as the NeRF++ background model outside the unit sphere;
counterpart of ``nunerf_tpu/fields/nerf.py`` (reference
``network/field.py:212-305``).

Input is ``(x/|x|, 1/|x|)`` (4-D) plus view directions; D=8, W=256, skip at
layer 4, viewdirs head.  ``fused=True`` runs the trunk through the fused chain
kernel (K1 forward, K2 backward; the plain chain on the CPU).
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
                 dtype=None, fused: bool = False, device=None):
        super().__init__()
        self.fused = fused
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
        if self.fused:
            return self._trunk_fused(enc)
        h = enc
        for i in range(self.depth):
            h = torch.relu(getattr(self, f"pts_{i}")(h))
            if i in self.skips:
                h = torch.cat([enc, h.to(enc.dtype)], dim=-1)
        return h

    def trunk_chain(self):
        """(spec, flat) of the trunk for the fused chain kernel.  The
        post-activation skip ``h = cat([enc, h])`` makes the NEXT layer a
        split layer: rows [0:E] of its kernel multiply ``enc`` (the W_x
        half), rows [E:] the carried ``h`` (the W_h half), scale 1; every
        layer is relu."""
        from nunerf_tpu_torch.ops.fused_mlp import ChainSpec

        e = self.pts_0.kernel.shape[0]
        flat_w, flat_b, has_skip = [], [], []
        for i in range(self.depth):
            lin = getattr(self, f"pts_{i}")
            split = i > 0 and (i - 1) in self.skips
            if split:
                flat_w += [lin.kernel[e:], lin.kernel[:e]]
            else:
                flat_w.append(lin.kernel)
            has_skip.append(split)
            flat_b.append(lin.bias[None, :])
        spec = ChainSpec(
            (e,) + (self.width,) * self.depth, ("relu",) * self.depth,
            tuple(has_skip), (1.0,) * self.depth,
            compute_dtype="bfloat16" if self.dtype == torch.bfloat16 else "float32")
        return spec, flat_w + flat_b

    def _trunk_fused(self, enc):
        from nunerf_tpu_torch.ops.fused_mlp import fused_chain_mlp

        spec, flat = self.trunk_chain()
        e = enc.shape[-1]
        h = fused_chain_mlp(spec, enc.reshape(-1, e).to(torch.float32).contiguous(), *flat)
        h = h.reshape(*enc.shape[:-1], self.width)
        if (self.depth - 1) in self.skips:
            h = torch.cat([enc.to(h.dtype), h], dim=-1)
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
