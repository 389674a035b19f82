"""NeuS SDF network with geometric (sphere) initialization; counterpart of
``nunerf_tpu/fields/sdf.py`` (reference ``network/field.py:64-184``).

8x256 weight-normalized MLP, skip at the middle layer (concat input /
sqrt(2)), softplus(beta=100) activations, output ``[sdf, feature_256]``.
Normals come from autograd with ``create_graph=True`` (the reference's double
backward), or, behind the ``fused_sdf`` gate, from ``fused_sdf_all``: the
value+Jacobian kernel K4, differentiated by K5.  The value-only path
(``fused_sdf_apply``) runs the fused chain kernel K1, differentiable once
through K2.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
from torch import nn

from nunerf_tpu_torch.fields.mlp import WNDense, normal_
from nunerf_tpu_torch.ops.embedder import posenc, posenc_dim


class _Softplus(torch.autograd.Function):
    """softplus(t) in the stable max(t,0) + log1p(exp(-|t|)) form, with the
    derivative JAX gives ``jnp.logaddexp(t, 0)`` (its custom JVP):
    ``exp(t - softplus(t))``, one exp of a difference in the input's dtype.
    Autograd through the forward's ops would sum two terms, each rounded in
    bf16, and so round the SDF's bf16 normal elsewhere than JAX does.  The
    backward is written with differentiable ops, for the double backward."""

    @staticmethod
    def forward(ctx, t):
        y = torch.clamp(t, min=0.0) + torch.log1p(torch.exp(-t.abs()))
        ctx.save_for_backward(t, y)
        return y

    @staticmethod
    def backward(ctx, g):
        t, y = ctx.saved_tensors
        return g * torch.exp(t - y)


def softplus100(x):
    """softplus(beta=100), the JAX ``jax.nn.softplus(100 x) / 100``."""
    return _Softplus.apply(x * 100.0) / 100.0


class SDFNetwork(nn.Module):
    def __init__(self, d_in: int = 3, d_out: int = 257, d_hidden: int = 256,
                 n_layers: int = 8, skip_in: Sequence[int] = (4,),
                 multires: int = 6, bias: float = 0.5, scale: float = 1.0,
                 geometric_init: bool = True, inside_outside: bool = False,
                 dtype=None, device=None):
        super().__init__()
        self.d_in, self.d_out = d_in, d_out
        self.skip_in = tuple(skip_in)
        self.multires = multires
        self.bias = bias
        self.scale = scale
        self.geometric_init = geometric_init
        self.inside_outside = inside_outside
        self.dtype = dtype
        in_dim = posenc_dim(multires, d_in) if multires > 0 else d_in
        self.dims = [in_dim] + [d_hidden] * n_layers + [d_out]
        self.num_layers = len(self.dims)
        h_dim = in_dim
        for l in range(self.num_layers - 1):
            out_dim = (self.dims[l + 1] - self.dims[0] if l + 1 in self.skip_in
                       else self.dims[l + 1])
            cur_in = h_dim + (in_dim if l in self.skip_in else 0)
            # the final layer keeps f32 (sdf and feature leave in full precision)
            lt = None if l == self.num_layers - 2 else dtype
            self.add_module(f"lin{l}", WNDense(cur_in, out_dim, dtype=lt,
                                               device=device))
            h_dim = out_dim

    def layers(self):
        return [getattr(self, f"lin{l}") for l in range(self.num_layers - 1)]

    def reset_parameters(self, generator):
        dims = self.dims
        for l, lin in enumerate(self.layers()):
            out_dim = lin.v.shape[1]
            if not self.geometric_init:
                lin.reset_parameters(generator)
                continue
            if l == self.num_layers - 2:
                mean = np.sqrt(np.pi) / np.sqrt(dims[l])
                sign = -1.0 if self.inside_outside else 1.0
                lin.reset_parameters(
                    generator,
                    v_init=lambda s, m=sign * mean: normal_(torch.empty(s), m, 1e-4, generator),
                    b_const=self.bias if self.inside_outside else -self.bias)
            elif self.multires > 0 and l == 0:
                std = np.sqrt(2) / np.sqrt(out_dim)

                def v0(s, _std=std):
                    w = torch.zeros(s)
                    w[:3, :] = normal_(torch.empty(3, s[1]), 0.0, _std, generator)
                    return w
                lin.reset_parameters(generator, v_init=v0, b_const=0.0)
            elif self.multires > 0 and l in self.skip_in:
                std = np.sqrt(2) / np.sqrt(out_dim)
                n_zero = dims[0] - 3

                def vs(s, _std=std, _nz=n_zero):
                    w = normal_(torch.empty(s), 0.0, _std, generator)
                    w[s[0] - _nz:, :] = 0.0
                    return w
                lin.reset_parameters(generator, v_init=vs, b_const=0.0)
            else:
                std = np.sqrt(2) / np.sqrt(out_dim)
                lin.reset_parameters(
                    generator,
                    v_init=lambda s, _std=std: normal_(torch.empty(s), 0.0, _std, generator),
                    b_const=0.0)

    def embed(self, x):
        inputs = x * self.scale
        if self.multires > 0:
            inputs = posenc(inputs, self.multires)
        return inputs

    def forward(self, x):
        inputs = self.embed(x)
        h = inputs
        last = self.num_layers - 2
        for l, lin in enumerate(self.layers()):
            if l in self.skip_in:
                h = torch.cat([h, inputs.to(h.dtype)], dim=-1) / math.sqrt(2)
            h = lin(h)
            if l < last:
                h = softplus100(h)
        return h


def _sdf_chain(module: SDFNetwork, device):
    """(spec, flat) of the SDF chain for the fused kernels.  Compute dtype:
    bf16 on CUDA (where the JAX package has it on the TPU), f32 on the CPU."""
    from nunerf_tpu_torch.ops.fused_mlp import ChainSpec

    layers = module.layers()
    n_l = len(layers)
    in_dim = module.dims[0]
    dims, acts, has_skip, scales = [in_dim], [], [], []
    flat_w, flat_b = [], []
    prev_real = in_dim
    for l, lin in enumerate(layers):
        w = lin.weight()
        if l in module.skip_in:
            # input was concat([h(prev_real), inputs(in_dim)]) / sqrt(2)
            flat_w += [w[:prev_real], w[prev_real:]]
            has_skip.append(True)
            scales.append(1.0 / float(np.sqrt(2)))
        else:
            flat_w.append(w)
            has_skip.append(False)
            scales.append(1.0)
        flat_b.append(lin.b[None, :])
        dims.append(w.shape[1])
        acts.append("softplus100" if l < n_l - 1 else "none")
        prev_real = w.shape[1]
    cd = "bfloat16" if torch.device(device).type == "cuda" else "float32"
    spec = ChainSpec(tuple(dims), tuple(acts), tuple(has_skip), tuple(scales),
                     compute_dtype=cd)
    return spec, flat_w + flat_b


def fused_sdf_apply(module: SDFNetwork, x, value_only: bool = False):
    """SDF forward through the fused chain kernel (ops/fused_mlp.py).

    First-order differentiable only.  ``value_only`` slices the final layer
    to the sdf column before the kernel, so it writes [N,1] instead of
    [N,257]."""
    from nunerf_tpu_torch.ops.fused_mlp import ChainSpec, fused_chain_mlp, n_weights

    spec, flat = _sdf_chain(module, x.device)
    if value_only:
        nw = n_weights(spec)
        # flat[nw-1] must be the last layer's ONLY weight
        if spec.has_skip[-1]:
            raise ValueError("value_only requires a skip-free final layer")
        flat = list(flat)
        flat[nw - 1] = flat[nw - 1][:, :1].contiguous()
        flat[-1] = flat[-1][:, :1].contiguous()
        spec = ChainSpec(spec.dims[:-1] + (1,), spec.acts, spec.has_skip,
                         spec.scales, compute_dtype=spec.compute_dtype)
    flat = [f.contiguous() for f in flat]
    x2 = module.embed(x.reshape(-1, x.shape[-1])).to(torch.float32).contiguous()
    y = fused_chain_mlp(spec, x2, *flat)
    return y.reshape(*x.shape[:-1], 1 if value_only else module.d_out)


def _embed_pullback(module: SDFNetwork, x, g_emb):
    """``g_emb`` [N, embed dim], a cotangent of ``module.embed(x)``, pulled
    back to ``x`` [N, d].  Written out in the column order of ``posenc``
    (``x``, then ``sin`` and ``cos`` of each frequency) with plain tensor
    operations, so autograd differentiates it in both ``g_emb`` and ``x``
    (the eikonal loss does)."""
    d = x.shape[-1]
    g = g_emb[:, :d]
    m = module.multires
    if m > 0:
        freqs = 2.0 ** torch.arange(m, dtype=x.dtype, device=x.device)
        xb = (x * module.scale)[:, None, :] * freqs[:, None]     # [N, m, d]
        ge = g_emb[:, d:].reshape(-1, m, 2, d)
        g = g + torch.sum(freqs[:, None] * (torch.cos(xb) * ge[:, :, 0]
                                            - torch.sin(xb) * ge[:, :, 1]), dim=1)
    return g * module.scale


def fused_sdf_all(module: SDFNetwork, x):
    """(sdf, feats, grad_x) through the value+Jacobian kernels (K4, and K5
    when differentiated); counterpart of the JAX ``fused_sdf_all``.

    The kernel gives d sdf / d embedding; ``_embed_pullback`` maps it to xyz.
    Losses of all three outputs differentiate through K5, which takes the
    place of ``sdf_value_feature_grad``'s double backward."""
    from nunerf_tpu_torch.ops.fused_mlp import chain_mlp_with_grad0

    spec, flat = _sdf_chain(module, x.device)
    flat = [f.contiguous() for f in flat]
    x2 = x.reshape(-1, x.shape[-1])
    emb = module.embed(x2).to(torch.float32).contiguous()
    y, j_emb = chain_mlp_with_grad0(spec, emb, *flat)
    grad_x = _embed_pullback(module, x2.to(torch.float32), j_emb)
    lead = x.shape[:-1]
    return (y[..., 0].reshape(lead), y[..., 1:].reshape(*lead, -1),
            grad_x.reshape(*lead, x.shape[-1]))


def sdf_value_feature_grad(module: SDFNetwork, points):
    """(sdf [N], feature [N,256], grad_sdf [N,3]).

    The gradient is the pullback of the channel-0 cotangent, taken with
    ``create_graph`` when autograd records, so training differentiates it
    again (the reference's double backward, field.py:158-170)."""
    record = torch.is_grad_enabled()
    with torch.enable_grad():
        x = points if points.requires_grad else points.detach().requires_grad_(True)
        out = module(x)
        ct = torch.zeros_like(out)
        ct[..., 0] = 1.0
        grads, = torch.autograd.grad(out, x, grad_outputs=ct,
                                     create_graph=record)
    if not record:
        out = out.detach()
    return out[..., 0], out[..., 1:], grads
