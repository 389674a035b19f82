"""MLP building blocks: weight-normalized dense layers and predictor heads;
counterpart of ``nunerf_tpu/fields/mlp.py`` (reference
``network/field.py:320-408``).

Weight norm: ``W = g * V / ||V||`` with the norm per output unit.  The kernel
``v`` is kept ``[in, out]`` as in the JAX package, so the norm runs over dim 0
(clamped at 1e-12), and ``g`` starts at ``||V_init||``.

``dtype`` (None or ``torch.bfloat16``) is the compute dtype of a layer's
matmul; parameters stay f32.  A bf16 layer rounds its operands to bf16,
accumulates in f32, adds the f32 bias and rounds once to bf16 (``_Bf16Dense``);
it returns bf16.

``Predictor(fused=True)`` runs its layer stack through the fused chain kernel
(K1 forward, K2 backward; the plain chain on the CPU).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn


def uniform_(t: torch.Tensor, bound: float, generator):
    """U(-bound, bound) in place, drawn on the CPU from ``generator`` so one
    seed gives the same weights on every device."""
    with torch.no_grad():
        t.copy_((torch.rand(t.shape, generator=generator) * 2.0 - 1.0) * bound)
    return t


def normal_(t: torch.Tensor, mean: float, std: float, generator):
    with torch.no_grad():
        t.copy_(mean + std * torch.randn(t.shape, generator=generator))
    return t


# the product of a bf16 dense layer, by device type (see ``_Bf16Dense``)
ROUTES = {"cuda": "torch.mm(bf16, bf16, out_dtype=float32)",
          "cpu": "float32 matmul of the bf16 values"}


class _Bf16Dense(torch.autograd.Function):
    """``round_bf16(x @ k + b)`` from bf16 ``x`` [..., in] and ``k`` [in, out]
    and an f32 ``b``: the products accumulate in f32, the bias is added in
    f32 and the sum is rounded once, as the JAX layers' ``jnp.dot(...,
    preferred_element_type=f32) + b`` then ``astype(bf16)`` do.

    The product takes one route per device type:
    - CUDA: cuBLAS's bf16 tensor-core GEMM with an f32 output
      (``torch.mm(..., out_dtype=torch.float32)``, which has no autograd
      formula, hence this Function);
    - CPU: an f32 matmul of the bf16 values (a product of two bf16 values is
      exact in f32), as ``chain_mlp_reference`` does.

    The backward is that of the bf16 matmul: dx and dk are bf16 products of
    the bf16 cotangent, db its f32 sum.  It is written with differentiable
    ops, so the SDF's double backward goes through it."""

    @staticmethod
    def forward(ctx, x, k, b):
        x2 = x.reshape(-1, x.shape[-1])
        if x.device.type == "cuda":
            y = torch.mm(x2, k, out_dtype=torch.float32)
        else:
            y = x2.to(torch.float32) @ k.to(torch.float32)
        ctx.save_for_backward(x, k)
        return (y + b).to(torch.bfloat16).reshape(*x.shape[:-1], k.shape[-1])

    @staticmethod
    def backward(ctx, g):
        x, k = ctx.saved_tensors
        g = g.to(torch.bfloat16)
        dx = dk = db = None
        if ctx.needs_input_grad[0]:
            dx = g @ k.t()
        if ctx.needs_input_grad[1]:
            dk = x.reshape(-1, x.shape[-1]).t() @ g.reshape(-1, g.shape[-1])
        if ctx.needs_input_grad[2]:
            db = g.to(torch.float32).reshape(-1, g.shape[-1]).sum(0)
        return dx, dk, db


def _matmul(x, kernel, b, dtype):
    if dtype is not None:
        return _Bf16Dense.apply(x.to(dtype), kernel.to(dtype), b)
    # mixed inputs promote (a bf16 activation into an f32 layer), as in JAX
    dt = torch.promote_types(x.dtype, kernel.dtype)
    y = x.to(dt) @ kernel.to(dt)
    return y + b if b is not None else y


class WNDense(nn.Module):
    """Weight-normalized dense layer: parameters ``v`` [in, out], ``g`` [out],
    ``b`` [out].  Default init is PyTorch's nn.Linear one,
    U(-1/sqrt(in), 1/sqrt(in)) for both, with ``g = ||v||``;
    ``bias_const`` sets a constant bias instead."""

    def __init__(self, in_features: int, features: int, dtype=None,
                 bias_const: Optional[float] = None, device=None):
        super().__init__()
        self.dtype = dtype
        self.bias_const = bias_const
        self.v = nn.Parameter(torch.empty(in_features, features, device=device))
        self.g = nn.Parameter(torch.empty(features, device=device))
        self.b = nn.Parameter(torch.empty(features, device=device))

    def reset_parameters(self, generator, v_init=None, b_const=None):
        """``v_init(shape) -> tensor`` overrides the kernel init."""
        bound = 1.0 / math.sqrt(self.v.shape[0])
        with torch.no_grad():
            if v_init is None:
                uniform_(self.v, bound, generator)
            else:
                self.v.copy_(v_init(tuple(self.v.shape)))
            self.g.copy_(torch.linalg.norm(self.v, dim=0))
            const = self.bias_const if b_const is None else b_const
            if const is None:
                uniform_(self.b, bound, generator)
            else:
                self.b.fill_(const)

    def weight(self):
        norm = torch.clamp(torch.linalg.norm(self.v, dim=0), min=1e-12)
        return self.v * (self.g / norm)

    def forward(self, x):
        return _matmul(x, self.weight(), self.b, self.dtype)


class Dense(nn.Module):
    """Plain dense layer (``kernel`` [in, out], ``bias`` [out]) with PyTorch's
    default init, for the NeRF background MLP."""

    def __init__(self, in_features: int, features: int, dtype=None,
                 bias_const: Optional[float] = None, device=None):
        super().__init__()
        self.dtype = dtype
        self.bias_const = bias_const
        self.kernel = nn.Parameter(torch.empty(in_features, features, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))

    def reset_parameters(self, generator):
        bound = 1.0 / math.sqrt(self.kernel.shape[0])
        uniform_(self.kernel, bound, generator)
        if self.bias_const is None:
            uniform_(self.bias, bound, generator)
        else:
            with torch.no_grad():
                self.bias.fill_(self.bias_const)

    def forward(self, x):
        return _matmul(x, self.kernel, self.bias, self.dtype)


def exp_activation(x, max_light: float = 5.0):
    """ExpActivation (field.py:312-318): exp(clip(x, max=max_light))."""
    return torch.exp(torch.clamp(x, max=max_light))


_ACTS = {
    "sigmoid": torch.sigmoid,
    "relu": torch.relu,
    "none": lambda x: x,
}


class Predictor(nn.Module):
    """``make_predictor`` head (field.py:371-408): ``n_hidden`` 256-wide WN
    layers with ReLU, a final WN layer and an activation.  ``final_bias``
    sets the last layer's bias constant.  ``fused`` sends the stack through
    the fused chain kernel."""

    def __init__(self, in_dim: int, out_dim: int, n_hidden: int = 3,
                 activation: str = "sigmoid", exp_max: float = 0.0,
                 final_bias: Optional[float] = None, dtype=None,
                 fused: bool = False, device=None):
        super().__init__()
        self.activation = activation
        self.exp_max = exp_max
        self.dtype = dtype
        self.fused = fused
        dims = [in_dim] + [256] * n_hidden
        for i in range(n_hidden):
            self.add_module(f"hidden_{i}", WNDense(dims[i], 256, dtype=dtype,
                                                   device=device))
        self.n_hidden = n_hidden
        self.out = WNDense(256, out_dim, dtype=dtype, bias_const=final_bias,
                           device=device)

    def reset_parameters(self, generator):
        for m in self.children():
            m.reset_parameters(generator)

    def chain(self):
        """(spec, flat) of the layer stack for the fused chain kernel: hidden
        layers relu, the last linear; bf16 operands only when the head's
        dtype is bf16."""
        from nunerf_tpu_torch.ops.fused_mlp import ChainSpec

        layers = [getattr(self, f"hidden_{i}") for i in range(self.n_hidden)] + [self.out]
        n_l = len(layers)
        spec = ChainSpec(
            (layers[0].v.shape[0],) + tuple(m.v.shape[1] for m in layers),
            ("relu",) * (n_l - 1) + ("none",), (False,) * n_l, (1.0,) * n_l,
            compute_dtype="bfloat16" if self.dtype == torch.bfloat16 else "float32")
        return spec, [m.weight() for m in layers] + [m.b[None, :] for m in layers]

    def forward(self, x):
        if self.fused:
            from nunerf_tpu_torch.ops.fused_mlp import fused_chain_mlp

            spec, flat = self.chain()
            # the input goes in as f32; the head's activation follows in f32
            x2 = x.reshape(-1, x.shape[-1]).to(torch.float32).contiguous()
            x = fused_chain_mlp(spec, x2, *flat).reshape(*x.shape[:-1], spec.dims[-1])
        else:
            for i in range(self.n_hidden):
                x = torch.relu(getattr(self, f"hidden_{i}")(x))
            x = self.out(x)
        # head outputs leave in the parameters' dtype (f32) for the physics
        x = x.to(self.out.v.dtype)
        if self.activation == "exp":
            return exp_activation(x, self.exp_max)
        return _ACTS[self.activation](x)


class WNMLPStack(nn.Module):
    """A fixed stack of WN layers with per-layer ReLU flags (field.py:1020-1087)."""

    def __init__(self, in_dim: int, features: Sequence[int],
                 relu_after: Sequence[bool], final_act: str = "none",
                 device=None):
        super().__init__()
        self.relu_after = tuple(relu_after)
        self.final_act = final_act
        prev = in_dim
        for i, f in enumerate(features):
            self.add_module(f"layer_{i}", WNDense(prev, f, device=device))
            prev = f

    def reset_parameters(self, generator):
        for m in self.children():
            m.reset_parameters(generator)

    def forward(self, x):
        for i, r in enumerate(self.relu_after):
            x = getattr(self, f"layer_{i}")(x)
            if r:
                x = torch.relu(x)
        return _ACTS[self.final_act](x)
