"""Fused chain-MLP: CUDA kernels K1 (forward) and K2 (backward) with their
plain PyTorch version.

Counterpart of ``nunerf_tpu/ops/fused_mlp.py``.  Layer model, per layer ``l``::

    z_l = (h @ W_h[l] + x0 @ W_x[l]) * scale[l] + b[l]
    h   = act_l(z_l)

covering plain layers, NeuS pre-concat skips (split kernel rows, scale
1/sqrt(2)) and nerf-pytorch post-concat skips (scale 1).

* ``chain_mlp_reference`` is the plain version.  The CPU tests use it, and
  autograd through it is the plain version of K2.
* ``fused_chain_mlp`` is the entry point.  On a CUDA tensor it runs
  ``FusedChainMLP``: forward K1, backward K2 (``csrc/fused_mlp.cu``).  On a
  CPU tensor, and only there, it runs the plain version.
* ``launches`` counts kernel launches per wrapper: ``chain_fwd`` adds one
  per K1 launch, ``chain_bwd`` one per K2 call.

Second-order differentiation through the kernels is not supported (as in
the JAX package): the SDF's eikonal path runs the plain module.
"""

from __future__ import annotations

import ctypes
import os
from functools import lru_cache

import torch

ACT_CODES = {"none": 0, "relu": 1, "softplus100": 2}
ROWS_PER_BLOCK = 64  # TR in csrc/fused_mlp.cu
MAX_WIDTH = 256      # widest input and hidden layer the kernels take
MAX_OUT = 512        # widest last layer
MAX_LAYERS = 16

launches = {"chain_fwd": 0, "chain_bwd": 0}


def reset_launches():
    for k in launches:
        launches[k] = 0


class ChainSpec:
    """Static description of an MLP chain (hashable).

    acts: per-layer activation in {'relu', 'softplus100', 'none'}.
    has_skip: per-layer bool - the layer also consumes x0 through W_x.
    scales: per-layer multiplier on the pre-bias sum.
    dims: (in_dim, w1, ..., wL).
    compute_dtype: 'float32' or 'bfloat16' for the matmul operands and the
        hidden activations; accumulation and the last layer are f32.
    """

    def __init__(self, dims, acts, has_skip, scales, compute_dtype="float32"):
        self.dims = tuple(int(d) for d in dims)
        self.acts = tuple(acts)
        self.has_skip = tuple(bool(s) for s in has_skip)
        self.scales = tuple(float(s) for s in scales)
        self.compute_dtype = compute_dtype
        self.n_layers = len(self.acts)
        if len(self.dims) != self.n_layers + 1:
            raise ValueError(f"dims {self.dims} do not fit {self.n_layers} layers")
        if compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype {compute_dtype!r}")

    def _key(self):
        return (self.dims, self.acts, self.has_skip, self.scales,
                self.compute_dtype)

    def __hash__(self):
        return hash(self._key())

    def __eq__(self, other):
        return isinstance(other, ChainSpec) and self._key() == other._key()

    def __repr__(self):
        return f"ChainSpec{self._key()}"


def n_weights(spec: ChainSpec) -> int:
    return sum(2 if s else 1 for s in spec.has_skip)


def flat_weight_shapes(spec: ChainSpec):
    """Per layer W_h [prev, w] and, on a skip, W_x [in_dim, w]."""
    shapes = []
    prev = spec.dims[0]
    for l in range(spec.n_layers):
        w = spec.dims[l + 1]
        shapes.append((prev, w))
        if spec.has_skip[l]:
            shapes.append((spec.dims[0], w))
        prev = w
    return shapes


def chain_flops(spec: ChainSpec, n: int) -> int:
    """Matmul FLOPs of one forward over ``n`` rows."""
    return 2 * n * sum(a * b for a, b in flat_weight_shapes(spec))


def round_to(t: torch.Tensor, compute_dtype: str) -> torch.Tensor:
    """Round f32 values to the compute dtype, kept in f32."""
    if compute_dtype == "bfloat16":
        return t.to(torch.bfloat16).to(torch.float32)
    return t


def _act(name, z):
    if name == "relu":
        return torch.relu(z)
    if name == "softplus100":
        # softplus(beta=100) in the stable max(t,0) + log1p(exp(-|t|)) form,
        # without F.softplus's linear threshold branch
        t = z * 100.0
        return (torch.clamp(t, min=0.0) + torch.log1p(torch.exp(-t.abs()))) / 100.0
    return z


def chain_mlp_reference(spec: ChainSpec, x, *flat):
    """Plain PyTorch version of K1 (and, by autograd, of K2).

    Matmul operands are rounded to the compute dtype and multiplied in f32
    (a product of two bf16 values is exact in f32), hidden activations are
    rounded to the compute dtype and the last layer stays f32, as the TPU
    kernel's ``_forward_tile`` does.  In f32 it equals the JAX
    ``chain_mlp_reference``."""
    nw = n_weights(spec)
    weights, biases = flat[:nw], flat[nw:]
    cd = spec.compute_dtype
    h = round_to(x.to(torch.float32), cd)
    x0 = h
    wi = 0
    for l in range(spec.n_layers):
        z = h @ round_to(weights[wi], cd)
        wi += 1
        if spec.has_skip[l]:
            z = z + x0 @ round_to(weights[wi], cd)
            wi += 1
        if spec.scales[l] != 1.0:
            z = z * spec.scales[l]
        z = z + biases[l]
        h = _act(spec.acts[l], z)
        if l < spec.n_layers - 1:
            h = round_to(h, cd)
    return h


# ---------------------------------------------------------------- the kernels

@lru_cache(maxsize=None)
def _layout(spec: ChainSpec):
    """(meta ints, scales, widths sum) for the C interface: per layer
    in, out, W_h offset, W_x offset (-1: none), their transposes' offsets,
    bias offset, activation code, stash column base."""
    meta, off, boff, sbase = [], 0, 0, 0
    e = spec.dims[0]
    for l in range(spec.n_layers):
        i, w = spec.dims[l], spec.dims[l + 1]
        wh = off
        off += i * w
        wx = -1
        if spec.has_skip[l]:
            wx = off
            off += e * w
        meta += [i, w, wh, wx, wh, wx, boff, ACT_CODES[spec.acts[l]], sbase]
        boff += w
        sbase += w
    return tuple(meta), spec.scales, sbase


def _lib():
    from nunerf_tpu_torch.ops.cuda_build import load
    lib = load("fused_mlp")
    if not getattr(lib, "_nunerf_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        ip, fp = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float)
        lib.nunerf_chain_fwd.argtypes = [vp, vp, vp, vp, vp, ci, ip, fp, ci,
                                         ci, ci, vp]
        lib.nunerf_chain_bwd_data.argtypes = [vp, vp, vp, vp, vp, vp, ci, ip,
                                              fp, ci, ci, ci, vp]
        lib.nunerf_chain_dw.argtypes = [vp, vp, vp, ci, ci, ci, ci, vp]
        for fn in (lib.nunerf_chain_fwd, lib.nunerf_chain_bwd_data,
                   lib.nunerf_chain_dw):
            fn.restype = ci
        lib.nunerf_error_string.argtypes = [ci]
        lib.nunerf_error_string.restype = ctypes.c_char_p
        lib._nunerf_typed = True
    return lib


def _check(lib, err, what):
    if err != 0:
        msg = lib.nunerf_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({err})")


def _validate(spec: ChainSpec, x, flat, g=None):
    if not x.is_cuda:
        raise ValueError("the fused chain kernels take CUDA tensors")
    if (spec.n_layers > MAX_LAYERS or max(spec.dims[:-1]) > MAX_WIDTH
            or spec.dims[-1] > MAX_OUT):
        raise ValueError(f"{spec}: the kernels take at most {MAX_LAYERS} "
                         f"layers, widths <= {MAX_WIDTH} and a last layer "
                         f"<= {MAX_OUT}")
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != spec.dims[0]:
        raise ValueError(f"x must be f32 [N, {spec.dims[0]}], got "
                         f"{tuple(x.shape)} {x.dtype}")
    nw = n_weights(spec)
    shapes = flat_weight_shapes(spec) + [(1, d) for d in spec.dims[1:]]
    if len(flat) != nw + spec.n_layers:
        raise ValueError(f"expected {nw + spec.n_layers} weight arrays, got {len(flat)}")
    for t, s in zip(flat, shapes):
        if tuple(t.shape) != s or t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(f"weight {tuple(t.shape)} {t.dtype} {t.device}: "
                             f"expected {s} float32 on {x.device}")
    if g is not None and (tuple(g.shape) != (x.shape[0], spec.dims[-1])
                          or g.dtype != torch.float32 or g.device != x.device):
        raise ValueError(f"cotangent {tuple(g.shape)} {g.dtype}")


def _pack(spec: ChainSpec, flat, transposed: bool = False):
    nw = n_weights(spec)
    cd = spec.compute_dtype
    ws = [round_to(w, cd) for w in flat[:nw]]
    if transposed:
        # f32 originals, as the TPU kernel's precomputed transposes
        ws = [w.t() for w in flat[:nw]]
    return torch.cat([w.reshape(-1) for w in ws]).contiguous()


def _c_meta(spec):
    meta, scales, _ = _layout(spec)
    return ((ctypes.c_int * len(meta))(*meta),
            (ctypes.c_float * len(scales))(*scales))


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _fwd_launch(lib, spec, x, W, B, out, stash):
    meta, scales = _c_meta(spec)
    err = lib.nunerf_chain_fwd(
        x.data_ptr(), W.data_ptr(), B.data_ptr(), out.data_ptr(),
        stash.data_ptr() if stash is not None else None, x.shape[0], meta,
        scales, spec.n_layers, spec.dims[0],
        int(spec.compute_dtype == "bfloat16"), _stream())
    _check(lib, err, "chain_fwd")


def chain_fwd_cuda(spec: ChainSpec, x, flat):
    """K1: the chain over ``x`` [N, in_dim] -> f32 [N, out_dim]."""
    _validate(spec, x, flat)
    x = x.contiguous()
    n = x.shape[0]
    out = torch.empty((n, spec.dims[-1]), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    lib = _lib()
    W = _pack(spec, flat)
    B = torch.cat([b.reshape(-1) for b in flat[n_weights(spec):]]).contiguous()
    _fwd_launch(lib, spec, x, W, B, out, None)
    launches["chain_fwd"] += 1
    return out


def chain_bwd_cuda(spec: ChainSpec, x, g, flat):
    """K2: (dx [N, in_dim], (dW..., db...)) of ``sum(chain(x) * g)``.

    Pass 1 recomputes the forward into a scratch stash, pass 2 walks the
    layers down per row tile (dx, db partials, the rounded gz stash), pass 3
    forms each dW as per-split partials; the partials are summed here, as
    the JAX wrapper sums the Pallas kernel's per-tile partials."""
    _validate(spec, x, flat, g)
    x, g = x.contiguous(), g.contiguous()
    n, e = x.shape
    nw = n_weights(spec)
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    _, _, wsum = _layout(spec)
    if n == 0:
        return (torch.zeros((0, e), **f32),
                tuple(torch.zeros(s, **f32) for s in flat_weight_shapes(spec))
                + tuple(torch.zeros((1, d), **f32) for d in spec.dims[1:]))
    lib = _lib()
    W = _pack(spec, flat)
    WT = _pack(spec, flat, transposed=True)
    B = torch.cat([b.reshape(-1) for b in flat[nw:]]).contiguous()
    stash = torch.empty(n * wsum, **f32)
    gzs = torch.empty(n * wsum, **f32)
    out = torch.empty((n, spec.dims[-1]), **f32)
    dx = torch.empty((n, e), **f32)
    n_blocks = -(-n // ROWS_PER_BLOCK)
    dbp = torch.empty((n_blocks, wsum), **f32)

    _fwd_launch(lib, spec, x, W, B, out, stash)
    meta, scales = _c_meta(spec)
    err = lib.nunerf_chain_bwd_data(
        stash.data_ptr(), WT.data_ptr(), g.data_ptr(), dx.data_ptr(),
        gzs.data_ptr(), dbp.data_ptr(), n, meta, scales, spec.n_layers, e,
        int(spec.compute_dtype == "bfloat16"), _stream())
    _check(lib, err, "chain_bwd_data")

    x0 = round_to(x, spec.compute_dtype).contiguous()
    splits = max(1, min(128, -(-n // 512)))
    dws, dbs, base = [], [], 0
    for l in range(spec.n_layers):
        i, w = spec.dims[l], spec.dims[l + 1]
        gz = gzs[n * base:n * (base + w)]
        h_prev = x0 if l == 0 else stash[n * (base - i):n * base]
        srcs = [(h_prev, i)] + ([(x0, e)] if spec.has_skip[l] else [])
        for h, hi in srcs:
            part = torch.empty((splits, hi, w), **f32)
            err = lib.nunerf_chain_dw(h.data_ptr(), gz.data_ptr(),
                                      part.data_ptr(), n, hi, w, splits,
                                      _stream())
            _check(lib, err, "chain_dw")
            dws.append(part.sum(0))
        dbs.append(dbp[:, base:base + w].sum(0, keepdim=True))
        base += w
    launches["chain_bwd"] += 1
    return dx, tuple(dws) + tuple(dbs)


class FusedChainMLP(torch.autograd.Function):
    """Forward K1, backward K2.  First-order only."""

    @staticmethod
    def forward(ctx, spec, x, *flat):
        ctx.spec = spec
        ctx.save_for_backward(x, *flat)
        return chain_fwd_cuda(spec, x, flat)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, *flat = ctx.saved_tensors
        dx, dflat = chain_bwd_cuda(ctx.spec, x, g.to(torch.float32), flat)
        return (None, dx, *dflat)


def fused_chain_mlp(spec: ChainSpec, x, *flat):
    """Run the chain over ``x`` [N, in_dim]; f32 [N, out_dim].

    ``flat``: per layer W_h (and W_x on a skip), then biases as [1, w].
    A CUDA tensor goes through the kernels; a CPU tensor through
    ``chain_mlp_reference``."""
    if x.is_cuda:
        return FusedChainMLP.apply(spec, x, *flat)
    return chain_mlp_reference(spec, x, *flat)


def use_fused_sdf_value(device) -> bool:
    """Gate for the fused forward on the value-only SDF path (sampling
    sweeps, occlusion march, init-SDF regulariser): on for a CUDA device,
    off on the CPU; env NUNERF_FUSED_SDF_VALUE=0/1 overrides (the kernels
    still run only on CUDA tensors)."""
    v = os.environ.get("NUNERF_FUSED_SDF_VALUE")
    if v is not None:
        return v not in ("0", "false", "")
    return torch.device(device).type == "cuda"
