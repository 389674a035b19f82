"""Fused chain-MLP: CUDA kernels K1 (forward), K2 (backward) and the
value+Jacobian pair K4/K5, with their plain PyTorch versions.

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
* ``chain_mlp_with_grad0`` returns ``(y, j)`` with ``j = d y[:, 0] / dx``
  (the SDF's value, feature and normal in one call).  On a CUDA tensor it
  runs ``ChainMLPWithGrad0``: forward K4, backward K5 from ``(gy, gj)``, the
  hand-derived reverse of both sweeps, so a loss of ``j`` (the eikonal term)
  needs no second-order autograd.  On a CPU tensor, and only there, it runs
  ``chain_mlp_with_grad0_reference``, which autograd differentiates.
* ``launches`` counts kernel launches per wrapper: ``chain_fwd`` adds one
  per K1 launch, ``chain_bwd`` one per K2 call, ``chain_jac_fwd`` one per K4
  call and ``chain_jac_bwd`` one per K5 call.

Second-order differentiation through K1/K2 is not supported (as in the JAX
package): without ``fused_sdf`` the SDF's eikonal path runs the plain module.
"""

from __future__ import annotations

import ctypes
import os
from functools import lru_cache

import torch

ACT_CODES = {"none": 0, "relu": 1, "softplus100": 2}
ROWS_PER_BLOCK = 64  # TR in csrc/fused_mlp.cu
MAX_WIDTH = 256      # widest hidden layer the kernels take (K4/K5: input too)
MAX_IN = 512         # widest input of K1/K2
MAX_OUT = 512        # widest last layer
MAX_LAYERS = 16
# K4/K5 keep f32 scratch stashes of every layer's activation (about 9 KB a
# row for the SDF chain, one for K4, four for K5): rows go through in chunks
JAC_CHUNK_ROWS = 65536

launches = {"chain_fwd": 0, "chain_bwd": 0, "chain_jac_fwd": 0,
            "chain_jac_bwd": 0}


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


def _act_grad_from_a(name, a):
    """act'(z) recovered from the stored activation a = act(z)."""
    if name == "relu":
        return (a > 0).to(torch.float32)
    if name == "softplus100":
        return 1.0 - torch.exp(-100.0 * a)
    return torch.ones_like(a)


def _layer_starts(spec: ChainSpec):
    """Index of each layer's W_h in the flat weight list."""
    starts, wi = [], 0
    for s in spec.has_skip:
        starts.append(wi)
        wi += 2 if s else 1
    return starts


def chain_mlp_with_grad0_reference(spec: ChainSpec, x, *flat):
    """Plain PyTorch version of K4 (and, by autograd, of K5): ``(y, j)`` with
    ``y = chain(x)`` and ``j = d y[:, 0] / dx``.

    The two sweeps are written out with the kernels' rounding points: the
    forward as ``chain_mlp_reference``; ``d_l = act'`` from the stored
    activation; the reverse sweep for channel 0 seeded with the f32 column 0
    of the last ``W_h`` times its scale, then ``p_l = round(q_l * d_l)``,
    ``q_{l-1} = s_l p_l round(W_h)^T`` and ``j += s_l p_l round(W_x)^T`` on a
    skip.  In f32 nothing is rounded and ``j`` equals autograd's gradient."""
    _check_jac_spec(spec)
    nw = n_weights(spec)
    weights, biases = flat[:nw], flat[nw:]
    cd = spec.compute_dtype
    starts = _layer_starts(spec)
    n_l = spec.n_layers
    h = round_to(x.to(torch.float32), cd)
    x0 = h
    d_list = []
    for l in range(n_l):
        z = h @ round_to(weights[starts[l]], cd)
        if spec.has_skip[l]:
            z = z + x0 @ round_to(weights[starts[l] + 1], cd)
        if spec.scales[l] != 1.0:
            z = z * spec.scales[l]
        h = _act(spec.acts[l], z + biases[l])
        if l < n_l - 1:
            h = round_to(h, cd)
            d_list.append(_act_grad_from_a(spec.acts[l], h))
    y = h

    last = n_l - 1
    q = (spec.scales[last] * weights[starts[last]][:, 0])[None, :].expand(
        x.shape[0], -1)
    j = torch.zeros_like(x0)
    if spec.has_skip[last]:
        j = j + spec.scales[last] * weights[starts[last] + 1][:, 0][None, :]
    for l in reversed(range(n_l - 1)):
        p = round_to(q * d_list[l], cd)
        if spec.has_skip[l]:
            j = j + spec.scales[l] * (p @ round_to(weights[starts[l] + 1], cd).t())
        q = (p @ round_to(weights[starts[l]], cd).t()) * spec.scales[l]
    return y, j + q


def _check_jac_spec(spec: ChainSpec):
    if spec.n_layers < 2 or spec.acts[-1] != "none":
        raise ValueError(f"{spec}: the value+Jacobian chain needs at least two "
                         "layers and a linear last layer")


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
        lib.nunerf_chain_bwd_data.argtypes = [vp, vp, vp, vp, vp, vp, vp, ci,
                                              ip, fp, ci, ci, ci, vp]
        lib.nunerf_chain_jac_down.argtypes = [vp, vp, vp, vp, vp, vp, ci, ip,
                                              fp, ci, ci, ci, vp]
        lib.nunerf_chain_jac_up.argtypes = [vp, vp, vp, vp, vp, vp, vp, ci,
                                            ip, fp, ci, ci, ci, vp]
        lib.nunerf_chain_dw.argtypes = [vp, vp, vp, ci, ci, ci, ci, vp]
        for fn in (lib.nunerf_chain_fwd, lib.nunerf_chain_bwd_data,
                   lib.nunerf_chain_jac_down, lib.nunerf_chain_jac_up,
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


def check_limits(spec: ChainSpec, max_in: int = MAX_IN):
    """Raise unless the kernels take the chain's depth and widths."""
    if (spec.n_layers > MAX_LAYERS or spec.dims[0] > max_in
            or max(spec.dims[1:-1], default=0) > MAX_WIDTH
            or spec.dims[-1] > MAX_OUT):
        raise ValueError(f"{spec}: the kernels take at most {MAX_LAYERS} "
                         f"layers, an input <= {max_in}, hidden widths <= "
                         f"{MAX_WIDTH} and a last layer <= {MAX_OUT}")


def _validate(spec: ChainSpec, x, flat, g=None, max_in=MAX_IN):
    if not x.is_cuda:
        raise ValueError("the fused chain kernels take CUDA tensors")
    check_limits(spec, max_in)
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


def _pack(spec: ChainSpec, flat, transposed: bool = False, rounded: bool = True):
    """The weights in one buffer, in the order of ``_layout``'s offsets:
    rounded to the compute dtype or the f32 originals, as they are or each
    transposed."""
    ws = flat[:n_weights(spec)]
    if rounded:
        ws = [round_to(w, spec.compute_dtype) for w in ws]
    if transposed:
        ws = [w.t() for w in ws]
    return torch.cat([w.reshape(-1) for w in ws]).contiguous()


def _pack_biases(spec: ChainSpec, flat):
    return torch.cat([b.reshape(-1) for b in flat[n_weights(spec):]]).contiguous()


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
    _fwd_launch(lib, spec, x, _pack(spec, flat), _pack_biases(spec, flat), out, None)
    launches["chain_fwd"] += 1
    return out


def _bwd_data_launch(lib, spec, n, stash, WT, g, dx, gzs, dbar, dbp):
    meta, scales = _c_meta(spec)
    err = lib.nunerf_chain_bwd_data(
        stash.data_ptr(), WT.data_ptr(), g.data_ptr(), dx.data_ptr(),
        gzs.data_ptr(), dbar.data_ptr() if dbar is not None else None,
        dbp.data_ptr(), n, meta, scales, spec.n_layers, spec.dims[0],
        int(spec.compute_dtype == "bfloat16"), _stream())
    _check(lib, err, "chain_bwd_data")


def _dw(lib, h, gz, n, hi, w):
    """``h^T @ gz`` over ``n`` rows ([n, hi] and [n, w], contiguous): per-split
    partials from the kernel, summed here."""
    splits = max(1, min(128, -(-n // 512)))
    part = torch.empty((splits, hi, w), dtype=torch.float32, device=h.device)
    err = lib.nunerf_chain_dw(h.data_ptr(), gz.data_ptr(), part.data_ptr(), n,
                              hi, w, splits, _stream())
    _check(lib, err, "chain_dw")
    return part.sum(0)


def chain_bwd_cuda(spec: ChainSpec, x, g, flat):
    """K2: (dx [N, in_dim], (dW..., db...)) of ``sum(chain(x) * g)``.

    Pass 1 recomputes the forward into a scratch stash, pass 2 walks the
    layers down per row tile (dx, db partials, the rounded gz stash), pass 3
    forms each dW as per-split partials; the partials are summed here, as
    the JAX wrapper sums the Pallas kernel's per-tile partials."""
    _validate(spec, x, flat, g)
    x, g = x.contiguous(), g.contiguous()
    n, e = x.shape
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    _, _, wsum = _layout(spec)
    if n == 0:
        return (torch.zeros((0, e), **f32),
                tuple(torch.zeros(s, **f32) for s in flat_weight_shapes(spec))
                + tuple(torch.zeros((1, d), **f32) for d in spec.dims[1:]))
    lib = _lib()
    W = _pack(spec, flat)
    # f32 originals, as the TPU kernel's precomputed transposes
    WT = _pack(spec, flat, transposed=True, rounded=False)
    B = _pack_biases(spec, flat)
    stash = torch.empty(n * wsum, **f32)
    gzs = torch.empty(n * wsum, **f32)
    out = torch.empty((n, spec.dims[-1]), **f32)
    dx = torch.empty((n, e), **f32)
    n_blocks = -(-n // ROWS_PER_BLOCK)
    dbp = torch.empty((n_blocks, wsum), **f32)

    _fwd_launch(lib, spec, x, W, B, out, stash)
    _bwd_data_launch(lib, spec, n, stash, WT, g, dx, gzs, None, dbp)

    x0 = round_to(x, spec.compute_dtype).contiguous()
    dws, dbs, base = [], [], 0
    for l in range(spec.n_layers):
        i, w = spec.dims[l], spec.dims[l + 1]
        gz = gzs[n * base:n * (base + w)]
        h_prev = x0 if l == 0 else stash[n * (base - i):n * base]
        srcs = [(h_prev, i)] + ([(x0, e)] if spec.has_skip[l] else [])
        for h, hi in srcs:
            dws.append(_dw(lib, h, gz, n, hi, w))
        dbs.append(dbp[:, base:base + w].sum(0, keepdim=True))
        base += w
    launches["chain_bwd"] += 1
    return dx, tuple(dws) + tuple(dbs)


def _validate_jac(spec: ChainSpec, x, flat, gy=None, gj=None):
    _check_jac_spec(spec)
    _validate(spec, x, flat, gy, max_in=MAX_WIDTH)
    if gj is not None and (gj.shape != x.shape or gj.dtype != torch.float32
                           or gj.device != x.device):
        raise ValueError(f"Jacobian cotangent {tuple(gj.shape)} {gj.dtype}")


def _jac_down_launch(lib, spec, n, stash, WT, flat, j, qst):
    """The J-pass over ``n`` rows; the seed is read from the unrounded last
    W_h (and W_x on a last-layer skip)."""
    last = _layer_starts(spec)[-1]
    wl_h = flat[last].contiguous()
    wl_x = flat[last + 1].contiguous() if spec.has_skip[-1] else None
    meta, scales = _c_meta(spec)
    err = lib.nunerf_chain_jac_down(
        stash.data_ptr(), WT.data_ptr(), wl_h.data_ptr(),
        wl_x.data_ptr() if wl_x is not None else None, j.data_ptr(),
        qst.data_ptr() if qst is not None else None, n, meta, scales,
        spec.n_layers, spec.dims[0], int(spec.compute_dtype == "bfloat16"),
        _stream())
    _check(lib, err, "chain_jac_down")


def chain_jac_fwd_cuda(spec: ChainSpec, x, flat):
    """K4: ``(y [N, out_dim], j [N, in_dim])``, ``j = d y[:, 0] / dx``.

    Per chunk of rows: the K1 loop writes ``y`` and the activation stash,
    then the J-pass walks the layers down from the stash."""
    _validate_jac(spec, x, flat)
    x = x.contiguous()
    n, e = x.shape
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty((n, spec.dims[-1]), **f32)
    j = torch.empty((n, e), **f32)
    if n == 0:
        return y, j
    lib = _lib()
    W, B = _pack(spec, flat), _pack_biases(spec, flat)
    WT = _pack(spec, flat, transposed=True)
    _, _, wsum = _layout(spec)
    stash = torch.empty(min(n, JAC_CHUNK_ROWS) * wsum, **f32)
    for c0 in range(0, n, JAC_CHUNK_ROWS):
        c1 = min(n, c0 + JAC_CHUNK_ROWS)
        _fwd_launch(lib, spec, x[c0:c1], W, B, y[c0:c1], stash)
        _jac_down_launch(lib, spec, c1 - c0, stash, WT, flat, j[c0:c1], None)
    launches["chain_jac_fwd"] += 1
    return y, j


def chain_jac_bwd_cuda(spec: ChainSpec, x, gy, gj, flat):
    """K5: (dx, (dW..., db...)) of ``sum(y * gy) + sum(j * gj)``.

    Per chunk of rows: passes 1 and 2 recompute the forward and the J-pass
    into scratch stashes (h, q); pass 3 reverses the J-pass upwards (dbar,
    the rounded qbar, p over q); pass 4 is K2's data pass with
    ``zbar = hbar act' + dbar act''`` (dx, db partials, the rounded zs over
    dbar); every dW is ``h_prev^T zs + s qbar^T p``, and the J-pass's seed
    puts ``s_L * colsum(qbar_top)`` into column 0 of the last dW_h.  Partials
    are summed here; nothing is carried across blocks."""
    _validate_jac(spec, x, flat, gy, gj)
    x, gy, gj = x.contiguous(), gy.contiguous(), gj.contiguous()
    n, e = x.shape
    n_l = spec.n_layers
    f32 = dict(dtype=torch.float32, device=x.device)
    dws = [torch.zeros(s, **f32) for s in flat_weight_shapes(spec)]
    dbs = [torch.zeros((1, d), **f32) for d in spec.dims[1:]]
    dx = torch.empty((n, e), **f32)
    if n == 0:
        return dx, tuple(dws) + tuple(dbs)
    lib = _lib()
    W, B = _pack(spec, flat), _pack_biases(spec, flat)
    WT = _pack(spec, flat, transposed=True)
    _, _, wsum = _layout(spec)
    starts = _layer_starts(spec)
    x0 = round_to(x, spec.compute_dtype)
    gjr = round_to(gj, spec.compute_dtype)
    wtop = spec.dims[-2]
    rows = min(n, JAC_CHUNK_ROWS)
    stash, qst, dbar, qbs = (torch.empty(rows * wsum, **f32) for _ in range(4))
    y = torch.empty((rows, spec.dims[-1]), **f32)
    j = torch.empty((rows, e), **f32)
    meta, scales = _c_meta(spec)
    for c0 in range(0, n, JAC_CHUNK_ROWS):
        c1 = min(n, c0 + JAC_CHUNK_ROWS)
        nc = c1 - c0
        n_blocks = -(-nc // ROWS_PER_BLOCK)
        colp = torch.empty((n_blocks, wtop + e), **f32)
        dbp = torch.empty((n_blocks, wsum), **f32)
        _fwd_launch(lib, spec, x[c0:c1], W, B, y, stash)
        _jac_down_launch(lib, spec, nc, stash, WT, flat, j, qst)
        err = lib.nunerf_chain_jac_up(
            stash.data_ptr(), qst.data_ptr(), W.data_ptr(),
            gj[c0:c1].data_ptr(), dbar.data_ptr(), qbs.data_ptr(),
            colp.data_ptr(), nc, meta, scales, n_l, e,
            int(spec.compute_dtype == "bfloat16"), _stream())
        _check(lib, err, "chain_jac_up")
        _bwd_data_launch(lib, spec, nc, stash, WT, gy[c0:c1], dx[c0:c1], dbar,
                         dbar, dbp)

        x0c, gjc = x0[c0:c1].contiguous(), gjr[c0:c1].contiguous()
        col = colp.sum(0) * spec.scales[-1]
        base = 0
        for l in range(n_l):
            i, w = spec.dims[l], spec.dims[l + 1]
            s = spec.scales[l]
            zs = dbar[nc * base:nc * (base + w)]
            h_prev = x0c if l == 0 else stash[nc * (base - i):nc * base]
            dws[starts[l]] += _dw(lib, h_prev, zs, nc, i, w)
            if spec.has_skip[l]:
                dws[starts[l] + 1] += _dw(lib, x0c, zs, nc, e, w)
            if l < n_l - 1:
                p = qst[nc * base:nc * (base + w)]
                qbar = gjc if l == 0 else qbs[nc * (base - i):nc * base]
                dws[starts[l]] += s * _dw(lib, qbar, p, nc, i, w)
                if spec.has_skip[l]:
                    dws[starts[l] + 1] += s * _dw(lib, gjc, p, nc, e, w)
            else:
                dws[starts[l]][:, 0] += col[:wtop]
                if spec.has_skip[l]:
                    dws[starts[l] + 1][:, 0] += col[wtop:]
            dbs[l] += dbp[:, base:base + w].sum(0, keepdim=True)
            base += w
    launches["chain_jac_bwd"] += 1
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


class ChainMLPWithGrad0(torch.autograd.Function):
    """Forward K4, backward K5 from ``(gy, gj)``."""

    @staticmethod
    def forward(ctx, spec, x, *flat):
        ctx.spec = spec
        ctx.save_for_backward(x, *flat)
        return chain_jac_fwd_cuda(spec, x, flat)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gy, gj):
        x, *flat = ctx.saved_tensors
        dx, dflat = chain_jac_bwd_cuda(ctx.spec, x, gy.to(torch.float32),
                                       gj.to(torch.float32), flat)
        return (None, dx, *dflat)


def chain_mlp_with_grad0(spec: ChainSpec, x, *flat):
    """``(y, j)``: the chain over ``x`` [N, in_dim] and ``d y[:, 0] / dx``,
    both f32.  A CUDA tensor goes through K4/K5; a CPU tensor through
    ``chain_mlp_with_grad0_reference``."""
    if x.is_cuda:
        return ChainMLPWithGrad0.apply(spec, x, *flat)
    return chain_mlp_with_grad0_reference(spec, x, *flat)


def _env_flag(name: str) -> bool:
    v = os.environ.get(name)
    return v is not None and v not in ("0", "false", "")


def use_fused_mlp() -> bool:
    """Gate for K1/K2 on the NeRF++ trunk and the shading heads: opt-in by
    env NUNERF_FUSED_MLP=1 (or cfg ``fused_mlp``), off by default."""
    return _env_flag("NUNERF_FUSED_MLP")


def use_fused_sdf() -> bool:
    """Gate for K4/K5 on the SDF's value+feature+normal path: opt-in by env
    NUNERF_FUSED_SDF=1 (or cfg ``fused_sdf``), off by default."""
    return _env_flag("NUNERF_FUSED_SDF")


def use_fused_sdf_value(device) -> bool:
    """Gate for the fused forward on the value-only SDF path (sampling
    sweeps, occlusion march, init-SDF regulariser): on for a CUDA device,
    off on the CPU; env NUNERF_FUSED_SDF_VALUE=0/1 overrides (the kernels
    still run only on CUDA tensors)."""
    v = os.environ.get("NUNERF_FUSED_SDF_VALUE")
    if v is not None:
        return v not in ("0", "false", "")
    return torch.device(device).type == "cuda"
