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
* ``chain_hidden_cuda`` (K1 with its activation stash read back),
  ``relu_gates`` and ``chain_hidden_reference`` (the plain chain with every
  hidden activation, optionally at given relu gates) are what the card checks
  hold a relu chain's backward with: against autograd at the kernel's own
  gates, since a gate near 0 opens or closes with the order of the sums.
* ``data_pass_reference`` and ``data_pass_errors`` hold K2's bf16 data pass
  to f32 ``torch.matmul`` of its own stashes (``chain_bwd_cuda(keep=...)``);
  ``split_probe`` and ``split_probe_units`` hold it, on a case whose dx is
  exact in any order of the sums, to the f32 weights to the last bit.  The
  chain tolerance cannot tell the exact split of ``W^T`` from one with a
  piece dropped: the first sees a dropped ``mid``, the second a dropped
  ``lo`` too.
* ``launches`` counts kernel launches per wrapper: ``chain_fwd`` adds one
  per K1 launch, ``chain_bwd`` one per K2 call, ``chain_jac_fwd`` one per K4
  call and ``chain_jac_bwd`` one per K5 call.

Two routes, chosen by ``ChainSpec.compute_dtype`` alone (a CUDA tensor
launches its route's kernels or raises; neither falls back to the other):

* ``float32``: f32 FMA loops over f32 weights and f32 scratch stashes.  It is
  bound by the card's f32 rate without tensor cores; it is the exact route
  that small card steps are held against the CPU with, not the fast one.
* ``bfloat16``: every matrix operand is a bf16 value (weights rounded once
  by the packs, activations and cotangents rounded where the TPU kernel
  rounds them), so the products are exact in f32 and run on the tensor cores
  (f32 accumulation) in another summation order.  Every pass is ``wgmma``
  from shared memory over a persistent grid (``wgmma_grid``, ``tile_walk``).
  K1's forward, also pass 1 of K2, K4 and K5, streams its weights laid by
  ``pack_wgmma`` (``WgmmaLayout``: slices in a wgmma descriptor's swizzled
  layout, streamed by bulk copies, ``wgmma_plan``); it is bound by the
  softplus epilogue of every hidden output.  The backward passes (the data
  pass of K2 and K5, the J-pass of K4 and K5 and its reverse) walk the
  chain on the same skeleton with an epilogue a pass
  (``chain_bwd_wgmma_kernel``): the transposed walks stream
  ``pack_wgmma_t`` (``WgmmaTLayout``, ``bwd_walk``), the reverse J-pass the
  forward's pack.  What bounds K2 and K5 is not the matrix work but the
  scratch stashes that carry h, q, p, dbar, qbar and zs between the passes
  through device memory.  So the stashes are kept in the narrowest exact
  type (h, p, zs, qbar are bf16-exact and stored as bf16; q and dbar are
  unrounded and stay f32) in ``MmaLayout``'s padded layout, and all dW of a
  chunk come from one wgmma GEMM fed by TMA over a work table
  (``dw_work_table``, ``_dw_plan``), each tile summing both of K5's terms,
  with per-split partials reduced by one sum.  K2's data pass multiplies by
  the unrounded f32 ``W^T`` (as the TPU kernel does): each f32 weight is
  split into three bf16 pieces whose sum is the weight (``split_bf16``,
  ``pack_wgmma_t(split=True)``), three products a step into one f32
  accumulator, forming the products of the f32 ``W^T``.

Second-order differentiation through K1/K2 is not supported (as in the JAX
package): without ``fused_sdf`` the SDF's eikonal path runs the plain module.
"""

from __future__ import annotations

import ctypes
import os
from functools import lru_cache

import numpy as np
import torch

ACT_CODES = {"none": 0, "relu": 1, "softplus100": 2}
ROWS_PER_BLOCK = 64  # rows of a tile whose db (and column) partials a pass writes
MAX_WIDTH = 256      # widest hidden layer the kernels take (K4/K5: input too)
MAX_IN = 512         # widest input of K1/K2
MAX_OUT = 512        # widest last layer
MAX_LAYERS = 16
# K4/K5 keep scratch stashes of every layer's activation (K5 of the SDF chain:
# 36 KB a row on the f32 route, 32 KB on the bf16 route, see
# ``jac_bwd_scratch_bytes``): rows go through in chunks
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


def chain_hidden_reference(spec: ChainSpec, x, *flat, gates=None):
    """``(y, [h_1, ..., h_{L-1}])``: ``chain_mlp_reference`` with every hidden
    activation beside the output, for holding a kernel's stash and gates.

    A relu whose pre-activation lies within rounding of 0 opens or closes with
    the order of the sums, and an open or closed gate decides its unit's whole
    share of the row's gradients.  With ``gates`` (per layer a 0/1 tensor
    [N, w_l], None where the layer is no relu) a relu layer's output is
    ``z * gates[l]``: autograd then differentiates the chain at the gates
    given (a kernel's, see ``relu_gates``) instead of its own.  With the
    chain's own gates, or none, values and gradients are those of
    ``chain_mlp_reference``."""
    nw = n_weights(spec)
    weights, biases = flat[:nw], flat[nw:]
    cd = spec.compute_dtype
    starts = _layer_starts(spec)
    h = round_to(x.to(torch.float32), cd)
    x0 = h
    hidden = []
    for l in range(spec.n_layers):
        z = h @ round_to(weights[starts[l]], cd)
        if spec.has_skip[l]:
            z = z + x0 @ round_to(weights[starts[l] + 1], cd)
        if spec.scales[l] != 1.0:
            z = z * spec.scales[l]
        z = z + biases[l]
        if gates is not None and gates[l] is not None:
            h = z * gates[l]
        else:
            h = _act(spec.acts[l], z)
        if l < spec.n_layers - 1:
            h = round_to(h, cd)
            hidden.append(h)
    return h, hidden


def relu_gates(spec: ChainSpec, hidden, y):
    """Per layer the 0/1 gate of a relu layer read off its activation (the
    hidden layers' and, for a relu last layer, ``y``), None for other layers:
    the ``gates`` of ``chain_hidden_reference``."""
    return [(a > 0).to(torch.float32) if act == "relu" else None
            for act, a in zip(spec.acts, list(hidden) + [y])]


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

PAD = 16  # the bf16 route pads every width and depth to a multiple of this


def _pad(v: int) -> int:
    return -(-v // PAD) * PAD


class MmaLayout:
    """The bf16 route's padded layout of a chain.

    Every depth and width is padded with zeros to a multiple of 16 (the depth
    of a ``wgmma`` step), so the kernels never mask inside a k-step, and a
    stash row is a multiple of 32 bytes (a TMA box's row stride).
    ``layers[l]`` is ``(inp, outp, pwh, pwx, pstash)``: padded input and
    output widths, the element offsets of ``W_h`` [inp, outp] and ``W_x``
    [ep, outp] (-1: none) in ``pack_mma``'s buffer (the layout of the summed
    dW partials), and the sum of the padded output widths of
    the layers before (a layer's base in a stash is ``n * pstash``, its row
    stride ``outp``).  ``wtot``: elements of a pack; ``psum``: padded stash
    columns of all layers, ``psum_hidden`` of all but the last; ``ep``: the
    padded input width."""

    def __init__(self, spec: ChainSpec):
        self.ep = _pad(spec.dims[0])
        self.layers, off, sbase = [], 0, 0
        for l in range(spec.n_layers):
            ip, wp = _pad(spec.dims[l]), _pad(spec.dims[l + 1])
            pwh = off
            off += ip * wp
            pwx = -1
            if spec.has_skip[l]:
                pwx = off
                off += self.ep * wp
            self.layers.append((ip, wp, pwh, pwx, sbase))
            sbase += wp
        self.wtot = off
        self.psum = sbase
        self.psum_hidden = sbase - self.layers[-1][1]

    def weight_slots(self, spec: ChainSpec):
        """Per flat weight, in ``flat``'s order: (offset, padded rows, padded
        columns, rows, columns)."""
        slots = []
        for l, (ip, wp, pwh, pwx, _) in enumerate(self.layers):
            slots.append((pwh, ip, wp, spec.dims[l], spec.dims[l + 1]))
            if pwx >= 0:
                slots.append((pwx, self.ep, wp, spec.dims[0], spec.dims[l + 1]))
        return slots


@lru_cache(maxsize=None)
def mma_layout(spec: ChainSpec) -> MmaLayout:
    return MmaLayout(spec)


@lru_cache(maxsize=None)
def _layout(spec: ChainSpec):
    """(meta ints, scales, widths sum) for the C interface: per layer
    in, out, W_h offset, W_x offset (-1: none), their transposes' offsets,
    bias offset, activation code, stash column base, and the padded layout's
    W_h offset, W_x offset and stash column base (``MmaLayout``)."""
    meta, off, boff, sbase = [], 0, 0, 0
    e = spec.dims[0]
    lay = mma_layout(spec)
    for l in range(spec.n_layers):
        i, w = spec.dims[l], spec.dims[l + 1]
        wh = off
        off += i * w
        wx = -1
        if spec.has_skip[l]:
            wx = off
            off += e * w
        _, _, pwh, pwx, pstash = lay.layers[l]
        meta += [i, w, wh, wx, wh, wx, boff, ACT_CODES[spec.acts[l]], sbase,
                 pwh, pwx, pstash]
        boff += w
        sbase += w
    return tuple(meta), spec.scales, sbase


def _lib():
    from nunerf_tpu_torch.ops.cuda_build import load
    lib = load("fused_mlp")
    if not getattr(lib, "_nunerf_typed", False):
        vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        ip, fp = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float)
        lib.nunerf_chain_fwd.argtypes = [vp, vp, vp, vp, vp, ci, ip, fp, ci,
                                         ci, ci, ip, ci, vp]
        lib.nunerf_chain_bwd_data.argtypes = [vp, vp, vp, vp, vp, vp, vp, ci,
                                              ip, fp, ci, ci, vp]
        lib.nunerf_chain_jac_down.argtypes = [vp, vp, vp, vp, vp, vp, ci, ip,
                                              fp, ci, ci, vp]
        lib.nunerf_chain_jac_up.argtypes = [vp, vp, vp, vp, vp, vp, vp, ci, ip,
                                            fp, ci, ci, vp]
        lib.nunerf_chain_dw.argtypes = [vp, vp, vp, ci, ci, ci, ci, vp]
        lib.nunerf_chain_bwd_wgmma.argtypes = [ci, ci] + [vp] * 12 + [
            ci, ip, fp, ci, ci, ci, ci, ci, vp]
        lib.nunerf_chain_dw_wgmma.argtypes = [vp, vp, vp, ip, ci, vp, cl, ci, ci,
                                              ci, ci, ci, vp]
        for fn in (lib.nunerf_chain_fwd, lib.nunerf_chain_bwd_data,
                   lib.nunerf_chain_jac_down, lib.nunerf_chain_jac_up,
                   lib.nunerf_chain_dw, lib.nunerf_chain_bwd_wgmma,
                   lib.nunerf_chain_dw_wgmma):
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
    """Raise unless the kernels take the chain's depth and widths (the same
    limits on both routes: a chain beyond them raises, whatever its
    ``compute_dtype``).  Beside the widths, K1's bf16 forward needs room for
    two ring stages beside its operand tiles (``wgmma_stages``): a skip past
    the first layer with an input much wider than 300 leaves none."""
    if (spec.n_layers > MAX_LAYERS or spec.dims[0] > max_in
            or max(spec.dims[1:-1], default=0) > MAX_WIDTH
            or spec.dims[-1] > MAX_OUT):
        raise ValueError(f"{spec}: the kernels take at most {MAX_LAYERS} "
                         f"layers, an input <= {max_in}, hidden widths <= "
                         f"{MAX_WIDTH} and a last layer <= {MAX_OUT}")
    if wgmma_stages(spec) < 2:
        raise ValueError(f"{spec}: a skip past the first layer with an input "
                         f"{spec.dims[0]} wide leaves K1's bf16 forward no room "
                         "for two weight stages")


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


def _is_mma(spec: ChainSpec) -> bool:
    """The route is chosen by ``compute_dtype`` alone: bfloat16 takes the
    tensor-core kernels, float32 the f32 FMA kernels."""
    return spec.compute_dtype == "bfloat16"


def _pack(spec: ChainSpec, flat, transposed: bool = False, rounded: bool = True):
    """The weights in one f32 buffer, in the order of ``_layout``'s offsets:
    rounded to the compute dtype or the f32 originals, as they are or each
    transposed."""
    ws = flat[:n_weights(spec)]
    if rounded:
        ws = [round_to(w, spec.compute_dtype) for w in ws]
    if transposed:
        ws = [w.t() for w in ws]
    return torch.cat([w.reshape(-1) for w in ws]).contiguous()


def pack_mma(spec: ChainSpec, flat, transposed: bool = False):
    """The bf16 route's weight pack: every weight rounded to real
    ``torch.bfloat16`` (round to nearest even, as ``round_to``), zero-padded
    to ``MmaLayout``'s [inp, outp] and laid at its offset; with ``transposed``
    each matrix is stored as its transpose [outp, inp] at the same offset."""
    lay = mma_layout(spec)
    out = torch.zeros(lay.wtot, dtype=torch.bfloat16, device=flat[0].device)
    for w, (off, rp, cp, r, c) in zip(flat, lay.weight_slots(spec)):
        if transposed:
            out[off:off + rp * cp].view(cp, rp)[:c, :r].copy_(w.t())
        else:
            out[off:off + rp * cp].view(rp, cp)[:r, :c].copy_(w)
    return out


# ------------------------------------------- K1's bf16 forward: wgmma slices

WG_ROWS = 64     # rows of a tile: wgmma's M (WG_ROWS in csrc)
WG_PAIR = 128    # rows a CTA takes a turn: two tiles (WG_PAIR)
WG_KS = 64       # depth of a weight slice: one 128-byte swizzled row of bf16
WG_WIDTHS = (16, 32, 64, 128, 256)   # the wgmma widths the kernel is built for
WG_STAGE = 32768        # bytes of a ring stage: the widest slice (WG_STAGE)
WG_SLAB = 8192          # 64 rows x 64 bf16 of an operand tile (WG_SLAB)
WG_MAXST = 8            # the deepest ring (WG_MAXST)
WG_MAXSL = 256          # slices of one pass over a chain (WG_MAXSL)
WG_SMEM_MAX = 232448    # shared memory a block may take on the card


def wg_width(w: int) -> int:
    """The wgmma width at which a column block ``w`` wide is computed."""
    return next(v for v in WG_WIDTHS if v >= w)


def sw128_offset(c, k):
    """Byte of element (row ``c``, depth ``k``) in a slice: rows of 128
    bytes (64 bf16), 8-row atoms of 1024 bytes, and in each atom the 16-byte
    chunk ``k // 8`` of row ``c`` at chunk ``(k // 8) ^ (c % 8)`` (the 128-byte
    swizzle a wgmma descriptor of layout type 1 reads).  Numpy arrays too."""
    return ((c >> 3) * 1024 + (c & 7) * 128 + ((((k >> 3) ^ c) & 7) << 4)
            + (k & 7) * 2)


class WgmmaLayout:
    """The weight pack of K1's bf16 forward (``pack_wgmma``), stated once.

    A layer's columns go in blocks: one of ``wg_width(outp)`` columns for a
    hidden layer, blocks of 256 (the last one ``wg_width`` of the rest) for
    the last layer.  For every block, in order, the pack holds the slices of
    ``W_h`` (depth ``k0`` = 0, 64, ... below the padded depth ``inp``) and
    then, on a skip, those of ``W_x`` (below ``ep``); a slice holds
    ``W[k0 + k, c0 + c]`` for ``c`` below the block's width and ``k`` below
    64 at byte ``sw128_offset(c, k)``, zero outside the matrix.  The slices lie
    one after another in the order the kernel's products take them, so the
    kernel walks the pack with one bulk copy a slice.

    ``blocks[l]``: ``(c0, width)`` per block; ``slices``: ``(layer, block,
    part, k0, offset, bytes)``, part 'h' or 'x', offsets in bytes;
    ``nbytes``: the pack's size."""

    def __init__(self, spec: ChainSpec):
        lay = mma_layout(spec)
        self.ep = lay.ep
        self.blocks, self.slices, off = [], [], 0
        for l, (ip, wp, _, pwx, _) in enumerate(lay.layers):
            if l < spec.n_layers - 1:
                blocks = [(0, wg_width(wp))]
            else:
                blocks = [(c0, wg_width(min(MAX_WIDTH, wp - c0)))
                          for c0 in range(0, wp, MAX_WIDTH)]
            self.blocks.append(blocks)
            for b, (c0, w) in enumerate(blocks):
                parts = [("h", ip)] + ([("x", self.ep)] if pwx >= 0 else [])
                for part, depth in parts:
                    for k0 in range(0, depth, WG_KS):
                        self.slices.append((l, b, part, k0, off, w * 2 * WG_KS))
                        off += w * 2 * WG_KS
        self.nbytes = off


@lru_cache(maxsize=None)
def wgmma_layout(spec: ChainSpec) -> WgmmaLayout:
    return WgmmaLayout(spec)


def _wgmma_positions(spec: ChainSpec):
    """Per flat weight [rows, columns], the bf16 element of the pack that
    holds each of its entries (int64 numpy)."""
    lay = wgmma_layout(spec)
    starts = _layer_starts(spec)
    pos = [np.empty(s, np.int64) for s in flat_weight_shapes(spec)]
    for l, b, part, k0, off, nbytes in lay.slices:
        slot = starts[l] + (1 if part == "x" else 0)
        rows, cols = pos[slot].shape
        c0, w = lay.blocks[l][b]
        k = np.arange(k0, min(rows, k0 + WG_KS))[:, None]
        c = np.arange(c0, min(cols, c0 + w))[None, :]
        pos[slot][k, c] = (off + sw128_offset(c - c0, k - k0)) // 2
    return pos


@lru_cache(maxsize=64)
def _wgmma_index(spec: ChainSpec, device):
    """Where each bf16 element of ``pack_wgmma``'s buffer comes from: an
    index into the flat weights concatenated, one past their end (a zero)
    for every pad.  It depends on the chain alone: built once, kept on the
    device."""
    pos = _wgmma_positions(spec)
    wsum = sum(p.size for p in pos)
    idx = np.full(wgmma_layout(spec).nbytes // 2, wsum, np.int64)
    idx[np.concatenate([p.reshape(-1) for p in pos])] = np.arange(wsum)
    return torch.as_tensor(idx, device=device)


def pack_wgmma(spec: ChainSpec, flat):
    """K1's bf16 weight pack (``WgmmaLayout``): every weight rounded to real
    ``torch.bfloat16`` (round to nearest even, as ``pack_mma``) and laid in
    its slices.  One cast and one gather."""
    ws = flat[:n_weights(spec)]
    dev = ws[0].device
    w = torch.cat([t.reshape(-1).to(torch.float32) for t in ws]
                  + [torch.zeros(1, device=dev)]).to(torch.bfloat16)
    return w[_wgmma_index(spec, dev)]


def unpack_wgmma(spec: ChainSpec, buf):
    """Per flat weight, its [rows, columns] entries read back from a
    ``pack_wgmma`` buffer: the inverse of the pack."""
    return [buf[torch.as_tensor(p, device=buf.device)] for p in _wgmma_positions(spec)]


def wgmma_grid(n: int, sms: int) -> int:
    """CTAs of K1's bf16 forward over ``n`` rows: one an SM, at most one a
    128-row tile pair."""
    return max(1, min(sms, -(-n // WG_PAIR)))


def tile_walk(n: int, grid: int):
    """The rows each tile takes, as the kernel walks them: ``[(cta, tile,
    turn, first row, end row)]``, rows clipped to ``n`` (a tile's two
    warpgroups take half its columns each).  Turn k of CTA b takes tile pair
    b + k * grid."""
    pairs = -(-n // WG_PAIR)
    out = []
    for cta in range(grid):
        for k in range(-(-(pairs - cta) // grid)):
            for wg in range(2):
                r0 = (cta + k * grid) * WG_PAIR + wg * WG_ROWS
                out.append((cta, wg, k, min(r0, n), min(r0 + WG_ROWS, n)))
    return out


def wgmma_plan(spec: ChainSpec, n: int, sms: int):
    """The ints ``nunerf_chain_fwd`` takes on the bf16 route: the grid, the
    number of slices, per layer the widths of its two column blocks (0:
    none), and the bytes of every slice, which the kernel hands to the full
    barrier as it starts the slice's copy."""
    lay = wgmma_layout(spec)
    widths = []
    for blocks in lay.blocks:
        widths += [w for _, w in blocks] + [0] * (2 - len(blocks))
    return ([wgmma_grid(n, sms), len(lay.slices)] + widths
            + [nbytes for *_, nbytes in lay.slices])


def wgmma_stages(spec: ChainSpec) -> int:
    """Ring stages K1's bf16 forward has room for (``build_wg_plan``): the
    shared memory a block may take less the two tiles' operand tiles
    (x0's and the activations' in 64-wide slabs of 8 KB, one tile where no
    layer past the first reads x0), the biases (each layer's as wide as its
    blocks) and the ring's bookkeeping, at most ``WG_MAXST``.  Below 2 the kernel
    cannot take the chain."""
    lay = wgmma_layout(spec)
    xs = -(-lay.ep // 64)
    hs = -(-max([blocks[0][1] for blocks in lay.blocks[:-1]], default=0) // 64)
    tile = WG_SLAB * (max(xs, hs) if not any(spec.has_skip[1:]) else xs + hs)
    bwsum = sum(w for blocks in lay.blocks for _, w in blocks)
    fixed = 1024 + 2 * tile + 4 * bwsum + 12 * WG_MAXST + 8 * WG_MAXSL
    return min(WG_MAXST, (WG_SMEM_MAX - fixed) // WG_STAGE)


@lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# ------------------- the backward passes on the bf16 route: wgmma chain walks

# the passes of ``chain_bwd_wgmma_kernel`` (BW_* in csrc/fused_mlp.cu)
BW_DATA, BW_JDOWN, BW_JUP = 0, 1, 2
SPLIT_PIECES = (2, 1, 0)   # a split slice triple: lo, mid, hi of ``split_bf16``


class WgmmaTLayout:
    """The weight pack of the backward passes' transposed walks
    (``pack_wgmma_t``): the data pass of K2 and K5 and the J-pass of K4/K5.

    The data pass walks the layers from the last down, the J-pass from the
    last hidden layer down.  At each layer the product with ``W_x^T`` of a
    skip comes first (into dx or j), then the one with ``W_h^T`` (into the
    layer below, or at layer 0 into dx or j).  A product's depth is the
    layer's padded output width ``outp``.  Its columns are the weight's
    rows: one block of ``wg_width(inp)`` for a hidden ``W_h^T``, blocks of
    256 (the last one ``wg_width`` of the rest) for a product into dx or j,
    ``ep`` wide.  For every block, in order, the pack holds the slices of the
    64-deep steps ``k0`` below ``outp``, each ``pieces`` times (K2: the lo,
    mid and hi of ``split_bf16``, small pieces first; K4/K5: the rounded
    weight).  A slice holds ``W[c0 + c, k0 + k]`` at byte ``sw128_offset(c,
    k)``, the layout of ``WgmmaLayout``'s slices for the transposed matrix,
    and zeros outside the matrix.

    ``steps``: ``(layer, part, c0, width, out)``, part 'h' or 'x', ``out``
    True for a product into dx or j; ``slices``: ``(step, k0, piece, offset,
    bytes)``, piece an index into ``split_bf16``'s three (0 for the rounded
    weight); ``nbytes``; ``jac_slice`` and ``jac_offset``: the first slice of
    the J-pass's walk (the layers below the last) and its byte offset."""

    def __init__(self, spec: ChainSpec, split: bool):
        lay = mma_layout(spec)
        pieces = SPLIT_PIECES if split else (0,)
        self.steps, self.slices, off = [], [], 0
        self.jac_slice = self.jac_offset = None
        for l in reversed(range(spec.n_layers)):
            ip, wp, _, pwx, _ = lay.layers[l]
            if l < spec.n_layers - 1 and self.jac_slice is None:
                self.jac_slice, self.jac_offset = len(self.slices), off
            parts = ([("x", lay.ep, True)] if pwx >= 0 else []) + [("h", ip, l == 0)]
            for part, rows, out in parts:
                blocks = ([(c0, wg_width(min(MAX_WIDTH, rows - c0)))
                           for c0 in range(0, rows, MAX_WIDTH)] if out
                          else [(0, wg_width(rows))])
                for c0, w in blocks:
                    self.steps.append((l, part, c0, w, out))
                    for k0 in range(0, wp, WG_KS):
                        for piece in pieces:
                            self.slices.append((len(self.steps) - 1, k0, piece, off,
                                                w * 2 * WG_KS))
                            off += w * 2 * WG_KS
        self.nbytes = off


@lru_cache(maxsize=None)
def wgmma_t_layout(spec: ChainSpec, split: bool) -> WgmmaTLayout:
    return WgmmaTLayout(spec, split)


def _wgmma_t_positions(spec: ChainSpec, split: bool):
    """Per piece (``split_bf16``'s index, 0 alone without the split) and flat
    weight [rows, columns], the bf16 element of ``pack_wgmma_t``'s buffer
    that holds each entry (int64 numpy)."""
    lay = wgmma_t_layout(spec, split)
    starts = _layer_starts(spec)
    shapes = flat_weight_shapes(spec)
    pos = {p: [np.empty(s, np.int64) for s in shapes]
           for p in (SPLIT_PIECES if split else (0,))}
    for si, k0, piece, off, _ in lay.slices:
        l, part, c0, w, _ = lay.steps[si]
        slot = starts[l] + (1 if part == "x" else 0)
        rows, cols = shapes[slot]
        c = np.arange(c0, min(rows, c0 + w))[:, None]
        k = np.arange(k0, min(cols, k0 + WG_KS))[None, :]
        pos[piece][slot][c, k] = (off + sw128_offset(c - c0, k - k0)) // 2
    return pos


@lru_cache(maxsize=64)
def _wgmma_t_index(spec: ChainSpec, split: bool, device):
    """Where each element of ``pack_wgmma_t``'s buffer comes from: an index
    into the pieces of the flat weights concatenated, ``[pieces, wsum + 1]``
    flattened (the last column a zero for the pads).  Built once a chain,
    kept on the device."""
    pos = _wgmma_t_positions(spec, split)
    wsum = sum(a * b for a, b in flat_weight_shapes(spec))
    idx = np.full(wgmma_t_layout(spec, split).nbytes // 2, wsum, np.int64)
    for piece, per_weight in pos.items():
        idx[np.concatenate([p.reshape(-1) for p in per_weight])] = (
            piece * (wsum + 1) + np.arange(wsum))
    return torch.as_tensor(idx, device=device)


def pack_wgmma_t(spec: ChainSpec, flat, split: bool):
    """The transposed walks' weight pack (``WgmmaTLayout``): with ``split``
    (K2's data pass) the f32 weights' three bf16 pieces (``split_bf16``),
    else (K4/K5) every weight rounded to bf16 as ``pack_wgmma`` rounds it.
    One cast or split, and one gather."""
    ws = flat[:n_weights(spec)]
    dev = ws[0].device
    w = torch.cat([t.reshape(-1).to(torch.float32) for t in ws]
                  + [torch.zeros(1, device=dev)])
    src = torch.stack(split_bf16(w)).view(-1) if split else w.to(torch.bfloat16)
    return src[_wgmma_t_index(spec, split, dev)]


def unpack_wgmma_t(spec: ChainSpec, buf, split: bool):
    """Per flat weight, f32 ``[pieces, rows, columns]`` read back from a
    ``pack_wgmma_t`` buffer (the pieces in ``split_bf16``'s order): the
    inverse of the pack."""
    pos = _wgmma_t_positions(spec, split)
    out = []
    for slot in range(n_weights(spec)):
        out.append(torch.stack([buf[torch.as_tensor(pos[p][slot], device=buf.device)].float()
                                for p in sorted(pos)]))
    return out


def bwd_walk(spec: ChainSpec, pas: int, split: bool = False):
    """``(slices, bytes, byte offset)`` of the walk of pass ``pas`` (BW_*)
    in its pack: the data pass ``pack_wgmma_t`` whole (``split``: K2's, else
    K5's), the J-pass the rounded ``pack_wgmma_t`` from its ``jac_offset``,
    the J-pass's reverse the slices of ``pack_wgmma`` (the forward's walk) of
    every layer but the last.  The kernel builds the same walk from the chain
    and refuses a launch whose counts differ from these."""
    if pas == BW_JUP:
        sl = [s for s in wgmma_layout(spec).slices if s[0] < spec.n_layers - 1]
        return len(sl), sum(s[-1] for s in sl), 0
    lay = wgmma_t_layout(spec, split)
    first, off = (0, 0) if pas == BW_DATA else (lay.jac_slice, lay.jac_offset)
    return len(lay.slices) - first, lay.nbytes - off, off


def split_bf16(w):
    """``(hi, mid, lo)``, three bf16 tensors with ``hi + mid + lo == w``: hi =
    bf16(w), mid = bf16(w - hi), lo = bf16(w - hi - mid), each residual
    formed exactly in f32.  A 24-bit significand goes into three 8-bit ones,
    and bf16 has f32's exponent range, so the sum is ``w`` for every finite
    ``|w| >= 2**-110`` below bf16's largest value; under 2**-110 the last bits
    fall under bf16's subnormal grain and the sum is within 2**-134 of ``w``."""
    w = w.to(torch.float32)
    hi = w.to(torch.bfloat16)
    r = w - hi.float()
    mid = r.to(torch.bfloat16)
    lo = (r - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def unpack_mma(spec: ChainSpec, buf):
    """Per flat weight, the [rows, columns] view of its slot in a buffer laid
    out as ``pack_mma`` lays the weights (a pack, or summed dW partials)."""
    return [buf[off:off + rp * cp].view(rp, cp)[:r, :c]
            for off, rp, cp, r, c in mma_layout(spec).weight_slots(spec)]


def _pad_bf16(t, width: int):
    """[n, width] bf16: ``t`` rounded, zero columns on the right."""
    out = torch.zeros((t.shape[0], width), dtype=torch.bfloat16, device=t.device)
    out[:, :t.shape[1]].copy_(t)
    return out


def _pack_biases(spec: ChainSpec, flat):
    return torch.cat([b.reshape(-1) for b in flat[n_weights(spec):]]).contiguous()


def _c_meta(spec):
    meta, scales, _ = _layout(spec)
    return ((ctypes.c_int * len(meta))(*meta),
            (ctypes.c_float * len(scales))(*scales))


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _ptr(t):
    return t.data_ptr() if t is not None and t.numel() else None


def _fwd_launch(lib, spec, x, W, B, out, stash):
    """The K1 loop.  ``W``: ``_pack`` (f32 route) or ``pack_wgmma`` (bf16
    route); ``stash`` likewise f32 in ``_layout``'s columns, or bf16 in
    ``MmaLayout``'s and without the last layer."""
    meta, scales = _c_meta(spec)
    plan, nplan = None, 0
    if _is_mma(spec):
        ints = wgmma_plan(spec, x.shape[0], _sm_count(x.device.index or 0))
        plan, nplan = (ctypes.c_int * len(ints))(*ints), len(ints)
    err = lib.nunerf_chain_fwd(
        x.data_ptr(), W.data_ptr(), B.data_ptr(), out.data_ptr(), _ptr(stash),
        x.shape[0], meta, scales, spec.n_layers, spec.dims[0],
        int(_is_mma(spec)), plan, nplan, _stream())
    _check(lib, err, "chain_fwd")


def _fwd_pack(spec: ChainSpec, flat):
    """The forward's weights in the route's packing."""
    return pack_wgmma(spec, flat) if _is_mma(spec) else _pack(spec, flat)


def chain_fwd_cuda(spec: ChainSpec, x, flat):
    """K1: the chain over ``x`` [N, in_dim] -> f32 [N, out_dim]."""
    _validate(spec, x, flat)
    x = x.contiguous()
    n = x.shape[0]
    out = torch.empty((n, spec.dims[-1]), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    lib = _lib()
    _fwd_launch(lib, spec, x, _fwd_pack(spec, flat), _pack_biases(spec, flat), out, None)
    launches["chain_fwd"] += 1
    return out


def chain_hidden_cuda(spec: ChainSpec, x, flat):
    """K1 with its activation stash read back: ``(y, [h_1, ..., h_{L-1}])``,
    each f32 [N, w_l]: the stash from which K2, K4 and K5 take ``act'`` (pass
    1 of each is this launch on the same inputs).  For holding the kernels'
    hidden activations and relu gates against the plain version's."""
    _validate(spec, x, flat)
    x = x.contiguous()
    n = x.shape[0]
    out = torch.empty((n, spec.dims[-1]), dtype=torch.float32, device=x.device)
    if n == 0:
        return out, [out.new_empty((0, w)) for w in spec.dims[1:-1]]
    lib = _lib()
    B = _pack_biases(spec, flat)
    if _is_mma(spec):
        lay = mma_layout(spec)
        stash = torch.empty(n * lay.psum_hidden, dtype=torch.bfloat16, device=x.device)
        _fwd_launch(lib, spec, x, pack_wgmma(spec, flat), B, out, stash)
        hidden = [stash[n * base:n * (base + wp)].view(n, wp)[:, :spec.dims[l + 1]].float()
                  for l, (_, wp, _, _, base) in enumerate(lay.layers[:-1])]
    else:
        stash = torch.empty(n * _layout(spec)[2], dtype=torch.float32, device=x.device)
        _fwd_launch(lib, spec, x, _pack(spec, flat), B, out, stash)
        hidden, base = [], 0
        for w in spec.dims[1:-1]:
            hidden.append(stash[n * base:n * (base + w)].view(n, w))
            base += w
    launches["chain_fwd"] += 1
    return out, hidden


def _bwd_data_launch(lib, spec, n, stash, WT, g, dx, gzs, dbar, dbp):
    """The f32 route's data pass (K2's without dbar, K5's with it)."""
    meta, scales = _c_meta(spec)
    err = lib.nunerf_chain_bwd_data(
        _ptr(stash), WT.data_ptr(), g.data_ptr(), dx.data_ptr(),
        gzs.data_ptr(), _ptr(dbar), dbp.data_ptr(), n, meta, scales,
        spec.n_layers, spec.dims[0], _stream())
    _check(lib, err, "chain_bwd_data")


def _dw(lib, h, gz, n, hi, w):
    """``h^T @ gz`` over ``n`` rows ([n, hi] and [n, w], contiguous, f32):
    per-split partials from the f32 kernel, summed here."""
    splits = max(1, min(128, -(-n // 512)))
    part = torch.empty((splits, hi, w), dtype=torch.float32, device=h.device)
    err = lib.nunerf_chain_dw(h.data_ptr(), gz.data_ptr(), part.data_ptr(), n,
                              hi, w, splits, _stream())
    _check(lib, err, "chain_dw")
    return part.sum(0)


DW_TILE = 128  # a dW work item's output tile edge (two 64-wide TMA boxes)


def dw_work_table(spec: ChainSpec, jac: bool):
    """The grouped dW launch's work, one entry an output tile (a block per
    entry and row split).  Entry: ``(slot, i0, mext, c0, next, a1, b1, a2, b2,
    scale)``: the tile [i0:i0+mext, c0:c0+next] of flat weight ``slot``'s
    padded [inp, outp] matrix is ``a1^T b1 + scale * a2^T b2`` over the rows.
    An operand is ``(name, layer)``: 'x0' and 'gj' (the rounded input and its
    cotangent, [n, ep]) or a stash's layer, 'h', 'zs', 'qbar', 'p' ([n,
    outp]).  ``jac`` (K5) adds the J-pass's term ``s_l qbar_{l-1}^T p_l`` to
    every layer but the last (whose column 0 gets the seed's share outside);
    without it (K2) ``a2`` is None."""
    lay = mma_layout(spec)
    table, slot = [], 0
    for l, (ip, wp, _, pwx, _) in enumerate(lay.layers):
        second = jac and l < spec.n_layers - 1
        srcs = [(("x0", None) if l == 0 else ("h", l - 1),
                 ("gj", None) if l == 0 else ("qbar", l - 1), ip)]
        if pwx >= 0:
            srcs.append((("x0", None), ("gj", None), lay.ep))
        for a1, a2, rows in srcs:
            for i0 in range(0, rows, DW_TILE):
                for c0 in range(0, wp, DW_TILE):
                    table.append((slot, i0, min(DW_TILE, rows - i0), c0,
                                  min(DW_TILE, wp - c0), a1, ("zs", l),
                                  a2 if second else None,
                                  ("p", l) if second else None,
                                  spec.scales[l] if second else 0.0))
            slot += 1
    return table


DW_ROW = 12       # ints a row of the dW launch's table (DW_ROWW in csrc)
DW_MAXMAPS = 64   # tensor maps a dW launch takes (DW_MAXMAPS)


def dw_splits(n: int, ntiles: int):
    """``(splits, rows a split)`` of the dW launch over ``n`` rows: about
    four work items an SM of the card (132 SMs) and at least 512 rows a
    split, the rows a multiple of 64 (the depth of a TMA box)."""
    splits = max(1, min(-(-n // 512), -(-528 // ntiles)))
    rps = -(-(-(-n // splits)) // 64) * 64
    return -(-n // rps), rps


def dw_work(ntiles: int, splits: int, grid: int):
    """The work items each persistent CTA of the dW launch takes, as the
    kernel walks them: ``[(cta, tile, split)]``, item w being tile ``w %
    ntiles`` of split ``w // ntiles`` and CTA b taking w = b, b + grid, ..."""
    return [(cta, w % ntiles, w // ntiles)
            for cta in range(grid) for w in range(cta, ntiles * splits, grid)]


@lru_cache(maxsize=64)
def _dw_plan(spec: ChainSpec, n: int, jac: bool, device):
    """The grouped dW launch over ``n`` rows: the work table on the device,
    the tensor maps it names and the row splits.  A table row a tile,
    ``DW_ROW`` int32: for a1, b1, a2, b2 the index of its operand's map
    (-1: none) and the tile's first column in it; the tile's offset in a
    split's partials, their row stride, the tile's extents.  A map is an
    operand's stash layer ``(name, first element, width)``: 'x0' and 'gj'
    ([n, ep]) or a stash's layer ([n, outp] at ``n * pstash``).  It depends
    on the chain and ``n`` alone (the buffers' addresses go in at the
    launch), so it is built and copied to the device once."""
    lay = mma_layout(spec)
    slots = lay.weight_slots(spec)
    work = dw_work_table(spec, jac)
    maps = []

    def operand(op, col):
        if op is None:
            return [-1, 0]
        name, l = op
        m = (name, 0, lay.ep) if l is None else (name, n * lay.layers[l][4],
                                                 lay.layers[l][1])
        if m not in maps:
            maps.append(m)
        return [maps.index(m), col]

    rows, tile_scales = [], []
    for slot, i0, mext, c0, next_, a1, b1, a2, b2, scale in work:
        off, _, cp, _, _ = slots[slot]
        rows.append(operand(a1, i0) + operand(b1, c0) + operand(a2, i0)
                    + operand(b2, c0) + [off + i0 * cp + c0, cp, mext, next_])
        tile_scales.append(scale)
    if len(maps) > DW_MAXMAPS:
        raise ValueError(f"{spec}: {len(maps)} stash layers, the dW launch takes "
                         f"{DW_MAXMAPS}")
    splits, rps = dw_splits(n, len(work))
    return dict(table=torch.tensor(rows, dtype=torch.int32, device=device),
                scales=torch.tensor(tile_scales, dtype=torch.float32, device=device),
                maps=maps, wtot=lay.wtot, ntiles=len(work), n=n, splits=splits,
                rps=rps)


def _dw_grouped(lib, spec: ChainSpec, n: int, bufs: dict, jac: bool):
    """Every dW of the chain over ``n`` rows in one launch: [wtot] f32 in
    ``pack_mma``'s layout.  ``bufs`` maps an operand name to its bf16 buffer
    ('x0', 'gj': [n, ep]; stashes: ``MmaLayout`` columns).  The kernel writes
    per-split partials; one sum over the splits reduces all layers."""
    dev = bufs["zs"].device
    plan = _dw_plan(spec, n, jac, dev)
    part = torch.empty((plan["splits"], plan["wtot"]), dtype=torch.float32, device=dev)
    k = len(plan["maps"])
    ptrs = (ctypes.c_void_p * k)(*[bufs[name].data_ptr() + 2 * first
                                   for name, first, _ in plan["maps"]])
    widths = (ctypes.c_int * k)(*[w for *_, w in plan["maps"]])
    nwork = plan["ntiles"] * plan["splits"]
    err = lib.nunerf_chain_dw_wgmma(
        plan["table"].data_ptr(), plan["scales"].data_ptr(), ptrs, widths, k,
        part.data_ptr(), plan["wtot"], plan["ntiles"], n, plan["splits"],
        plan["rps"], min(nwork, _sm_count(dev.index or 0)), _stream())
    _check(lib, err, "chain_dw_wgmma")
    return part.sum(0)


def _bwd_walk_launch(lib, spec: ChainSpec, pas: int, n: int, W, split=False,
                     g=None, ylast=None, h=None, out=None, zst=None, dbar=None,
                     q=None, dbo=None, part=None, wl_h=None, wl_x=None):
    """One backward walk of the bf16 route (``chain_bwd_wgmma_kernel``, pass
    ``pas``) over ``n`` rows: W is the pass's pack (``bwd_walk``), ``zst`` the
    stash its tile goes to (the data pass's zs, K5's J-pass's p, the reverse
    J-pass's qbar)."""
    nsl, nbytes, off = bwd_walk(spec, pas, split)
    meta, scales = _c_meta(spec)
    grid = wgmma_grid(n, _sm_count(W.device.index or 0))
    err = lib.nunerf_chain_bwd_wgmma(
        pas, int(split), W.data_ptr() + off, _ptr(g), _ptr(ylast), _ptr(h),
        _ptr(out), _ptr(zst), _ptr(dbar), _ptr(q), _ptr(dbo), _ptr(part),
        _ptr(wl_h), _ptr(wl_x), n, meta, scales, spec.n_layers,
        spec.dims[0], grid, nsl, nbytes, _stream())
    _check(lib, err, ("chain_bwd_data", "chain_jac_down", "chain_jac_up")[pas])


def _stash_layers(spec: ChainSpec, buf, n, layers):
    """The f32 [n, w_l] views of the given layers of a bf16 stash laid out as
    ``MmaLayout`` (layer base ``n * pstash``, row stride ``outp``)."""
    lay = mma_layout(spec)
    return [buf[n * lay.layers[l][4]:n * (lay.layers[l][4] + lay.layers[l][1])]
            .view(n, lay.layers[l][1])[:, :spec.dims[l + 1]].float() for l in layers]


def chain_bwd_cuda(spec: ChainSpec, x, g, flat, keep: dict = None):
    """K2: (dx [N, in_dim], (dW..., db...)) of ``sum(chain(x) * g)``.

    Pass 1 recomputes the forward into a scratch stash, pass 2 walks the
    layers down per row tile (dx, db partials, the rounded gz stash), pass 3
    forms each dW as per-split partials; the partials are summed here, as
    the JAX wrapper sums the Pallas kernel's per-tile partials.  On the bf16
    route all three run on the tensor cores (bf16 stashes, pass 2 on the split
    pack of the f32 ``W^T``, one dW launch).

    ``keep``, a dict, receives on the bf16 route what the data pass worked
    from and wrote, for holding it to f32 products (``data_pass_reference``):
    ``"y"`` (the forward's f32 output), ``"hidden"`` (the activation stash)
    and ``"gzs"`` (every layer's rounded, scaled gz), each f32 [N, w_l]."""
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
    B = _pack_biases(spec, flat)
    out = torch.empty((n, spec.dims[-1]), **f32)
    dx = torch.empty((n, e), **f32)
    n_blocks = -(-n // ROWS_PER_BLOCK)
    dbp = torch.empty((n_blocks, wsum), **f32)
    if _is_mma(spec):
        lay = mma_layout(spec)
        bf = dict(dtype=torch.bfloat16, device=dev)
        stash = torch.empty(n * lay.psum_hidden, **bf)
        gzs = torch.empty(n * lay.psum, **bf)
        _fwd_launch(lib, spec, x, pack_wgmma(spec, flat), B, out, stash)
        _bwd_walk_launch(lib, spec, BW_DATA, n, pack_wgmma_t(spec, flat, split=True),
                         split=True, g=g, ylast=out, h=stash, out=dx, zst=gzs,
                         part=dbp)
        dw = _dw_grouped(lib, spec, n, {"x0": _pad_bf16(x, lay.ep), "h": stash,
                                        "zs": gzs}, jac=False)
        dws = [d.contiguous() for d in unpack_mma(spec, dw)]
        if keep is not None:
            n_l = spec.n_layers
            keep.update(y=out, hidden=_stash_layers(spec, stash, n, range(n_l - 1)),
                        gzs=_stash_layers(spec, gzs, n, range(n_l)))
    else:
        # f32 originals, as the TPU kernel's precomputed transposes
        WT = _pack(spec, flat, transposed=True, rounded=False)
        stash = torch.empty(n * wsum, **f32)
        gzs = torch.empty(n * wsum, **f32)
        _fwd_launch(lib, spec, x, _pack(spec, flat), B, out, stash)
        _bwd_data_launch(lib, spec, n, stash, WT, g, dx, gzs, None, dbp)
        x0 = x
        dws, base = [], 0
        for l in range(spec.n_layers):
            i, w = spec.dims[l], spec.dims[l + 1]
            gz = gzs[n * base:n * (base + w)]
            h_prev = x0 if l == 0 else stash[n * (base - i):n * base]
            srcs = [(h_prev, i)] + ([(x0, e)] if spec.has_skip[l] else [])
            for h, hi in srcs:
                dws.append(_dw(lib, h, gz, n, hi, w))
            base += w
    db = dbp.sum(0)
    dbs, base = [], 0
    for w in spec.dims[1:]:
        dbs.append(db[base:base + w].reshape(1, w))
        base += w
    launches["chain_bwd"] += 1
    return dx, tuple(dws) + tuple(dbs)


def data_pass_reference(spec: ChainSpec, g, flat, kept):
    """K2's data pass in f32 ``torch.matmul`` from the kernel's own stashes
    (``chain_bwd_cuda(keep=...)``): ``(dx, [gzs_0, ..., gzs_{L-1}])``.

    ``dx`` is the sum over the layers fed by x0 (layer 0 and the skips) of
    ``gzs_l @ W^T`` with the unrounded f32 weights; ``gzs_{l-1}`` is
    ``round(gzs_l @ W_h^T * act'(a_{l-1}) * s_{l-1})`` and the top one
    ``round(g * act'(y) * s_L)``.  Every product reads the kernel's rounded gz,
    so the gates and roundings are the kernel's and what is left to compare
    is the order of the f32 sums: that holds the split of ``W^T`` in the
    kernel to the f32 weights."""
    nw = n_weights(spec)
    weights = flat[:nw]
    starts = _layer_starts(spec)
    n_l = spec.n_layers
    acts = list(kept["hidden"]) + [kept["y"]]
    gzs, dx = [None] * n_l, 0.0
    v = g * _act_grad_from_a(spec.acts[-1], kept["y"])
    for l in reversed(range(n_l)):
        gzs[l] = round_to(v * spec.scales[l] if spec.scales[l] != 1.0 else v,
                          spec.compute_dtype)
        z = kept["gzs"][l]
        if spec.has_skip[l]:
            dx = dx + z @ weights[starts[l] + 1].t()
        gh = z @ weights[starts[l]].t()
        if l == 0:
            dx = dx + gh
        else:
            v = gh * _act_grad_from_a(spec.acts[l - 1], acts[l - 1])
    return dx, gzs


def data_pass_errors(spec: ChainSpec, g, flat, kept, dx):
    """K2's data pass held to ``data_pass_reference`` on its own stashes:
    ``(dx_err, gzs_ulps)``.  ``dx_err``: the largest error of ``dx`` relative
    to the largest magnitude of the f32 products.  ``gzs_ulps``: over every
    layer's rounded gz, the largest ``|gzs - ref| - 1e-5 max|ref|`` in units
    of bf16's last place at ``ref`` (the 1e-5 allows for the order of the f32
    sums where a value cancels to near 0): one unit when a rounding went the
    other way, 0 when none did."""
    dx_ref, gzs_ref = data_pass_reference(spec, g, flat, kept)
    dx_err = float((dx - dx_ref).abs().max() / (dx_ref.abs().max() + 1e-30))
    ulps = 0.0
    for a, e in zip(kept["gzs"], gzs_ref):
        ulp = 2.0 ** (torch.floor(torch.log2(e.abs().clamp_min(1e-30))) - 7)
        excess = ((a - e).abs() - 1e-5 * float(e.abs().max())).clamp_min(0.0) / ulp
        ulps = max(ulps, float(excess.max()) if excess.numel() else 0.0)
    return dx_err, ulps


def split_probe(k: int, m: int, n: int, seed: int = 0, device="cpu"):
    """A K2 case whose dx is exact whatever the order of the sums:
    ``(spec, x, g, flat)`` of a one-layer linear chain ``k -> m`` on the bf16
    route, Gaussian f32 weights, and a cotangent with one entry a row, ±2^e
    (e in -2..2) at column ``row % m``.  Then gz is ``g`` (bf16-exact), every
    other product of a row is an exact 0, and dx of row r is that entry times
    column ``r % m`` of ``W^T``: the f32 weights themselves, so a kernel that
    drops any piece of their split (``lo`` is up to 2^-16 of a weight, 2^7
    units of its last place) is off by many units in nearly every element,
    where ``data_pass_errors`` sees a dropped ``lo`` only as a few 1e-6 of
    dx's scale, beside the order-of-sums error of the sound kernel."""
    rs = np.random.RandomState(seed)
    spec = ChainSpec((k, m), ("none",), (False,), (1.0,), compute_dtype="bfloat16")
    w = (rs.randn(k, m) / np.sqrt(k)).astype(np.float32)
    b = (rs.randn(1, m) * 0.1).astype(np.float32)
    x = rs.randn(n, k).astype(np.float32)
    g = np.zeros((n, m), np.float32)
    rows = np.arange(n)
    g[rows, rows % m] = rs.choice([-1.0, 1.0], n) * 2.0 ** rs.randint(-2, 3, n)
    return spec, *(torch.as_tensor(a, device=device) for a in (x, g)), \
        [torch.as_tensor(a, device=device) for a in (w, b)]


def split_probe_units(g, flat, dx) -> float:
    """dx of a ``split_probe`` case against its exact value ``g @ W^T`` (one
    term a row, so float64 holds it exactly and it is an f32 value): the
    largest difference, in units of the last place of the exact value in
    f32.  0 when the products are those of the f32 ``W^T``."""
    exact = (g.double() @ flat[0].double().t()).float()
    ulp = 2.0 ** (torch.floor(torch.log2(exact.abs().clamp_min(1e-30))) - 23)
    return float(((dx - exact).abs() / ulp).max()) if dx.numel() else 0.0


def _validate_jac(spec: ChainSpec, x, flat, gy=None, gj=None):
    _check_jac_spec(spec)
    _validate(spec, x, flat, gy, max_in=MAX_WIDTH)
    if gj is not None and (gj.shape != x.shape or gj.dtype != torch.float32
                           or gj.device != x.device):
        raise ValueError(f"Jacobian cotangent {tuple(gj.shape)} {gj.dtype}")


def _jac_down_launch(lib, spec, n, stash, WT, flat, j, qst):
    """The f32 route's J-pass over ``n`` rows; the seed is read from the
    unrounded last W_h (and W_x on a last-layer skip)."""
    last = _layer_starts(spec)[-1]
    wl_h = flat[last].contiguous()
    wl_x = flat[last + 1].contiguous() if spec.has_skip[-1] else None
    meta, scales = _c_meta(spec)
    err = lib.nunerf_chain_jac_down(
        stash.data_ptr(), WT.data_ptr(), wl_h.data_ptr(), _ptr(wl_x),
        j.data_ptr(), _ptr(qst), n, meta, scales, spec.n_layers, spec.dims[0],
        _stream())
    _check(lib, err, "chain_jac_down")


def _jdown_launch(lib, spec, n, stash, WT, flat, j, qst=None, pst=None):
    """The bf16 J-pass over ``n`` rows (``pack_wgmma_t`` from its J-pass
    walk), K5's with its q and p stashes; the seed from the unrounded last
    W_h (and W_x)."""
    last = _layer_starts(spec)[-1]
    wl_x = flat[last + 1].contiguous() if spec.has_skip[-1] else None
    _bwd_walk_launch(lib, spec, BW_JDOWN, n, WT, h=stash, out=j, q=qst, zst=pst,
                     wl_h=flat[last].contiguous(), wl_x=wl_x)


def _jac_wt(spec: ChainSpec, flat):
    """The rounded weights' transposes for the J-pass and K5's data pass, in
    the route's packing."""
    if _is_mma(spec):
        return pack_wgmma_t(spec, flat, split=False)
    return _pack(spec, flat, transposed=True)


def chain_jac_fwd_cuda(spec: ChainSpec, x, flat):
    """K4: ``(y [N, out_dim], j [N, in_dim])``, ``j = d y[:, 0] / dx``.

    Per chunk of rows: the K1 loop writes ``y`` and the activation stash
    (bf16 on the bf16 route), then the J-pass walks the layers down from the
    stash."""
    _validate_jac(spec, x, flat)
    x = x.contiguous()
    n, e = x.shape
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty((n, spec.dims[-1]), **f32)
    j = torch.empty((n, e), **f32)
    if n == 0:
        return y, j
    lib = _lib()
    B = _pack_biases(spec, flat)
    W, WT = _fwd_pack(spec, flat), _jac_wt(spec, flat)
    rows = min(n, JAC_CHUNK_ROWS)
    if _is_mma(spec):
        stash = torch.empty(rows * mma_layout(spec).psum_hidden,
                            dtype=torch.bfloat16, device=x.device)
    else:
        stash = torch.empty(rows * _layout(spec)[2], **f32)
    for c0 in range(0, n, JAC_CHUNK_ROWS):
        c1 = min(n, c0 + JAC_CHUNK_ROWS)
        _fwd_launch(lib, spec, x[c0:c1], W, B, y[c0:c1], stash)
        if _is_mma(spec):
            _jdown_launch(lib, spec, c1 - c0, stash, WT, flat, j[c0:c1])
        else:
            _jac_down_launch(lib, spec, c1 - c0, stash, WT, flat, j[c0:c1], None)
    launches["chain_jac_fwd"] += 1
    return y, j


def jac_bwd_scratch_bytes(spec: ChainSpec, rows: int) -> int:
    """Bytes of K5's stashes for a chunk of ``rows`` rows: four f32 stashes
    on the f32 route; on the bf16 route h, p, qbar (bf16) and q, dbar (f32)
    of the hidden layers and zs (bf16) of all layers, in the padded layout."""
    if _is_mma(spec):
        lay = mma_layout(spec)
        return rows * (lay.psum_hidden * (3 * 2 + 2 * 4) + lay.psum * 2)
    return rows * _layout(spec)[2] * 4 * 4


def chain_jac_bwd_cuda(spec: ChainSpec, x, gy, gj, flat):
    """K5: (dx, (dW..., db...)) of ``sum(y * gy) + sum(j * gj)``.

    Per chunk of rows: passes 1 and 2 recompute the forward and the J-pass
    into scratch stashes (h, q); pass 3 reverses the J-pass upwards (dbar,
    the rounded qbar, p); pass 4 is K2's data pass with
    ``zbar = hbar act' + dbar act''`` (dx, db partials, the rounded zs);
    every dW is ``h_prev^T zs + s qbar^T p``, and the J-pass's seed puts
    ``s_L * colsum(qbar_top)`` into column 0 of the last dW_h.  Partials are
    summed here; nothing is carried across blocks.  The bf16 route keeps the
    bf16-exact stashes (h, p, zs, qbar) as bf16 and q and dbar as f32, and
    forms every dW of a chunk in one launch."""
    _validate_jac(spec, x, flat, gy, gj)
    x, gy, gj = x.contiguous(), gy.contiguous(), gj.contiguous()
    n, e = x.shape
    f32 = dict(dtype=torch.float32, device=x.device)
    if n == 0:
        return torch.empty((n, e), **f32), tuple(
            [torch.zeros(s, **f32) for s in flat_weight_shapes(spec)]
            + [torch.zeros((1, d), **f32) for d in spec.dims[1:]])
    run = _jac_bwd_mma if _is_mma(spec) else _jac_bwd_f32
    dx, dws, dbs = run(_lib(), spec, x, gy, gj, flat)
    launches["chain_jac_bwd"] += 1
    return dx, tuple(dws) + tuple(dbs)


def _jac_bwd_mma(lib, spec, x, gy, gj, flat):
    n, e = x.shape
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    bf = dict(dtype=torch.bfloat16, device=dev)
    lay = mma_layout(spec)
    _, _, wsum = _layout(spec)
    starts = _layer_starts(spec)
    B = _pack_biases(spec, flat)
    Wf, WT = pack_wgmma(spec, flat), _jac_wt(spec, flat)
    wtop = spec.dims[-2]
    rows = min(n, JAC_CHUNK_ROWS)
    hst, pst, qbs = (torch.empty(rows * lay.psum_hidden, **bf) for _ in range(3))
    qst, dbar = (torch.empty(rows * lay.psum_hidden, **f32) for _ in range(2))
    zst = torch.empty(rows * lay.psum, **bf)
    y = torch.empty((rows, spec.dims[-1]), **f32)
    j = torch.empty((rows, e), **f32)
    dx = torch.empty((n, e), **f32)
    dw = torch.zeros(lay.wtot, **f32)
    db = torch.zeros(wsum, **f32)
    col = torch.zeros(wtop + e, **f32)
    chunks = [(c0, min(n, c0 + JAC_CHUNK_ROWS)) for c0 in range(0, n, JAC_CHUNK_ROWS)]
    x0b, gjb = _pad_bf16(x, lay.ep), _pad_bf16(gj, lay.ep)
    for c0, c1 in chunks:
        nc = c1 - c0
        n_blocks = -(-nc // ROWS_PER_BLOCK)
        colp = torch.empty((n_blocks, wtop + e), **f32)
        dbp = torch.empty((n_blocks, wsum), **f32)
        _fwd_launch(lib, spec, x[c0:c1], Wf, B, y, hst)
        _jdown_launch(lib, spec, nc, hst, WT, flat, j, qst, pst)
        _bwd_walk_launch(lib, spec, BW_JUP, nc, Wf, g=gj[c0:c1], h=hst, zst=qbs,
                         q=qst, dbo=dbar, part=colp)
        _bwd_walk_launch(lib, spec, BW_DATA, nc, WT, g=gy[c0:c1], h=hst,
                         out=dx[c0:c1], zst=zst, dbar=dbar, part=dbp)
        dw += _dw_grouped(lib, spec, nc, {"x0": x0b[c0:c1], "gj": gjb[c0:c1], "h": hst,
                                          "zs": zst, "qbar": qbs, "p": pst}, jac=True)
        db += dbp.sum(0)
        col += colp.sum(0)
    dws = [d.contiguous() for d in unpack_mma(spec, dw)]
    col = col * spec.scales[-1]
    dws[starts[-1]][:, 0] += col[:wtop]
    if spec.has_skip[-1]:
        dws[starts[-1] + 1][:, 0] += col[wtop:]
    dbs, base = [], 0
    for w in spec.dims[1:]:
        dbs.append(db[base:base + w].reshape(1, w))
        base += w
    return dx, dws, dbs


def _jac_bwd_f32(lib, spec, x, gy, gj, flat):
    n, e = x.shape
    n_l = spec.n_layers
    f32 = dict(dtype=torch.float32, device=x.device)
    dws = [torch.zeros(s, **f32) for s in flat_weight_shapes(spec)]
    dbs = [torch.zeros((1, d), **f32) for d in spec.dims[1:]]
    dx = torch.empty((n, e), **f32)
    B = _pack_biases(spec, flat)
    W, WT = _pack(spec, flat), _jac_wt(spec, flat)
    _, _, wsum = _layout(spec)
    starts = _layer_starts(spec)
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
        # p overwrites q and zs overwrites dbar in place
        err = lib.nunerf_chain_jac_up(
            stash.data_ptr(), qst.data_ptr(), W.data_ptr(),
            gj[c0:c1].data_ptr(), dbar.data_ptr(), qbs.data_ptr(),
            colp.data_ptr(), nc, meta, scales, n_l, e, _stream())
        _check(lib, err, "chain_jac_up")
        _bwd_data_launch(lib, spec, nc, stash, WT, gy[c0:c1], dx[c0:c1], dbar,
                         dbar, dbp)

        x0c, gjc = x[c0:c1], gj[c0:c1]
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
    return dx, dws, dbs


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
