"""K2's data pass on the bf16 route: the three-piece bf16 split of the f32
``W^T``, on the CPU.

The kernel multiplies the rounded gz by hi, mid and lo (``split_bf16``) in
one f32 accumulator in place of the f32 ``W^T``.  These tests hold the split
itself (exact for ``|W| >= 2**-110``, within 2**-134 below, where bf16's
subnormal grain ends) and a plain emulation of the split data pass against
the JAX ``fused_chain_mlp`` gradient - K2 in Pallas interpret mode, bf16 compute, as
``tests/test_torch_port_fused_mlp.py`` runs it.  The kernel's pack of the
pieces (``pack_wgmma_t``) and an emulation in the kernel's order of the sums
are held in ``tests/test_torch_port_wgmma_bwd.py``; the kernel itself runs
only on the card (``tests/test_torch_port_cuda.py``).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nunerf_tpu.ops import fused_mlp as jfm
from nunerf_tpu_torch.ops import fused_mlp as fm
from port_helpers import assert_close, t

SPECS = {
    # the SDF chain's shape: softplus100, a NeuS skip (1/sqrt(2)), value-only
    "sdf_value": ((39, 64, 25, 64, 1), ("softplus100",) * 3 + ("none",),
                  (False, False, True, False), (1.0, 1.0, 1 / math.sqrt(2), 1.0)),
    # a predictor head: relu chain with a 3-wide linear output
    "relu_predictor": ((131, 64, 64, 64, 3), ("relu",) * 3 + ("none",),
                       (False,) * 4, (1.0,) * 4),
    # the NeRF++ trunk's shape: a post-activation skip at scale 1 on the last
    # layer, which carries a relu
    "trunk_cut": ((84, 48, 48, 40), ("relu",) * 3, (False, False, True), (1.0,) * 3),
    # a softplus last layer and a 259-wide input
    "softplus_out": ((259, 32, 33), ("relu", "softplus100"), (False, False), (1.0, 0.5)),
}


def _make(name, n, seed):
    dims, acts, skip, scales = SPECS[name]
    spec = fm.ChainSpec(dims, acts, skip, scales, compute_dtype="bfloat16")
    rs = np.random.RandomState(seed)
    flat = [(rs.randn(*s) / np.sqrt(s[0])).astype(np.float32)
            for s in fm.flat_weight_shapes(spec)]
    flat += [rs.randn(1, d).astype(np.float32) * 0.1 for d in dims[1:]]
    x = rs.randn(n, dims[0]).astype(np.float32)
    g = rs.randn(n, dims[-1]).astype(np.float32)
    return spec, x, flat, g


def _f64(*pieces):
    return sum(p.double() for p in pieces)


@pytest.mark.parametrize("kind", ["random", "near_zero", "large", "tiny_normal"])
def test_split_is_exact(kind):
    """hi + mid + lo == W in float64, every piece bf16-exact, for weights of
    every normal magnitude the split covers."""
    gen = torch.Generator().manual_seed(1)
    w = torch.randn(200000, generator=gen)
    if kind == "near_zero":
        w = w * 1e-20
    elif kind == "large":
        w = w * 1e30
    elif kind == "tiny_normal":   # [2^-110, 2^-109): the bottom of the exact range
        w = (torch.rand(200000, generator=gen) + 1) * 2.0 ** -110 * torch.sign(w)
    hi, mid, lo = fm.split_bf16(w)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    for p in (hi, mid, lo):
        assert torch.equal(p.float().to(torch.bfloat16).float(), p.float())
    assert torch.equal(_f64(hi, mid, lo), w.double())
    # each piece is at most half a unit in the last place of the one before
    nz = hi != 0
    assert (mid.double().abs()[nz] <= hi.double().abs()[nz] * 2.0 ** -8).all()


def test_split_below_the_exact_range():
    """Below 2**-110 a weight's low bits fall under bf16's subnormal grain
    (2**-133): the sum is within 2**-134 of the weight, f32 subnormals
    included."""
    gen = torch.Generator().manual_seed(2)
    w = torch.cat([torch.randn(50000, generator=gen) * 1e-36,
                   torch.randn(50000, generator=gen) * 1e-40,    # f32 subnormals
                   torch.tensor([1e-45, -1e-45, 1.17e-38, 0.0])])
    hi, mid, lo = fm.split_bf16(w)
    assert ((_f64(hi, mid, lo) - w.double()).abs() <= 2.0 ** -134).all()


def test_split_products_are_the_f32_products():
    """gz (bf16) times each piece is exact in f32, and the three products of
    a term add up to gz * W exactly in float64; the three matrix products sum
    to gz @ W within float64 rounding."""
    gen = torch.Generator().manual_seed(3)
    w = torch.randn(96, 40, generator=gen) / 10
    gz = torch.randn(50, 96, generator=gen).to(torch.bfloat16).float()
    hi, mid, lo = fm.split_bf16(w)
    for p in (hi, mid, lo):
        prod = gz[:, :, None] * p.float()[None]          # f32 products
        assert torch.equal(prod.double(), gz.double()[:, :, None] * p.double()[None])
    terms = sum(gz.double()[:, :, None] * p.double()[None] for p in (lo, mid, hi))
    assert torch.equal(terms, gz.double()[:, :, None] * w.double()[None])
    three = gz.double() @ lo.double() + gz.double() @ mid.double() + gz.double() @ hi.double()
    ref = gz.double() @ w.double()
    assert float((three - ref).abs().max()) <= 1e-14 * float(ref.abs().max())


def _split_data_pass(spec, x, g, flat, drop=None):
    """Plain emulation of K2 on the bf16 route: the forward with bf16 hidden
    activations, then per layer down gz = g act'(a), db, gzs = round(gz s),
    dW = h_prev^T gzs, and the products with W^T as three f32 products of
    the pieces, lo and mid summed before hi; ``drop`` ("lo" or "mid") leaves
    that piece out, as a faulty kernel would.  Returns (dx, dflat, kept)."""
    nw = fm.n_weights(spec)
    starts = fm._layer_starts(spec)
    n_l = spec.n_layers
    y, hidden = fm.chain_hidden_reference(spec, x, *flat)
    pieces = [fm.split_bf16(w.t()) for w in flat[:nw]]

    def times_wt(z, wi):
        hi, mid, lo = (p.float() for p in pieces[wi])
        lo, mid = (torch.zeros_like(hi) if drop == name else p
                   for name, p in (("lo", lo), ("mid", mid)))
        return (z @ lo + z @ mid) + z @ hi

    x0 = fm.round_to(x, "bfloat16")
    acts = hidden + [y]
    v = g * fm._act_grad_from_a(spec.acts[-1], y)
    dx, dws, dbs, gzs = 0.0, [None] * nw, [None] * n_l, [None] * n_l
    for l in reversed(range(n_l)):
        dbs[l] = v.sum(0, keepdim=True)
        gz = fm.round_to(v * spec.scales[l], "bfloat16")
        gzs[l] = gz
        h_prev = x0 if l == 0 else hidden[l - 1]
        dws[starts[l]] = h_prev.t() @ gz
        if spec.has_skip[l]:
            dws[starts[l] + 1] = x0.t() @ gz
            dx = dx + times_wt(gz, starts[l] + 1)
        gh = times_wt(gz, starts[l])
        if l == 0:
            dx = dx + gh
        else:
            v = gh * fm._act_grad_from_a(spec.acts[l - 1], acts[l - 1])
    return dx, tuple(dws) + tuple(dbs), dict(y=y, hidden=hidden, gzs=gzs)


@pytest.mark.parametrize("name,n", [("sdf_value", 300), ("relu_predictor", 77),
                                    ("trunk_cut", 65), ("softplus_out", 40)])
def test_split_data_pass_matches_jax_k2(name, n):
    """The emulation against the JAX K2 (Pallas interpret mode, bf16
    compute), which multiplies the rounded gz by the f32 ``W^T``: dx, every
    dW and db within 1e-2 of each gradient's scale (both round hidden
    activations and gz to bf16; a sum in another order can round one of them
    the other way).  Against ``data_pass_reference`` on the emulation's own
    stashes, the rounded gz agree to one bf16 unit and dx to 1e-5: the pieces
    give the products of the f32 ``W^T``."""
    spec, x, flat, g = _make(name, n, seed=len(name) + n)
    dims, acts, skip, scales = SPECS[name]
    jspec = jfm.ChainSpec(dims, acts, skip, scales, compute_dtype="bfloat16")
    args = tuple(range(len(flat) + 1))
    jg = jax.grad(lambda xx, *ff: jnp.sum(jfm.fused_chain_mlp(jspec, xx, *ff) * g),
                  argnums=args)(jnp.asarray(x), *[jnp.asarray(f) for f in flat])

    tflat = [t(f) for f in flat]
    dx, dflat, kept = _split_data_pass(spec, t(x), t(g), tflat)
    for i, (a, e) in enumerate(zip((dx,) + dflat, jg)):
        assert_close(a, e, 1e-2, what=f"grad {i} vs JAX K2")

    dx_err, gzs_ulps = fm.data_pass_errors(spec, t(g), tflat, kept, dx)
    assert dx_err <= 1e-5 and gzs_ulps <= 1.0, (dx_err, gzs_ulps)


@pytest.mark.parametrize("k,m", [(39, 1), (259, 3), (512, 257)])
def test_split_probe_tells_a_dropped_piece(k, m):
    """``split_probe``: dx of a one-layer chain at one-entry cotangents is
    the f32 weights times powers of two, whatever the order of the sums.
    The emulated split data pass gives it to the last bit; with ``lo`` left
    out it is off by at least 16 units of the last place, with ``mid`` left
    out by at least 1000 (``split_probe_units``)."""
    spec, x, g, flat = fm.split_probe(k, m, 300, seed=k + m)
    assert ((g != 0).sum(1) == 1).all()
    units = {drop: fm.split_probe_units(g, flat, _split_data_pass(spec, x, g, flat, drop)[0])
             for drop in (None, "lo", "mid")}
    assert units[None] == 0.0, units
    assert units["lo"] >= 16 and units["mid"] >= 1000, units
