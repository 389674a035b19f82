"""The backward passes of the bf16 route as far as the CPU reaches them: the
transposed walks' weight pack (``WgmmaTLayout``, ``pack_wgmma_t``) that the
data pass and the J-pass stream slice by slice, the walks' counts the
launcher hands the kernel (``bwd_walk``), the dW GEMM's plan and the work
list of its persistent CTAs (``_dw_plan``, ``dw_splits``, ``dw_work``), and
an emulation of K2's split data pass in the kernel's order of the sums,
held to the JAX K2 in Pallas interpret mode.

The kernels run only on the card (``tests/test_torch_port_cuda.py``).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nunerf_tpu.ops import fused_mlp as jfm
from nunerf_tpu_torch.ops import fused_mlp as fm

SQ2 = 1 / math.sqrt(2)
SDF_DIMS = (39, 256, 256, 256, 217, 256, 256, 256, 256)
SDF = (("softplus100",) * 8 + ("none",), (False,) * 4 + (True,) + (False,) * 4,
       (1.0,) * 4 + (SQ2,) + (1.0,) * 4)
CHAINS = {
    "sdf value": (SDF_DIMS + (1,), *SDF),
    "sdf full": (SDF_DIMS + (257,), *SDF),
    "head 259": ((259, 256, 256, 256, 3), ("relu",) * 3 + ("none",), (False,) * 4,
                 (1.0,) * 4),
    "trunk cut": ((84, 256, 256, 256), ("relu",) * 3, (False, False, True), (1.0,) * 3),
    "input 512": ((512, 256, 256, 64), ("relu",) * 3, (False,) * 3, (1.0,) * 3),
    "skips": ((20, 64, 130, 64, 5), ("softplus100", "relu", "softplus100", "none"),
              (False, True, False, True), (1.0, 0.5, 1.0, 0.7)),
}
JAC = [k for k, v in CHAINS.items() if v[1][-1] == "none"]


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _chain(name, seed=0):
    dims, acts, skip, scales = CHAINS[name]
    spec = fm.ChainSpec(dims, acts, skip, scales, compute_dtype="bfloat16")
    rs = np.random.RandomState(seed)
    # no weight is 0, so a pad is told from a weight by its value; f32
    # weights with bits below bf16's, so that every piece of the split counts
    flat = [torch.as_tensor(((rs.rand(*s) + 0.5) * rs.choice([-1, 1], s)).astype(np.float32))
            for s in fm.flat_weight_shapes(spec)]
    return spec, flat


def _swizzled(c, k):
    """Byte of (row c, depth k) in a slice of 64-deep rows with the 128-byte
    swizzle, written out independently of ``fm.sw128_offset``."""
    return (c // 8) * 1024 + (c % 8) * 128 + (((k // 8) ^ (c % 8)) * 16) + (k % 8) * 2


def _want_steps(spec, jac):
    """The transposed walk written out: per layer from the top (the J-pass:
    from the last hidden layer) the skip's product into dx or j, then W_h's,
    into the layer below or, at layer 0, into dx or j."""
    lay = fm.mma_layout(spec)
    top = spec.n_layers - (2 if jac else 1)
    steps = []
    for l in range(top, -1, -1):
        ip = lay.layers[l][0]
        if spec.has_skip[l]:
            steps += [(l, "x", c0, fm.wg_width(min(256, lay.ep - c0)), True)
                      for c0 in range(0, lay.ep, 256)]
        if l == 0:
            steps += [(l, "h", c0, fm.wg_width(min(256, ip - c0)), True)
                      for c0 in range(0, ip, 256)]
        else:
            steps.append((l, "h", 0, fm.wg_width(ip), False))
    return steps


@pytest.mark.parametrize("split", [True, False])
@pytest.mark.parametrize("name", list(CHAINS))
def test_walk_steps_are_the_transposed_walk(name, split):
    """The steps of ``WgmmaTLayout`` and where the J-pass's walk starts."""
    spec, _ = _chain(name)
    lay = fm.wgmma_t_layout(spec, split)
    assert lay.steps == _want_steps(spec, jac=False)
    if spec.acts[-1] == "none":
        first = lay.slices[lay.jac_slice]
        assert lay.steps[first[0]:] == _want_steps(spec, jac=True)
        assert first[3] == lay.jac_offset and first[1] == 0


@pytest.mark.parametrize("split", [True, False])
@pytest.mark.parametrize("name", list(CHAINS))
def test_slices_are_contiguous_and_in_the_walks_order(name, split):
    """One slice a 64-deep step of a block's depth (the layer's padded
    output width), ``pieces`` times (lo, mid, hi with the split), each its
    block's width x 128 bytes, one after another from 0."""
    spec, _ = _chain(name)
    lay = fm.wgmma_t_layout(spec, split)
    ml = fm.mma_layout(spec)
    pieces = fm.SPLIT_PIECES if split else (0,)
    want, off = [], 0
    for si, (l, _, _, w, _) in enumerate(lay.steps):
        for k0 in range(0, ml.layers[l][1], 64):
            for p in pieces:
                want.append((si, k0, p, off, w * 128))
                off += w * 128
    assert lay.slices == want and lay.nbytes == off
    assert all(s[3] % 1024 == 0 for s in lay.slices)


@pytest.mark.parametrize("split", [True, False])
@pytest.mark.parametrize("name", list(CHAINS))
def test_pack_holds_every_weight_at_its_swizzled_address(name, split):
    """Every byte of ``pack_wgmma_t`` against a numpy layout of the walk:
    slice (step, k0, piece) holds piece ``piece`` of ``W[c0 + c, k0 + k]``
    at byte ``_swizzled(c, k)``, zero outside the matrix."""
    spec, flat = _chain(name, seed=len(name))
    lay = fm.wgmma_t_layout(spec, split)
    buf = fm.pack_wgmma_t(spec, flat, split)
    assert buf.dtype == torch.bfloat16 and 2 * buf.numel() == lay.nbytes
    got = buf.view(torch.int16).numpy()
    starts = fm._layer_starts(spec)
    pieces = [p.view(torch.int16).numpy() for p in
              (fm.split_bf16(torch.cat([w.reshape(-1) for w in flat])) if split
               else (torch.cat([w.reshape(-1) for w in flat]).to(torch.bfloat16),))]
    bases = np.cumsum([0] + [w.numel() for w in flat])
    want = np.zeros_like(got)
    cc, kk = np.meshgrid(np.arange(256), np.arange(64), indexing="ij")
    for si, k0, p, off, nbytes in lay.slices:
        l, part, c0, w, _ = lay.steps[si]
        slot = starts[l] + (part == "x")
        rows, cols = flat[slot].shape
        c, k = cc[:w], kk[:w]
        inside = (c0 + c < rows) & (k0 + k < cols)
        src = bases[slot] + (c0 + c) * cols + (k0 + k)
        val = np.where(inside, pieces[p if split else 0][np.where(inside, src, 0)], 0)
        want[(off + _swizzled(c, k)) // 2] = val
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name", list(CHAINS))
def test_split_pieces_sum_to_the_f32_transposes(name):
    """The split pack read back: lo + mid + hi is every f32 weight exactly,
    hi is the rounded pack's weight, and the rounded pack reads back as
    every weight rounded to bf16."""
    spec, flat = _chain(name, seed=3)
    split = fm.unpack_wgmma_t(spec, fm.pack_wgmma_t(spec, flat, True), True)
    plain = fm.unpack_wgmma_t(spec, fm.pack_wgmma_t(spec, flat, False), False)
    for w, s3, s1 in zip(flat, split, plain):
        assert s3.shape == (3,) + tuple(w.shape) and s1.shape == (1,) + tuple(w.shape)
        assert torch.equal(s3.double().sum(0), w.double())
        assert torch.equal(s3[0], w.to(torch.bfloat16).float())
        assert torch.equal(s1[0], w.to(torch.bfloat16).float())
        assert bool((s3[2] != 0).any()), "lo holds nothing: the test weights are too coarse"


@pytest.mark.parametrize("name", list(CHAINS))
def test_walk_counts_the_kernel_is_held_to(name):
    """``bwd_walk``: the data pass reads its pack whole, the J-pass the
    rounded pack from its first slice, the J-pass's reverse the forward
    pack's slices of every layer but the last; slices a 64-deep step."""
    spec, _ = _chain(name)
    for split in (True, False):
        lay = fm.wgmma_t_layout(spec, split)
        assert fm.bwd_walk(spec, fm.BW_DATA, split) == (len(lay.slices), lay.nbytes, 0)
    if name in JAC:
        lay = fm.wgmma_t_layout(spec, False)
        nsl, nbytes, off = fm.bwd_walk(spec, fm.BW_JDOWN)
        assert off == lay.jac_offset and nbytes == lay.nbytes - off
        assert nsl == len(lay.slices) - lay.jac_slice
        fwd = fm.wgmma_layout(spec)
        nsl, nbytes, off = fm.bwd_walk(spec, fm.BW_JUP)
        last = [s for s in fwd.slices if s[0] == spec.n_layers - 1]
        assert (nsl, nbytes, off) == (len(fwd.slices) - len(last),
                                      fwd.nbytes - sum(s[-1] for s in last), 0)


@pytest.mark.parametrize("n", [1, 63, 65, 129, 65537])
@pytest.mark.parametrize("name,jac", [("sdf full", True), ("sdf value", False),
                                      ("head 259", False), ("skips", True)])
def test_dw_work_covers_every_tile_and_split_once(name, jac, n):
    """The dW launch's row splits partition [0, n) in multiples of 64 rows,
    and its persistent CTAs, at any grid, take every (tile, split) once."""
    spec, _ = _chain(name)
    ntiles = len(fm.dw_work_table(spec, jac))
    splits, rps = fm.dw_splits(n, ntiles)
    assert rps % 64 == 0 and (splits - 1) * rps < n <= splits * rps
    for grid in sorted({1, 7, 132, ntiles * splits}):
        if grid > ntiles * splits:
            continue
        work = fm.dw_work(ntiles, splits, grid)
        seen = sorted((tile, split) for _, tile, split in work)
        assert seen == [(t, s) for t in range(ntiles) for s in range(splits)]
        assert all(0 <= cta < grid for cta, _, _ in work)


@pytest.mark.parametrize("name,jac", [("sdf full", True), ("sdf value", False),
                                      ("trunk cut", False), ("skips", True)])
def test_dw_plan_names_each_operand_layer_once(name, jac):
    """The table's maps: every operand's stash layer (its first element and
    width in ``MmaLayout``), once each; a tile's columns inside the layer's
    width; at most ``DW_MAXMAPS`` of them."""
    spec, _ = _chain(name)
    lay = fm.mma_layout(spec)
    n = 1000
    plan = fm._dw_plan(spec, n, jac, torch.device("cpu"))
    maps = plan["maps"]
    assert len(set(maps)) == len(maps) <= fm.DW_MAXMAPS
    table = plan["table"].numpy()
    assert table.shape == (plan["ntiles"], fm.DW_ROW)
    for row, work in zip(table, fm.dw_work_table(spec, jac)):
        _, i0, mext, c0, next_, a1, b1, a2, b2, _ = work
        for k, (op, first, ext) in enumerate(((a1, i0, mext), (b1, c0, next_),
                                              (a2, i0, mext), (b2, c0, next_))):
            if op is None:
                assert row[2 * k] == -1
                continue
            name_, l, = op
            want = (name_, 0, lay.ep) if l is None else (name_, n * lay.layers[l][4],
                                                         lay.layers[l][1])
            assert maps[row[2 * k]] == want and row[2 * k + 1] == first
            assert first + ext <= want[2]


SPLIT_SPECS = {
    "sdf_value": ((39, 64, 25, 64, 1), ("softplus100",) * 3 + ("none",),
                  (False, False, True, False), (1.0, 1.0, SQ2, 1.0)),
    "relu_predictor": ((131, 64, 64, 64, 3), ("relu",) * 3 + ("none",),
                       (False,) * 4, (1.0,) * 4),
}


def _split_walk_data_pass(spec, x, g, flat):
    """K2's bf16 data pass as the wgmma walk sums it: per product, every
    64-deep step of the rounded gz times lo, then mid, then hi of the f32
    ``W^T`` (``split_bf16``), each piece's products added to one f32 sum;
    dx the skip's product, then layer 0's added.  Returns (dx, dflat, kept)."""
    nw = fm.n_weights(spec)
    starts = fm._layer_starts(spec)
    n_l = spec.n_layers
    y, hidden = fm.chain_hidden_reference(spec, x, *flat)

    def times_wt(z, wi):
        hi, mid, lo = (p.float() for p in fm.split_bf16(flat[wi].t()))
        acc = torch.zeros(z.shape[0], hi.shape[1])
        for k0 in range(0, z.shape[1], 64):
            for piece in (lo, mid, hi):
                acc = acc + z[:, k0:k0 + 64] @ piece[k0:k0 + 64]
        return acc

    x0 = fm.round_to(x, "bfloat16")
    acts = hidden + [y]
    v = g * fm._act_grad_from_a(spec.acts[-1], y)
    dx, dws, dbs, gzs = None, [None] * nw, [None] * n_l, [None] * n_l
    for l in reversed(range(n_l)):
        dbs[l] = v.sum(0, keepdim=True)
        gz = fm.round_to(v * spec.scales[l], "bfloat16")
        gzs[l] = gz
        h_prev = x0 if l == 0 else hidden[l - 1]
        dws[starts[l]] = h_prev.t() @ gz
        if spec.has_skip[l]:
            dws[starts[l] + 1] = x0.t() @ gz
            p = times_wt(gz, starts[l] + 1)
            dx = p if dx is None else dx + p
        gh = times_wt(gz, starts[l])
        if l == 0:
            dx = gh if dx is None else dx + gh
        else:
            v = gh * fm._act_grad_from_a(spec.acts[l - 1], acts[l - 1])
    return dx, tuple(dws) + tuple(dbs), dict(y=y, hidden=hidden, gzs=gzs)


@pytest.mark.parametrize("name,n", [("sdf_value", 130), ("relu_predictor", 65)])
def test_split_walk_order_matches_jax_k2(name, n):
    """The walk's order of the split products against the JAX K2 (Pallas
    interpret mode, bf16 compute), which multiplies the rounded gz by the
    f32 ``W^T``: dx, every dW and db within 1e-2 of each gradient's scale;
    on its own stashes (``data_pass_errors``) dx within 1e-5 and the rounded
    gz within one bf16 unit: the order of the sums moves only last bits."""
    dims, acts, skip, scales = SPLIT_SPECS[name]
    spec = fm.ChainSpec(dims, acts, skip, scales, compute_dtype="bfloat16")
    rs = np.random.RandomState(n)
    flat = [(rs.randn(*s) / np.sqrt(s[0])).astype(np.float32)
            for s in fm.flat_weight_shapes(spec)]
    flat += [rs.randn(1, d).astype(np.float32) * 0.1 for d in dims[1:]]
    x = rs.randn(n, dims[0]).astype(np.float32)
    g = rs.randn(n, dims[-1]).astype(np.float32)
    jspec = jfm.ChainSpec(dims, acts, skip, scales, compute_dtype="bfloat16")
    jg = jax.grad(lambda xx, *ff: jnp.sum(jfm.fused_chain_mlp(jspec, xx, *ff) * g),
                  argnums=tuple(range(len(flat) + 1)))(jnp.asarray(x),
                                                       *[jnp.asarray(f) for f in flat])
    tflat = [torch.as_tensor(f) for f in flat]
    dx, dflat, kept = _split_walk_data_pass(spec, torch.as_tensor(x), torch.as_tensor(g),
                                            tflat)
    for i, (a, e) in enumerate(zip((dx,) + dflat, jg)):
        e = torch.as_tensor(np.array(e))
        err = float((a - e).abs().max())
        assert err <= 1e-2 * float(e.abs().max()), f"grad {i}: {err}"
    dx_err, ulps = fm.data_pass_errors(spec, torch.as_tensor(g), tflat, kept, dx)
    assert dx_err <= 1e-5 and ulps <= 1.0, (dx_err, ulps)


@pytest.mark.parametrize("k,m", [(39, 1), (259, 3), (512, 257)])
def test_split_walk_order_gives_the_f32_weights(k, m):
    """On ``split_probe`` cases (dx exact in any order) the walk's order of
    the pieces gives the f32 weights to the last bit."""
    spec, x, g, flat = fm.split_probe(k, m, 200, seed=k + m)
    dx = _split_walk_data_pass(spec, x, g, flat)[0]
    assert fm.split_probe_units(g, flat, dx) == 0.0
