"""K1's bf16 forward as far as the CPU reaches it: the weight pack that its
kernel streams slice by slice (``WgmmaLayout``, ``pack_wgmma``), the plan
the launcher hands the kernel (``wgmma_plan``) and the tile walk of its
persistent CTAs (``wgmma_grid``, ``tile_walk``).

The kernel runs only on the card (``tests/test_torch_port_cuda.py``).  These
tests hold what it reads: every weight where a wgmma descriptor of the
128-byte swizzle finds it, zeros in every pad, each slice where the copies
and the barriers' byte counts say, and every row in exactly one tile.  No JAX is needed; torch runs on one thread.
"""

import math

import numpy as np
import pytest
import torch

from nunerf_tpu_torch.ops import fused_mlp as fm

SQ2 = 1 / math.sqrt(2)
SDF_DIMS = (39, 256, 256, 256, 217, 256, 256, 256, 256)
SDF = (("softplus100",) * 8 + ("none",), (False,) * 4 + (True,) + (False,) * 4,
       (1.0,) * 4 + (SQ2,) + (1.0,) * 4)
# the chains of chip_smoke.phase_kernels_odd (the 217-deep layer in both SDF
# chains; last layers of 1, 3, 64 and 257 columns), and two of the card
# tests' (64-wide layers; skips on a hidden and on the last layer)
CHAINS = {
    "sdf value": (SDF_DIMS + (1,), *SDF),
    "sdf full": (SDF_DIMS + (257,), *SDF),
    "head 259": ((259, 256, 256, 256, 3), ("relu",) * 3 + ("none",), (False,) * 4,
                 (1.0,) * 4),
    "relu 131": ((131, 256, 256, 256, 3), ("relu",) * 3 + ("none",), (False,) * 4,
                 (1.0,) * 4),
    "trunk cut": ((84, 256, 256, 256), ("relu",) * 3, (False, False, True), (1.0,) * 3),
    "input 512": ((512, 256, 256, 64), ("relu",) * 3, (False,) * 3, (1.0,) * 3),
    "softplus out": ((259, 256, 257), ("relu", "softplus100"), (False, False), (1.0, 0.5)),
    "relu 64": ((131, 64, 64, 64, 3), ("relu",) * 3 + ("none",), (False,) * 4, (1.0,) * 4),
    "skips": ((20, 64, 64, 64, 5), ("softplus100", "relu", "softplus100", "none"),
              (False, True, False, True), (1.0, 0.5, 1.0, 0.7)),
}


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
    # no weight is 0, so a pad is told from a weight by its value
    flat = [torch.as_tensor((rs.rand(*s) + 0.5).astype(np.float32) * rs.choice([-1, 1], s))
            for s in fm.flat_weight_shapes(spec)]
    return spec, flat


def _slice_bytes(buf, off, nbytes):
    """A slice of a pack as bytes, numpy uint8."""
    return buf[off // 2:(off + nbytes) // 2].view(torch.int16).numpy().view(np.uint8)


@pytest.mark.parametrize("name", list(CHAINS))
def test_pack_round_trips_and_pads_are_zero(name):
    """``unpack_wgmma(pack_wgmma(w))`` is every weight rounded to bf16, and
    every element of the pack that holds no weight is 0."""
    spec, flat = _chain(name)
    buf = fm.pack_wgmma(spec, flat)
    lay = fm.wgmma_layout(spec)
    assert buf.dtype == torch.bfloat16 and buf.numel() * 2 == lay.nbytes
    for got, w in zip(fm.unpack_wgmma(spec, buf), flat):
        assert torch.equal(got, w.to(torch.bfloat16))
    held = torch.zeros(buf.numel(), dtype=torch.bool)
    for pos in fm._wgmma_positions(spec):
        held[torch.as_tensor(pos.reshape(-1))] = True
    assert int(held.sum()) == sum(w.numel() for w in flat)
    assert int(torch.count_nonzero(buf[~held])) == 0


@pytest.mark.parametrize("name", list(CHAINS))
def test_slices_are_aligned_and_in_the_products_order(name):
    """Slices lie one after another from byte 0, each on a 128-byte boundary
    (1024: a swizzle atom) and a multiple of 16 bytes (what a bulk copy
    takes), each its block's width of 128-byte rows; per column block, W_h's
    slices every 64 rows of the padded depth, then W_x's; a block no wider
    than a stage (256 rows) and at least the layer's padded width."""
    spec, _ = _chain(name)
    lay = fm.wgmma_layout(spec)
    mlay = fm.mma_layout(spec)
    end = 0
    for l, b, part, k0, off, nbytes in lay.slices:
        assert off == end and off % 1024 == 0 and nbytes % 16 == 0
        assert nbytes == lay.blocks[l][b][1] * 128
        end = off + nbytes
    assert end == lay.nbytes
    walk = []
    for l, ((ip, wp, _, pwx, _), blocks) in enumerate(zip(mlay.layers, lay.blocks)):
        assert sum(w for _, w in blocks) >= wp
        assert all(w in fm.WG_WIDTHS for _, w in blocks)
        assert [c0 for c0, _ in blocks] == list(range(0, 256 * len(blocks), 256))
        assert len(blocks) == 1 or l == spec.n_layers - 1
        for b in range(len(blocks)):
            walk += [(l, b, "h", k0) for k0 in range(0, ip, 64)]
            if pwx >= 0:
                walk += [(l, b, "x", k0) for k0 in range(0, mlay.ep, 64)]
    assert [s[:4] for s in lay.slices] == walk


@pytest.mark.parametrize("name", list(CHAINS))
def test_plan_hands_the_barriers_each_slices_bytes(name):
    """``wgmma_plan``: grid, slice count, per layer the widths of its two
    column blocks, then the bytes the kernel hands the full barrier for each
    slice: the slice's size in the pack, in its order; the walk's table fits
    the kernel's (``WG_MAXSL``) and the ring has room for two stages."""
    spec, _ = _chain(name)
    lay = fm.wgmma_layout(spec)
    L = spec.n_layers
    assert len(lay.slices) <= fm.WG_MAXSL and fm.wgmma_stages(spec) >= 2
    for n in (1, 131072):
        plan = fm.wgmma_plan(spec, n, 132)
        assert plan[:2] == [fm.wgmma_grid(n, 132), len(lay.slices)]
        widths = plan[2:2 + 2 * L]
        for l, blocks in enumerate(lay.blocks):
            assert widths[2 * l:2 * l + 2] == [w for _, w in blocks] + [0] * (2 - len(blocks))
        sizes = plan[2 + 2 * L:]
        assert sizes == [s[5] for s in lay.slices] and sum(sizes) == lay.nbytes


@pytest.mark.parametrize("name", ["sdf value", "sdf full", "input 512", "skips"])
def test_slices_hold_the_128_byte_swizzle(name):
    """The swizzle's defining property, from the raw bytes: within each
    atom of 8 rows x 128 bytes, 16-byte chunk c of row r (W^T's row c0 + 8 a
    + r, its depth k0 + 8 c .. + 8) sits at chunk c ^ (r % 8)."""
    spec, flat = _chain(name)
    buf = fm.pack_wgmma(spec, flat)
    lay = fm.wgmma_layout(spec)
    starts = fm._layer_starts(spec)
    for l, b, part, k0, off, nbytes in lay.slices:
        w = flat[starts[l] + (part == "x")].to(torch.bfloat16)
        c0, width = lay.blocks[l][b]
        wt = torch.zeros((width, 64), dtype=torch.bfloat16)   # W^T rows, this slice's depth
        rows = w[k0:k0 + 64, c0:c0 + width].t()
        wt[:rows.shape[0], :rows.shape[1]] = rows
        want = wt.view(torch.int16).numpy().view(np.uint8).reshape(width // 8, 8, 8, 16)
        got = _slice_bytes(buf, off, nbytes).reshape(width // 8, 8, 8, 16)
        for r in range(8):
            for c in range(8):
                assert np.array_equal(got[:, r, c ^ r], want[:, r, c]), (l, b, part, k0, r, c)


@pytest.mark.parametrize("n", [1, 63, 64, 65, 127, 129, 1000, 131072])
def test_tile_walk_covers_every_row_once(n):
    """Every row below n is owned by exactly one tile, for the grid the
    launcher computes (132 SMs, and a card of 7): tiles of at most 64 rows,
    every CTA of the grid taking at least one turn."""
    for sms in (132, 7):
        grid = fm.wgmma_grid(n, sms)
        assert 1 <= grid <= sms
        count = np.zeros(n, np.int64)
        ctas = set()
        for cta, tile, k, r0, r1 in fm.tile_walk(n, grid):
            assert 0 <= cta < grid and tile in (0, 1) and r1 - r0 <= fm.WG_ROWS
            count[r0:r1] += 1
            ctas.add(cta)
        assert (count == 1).all() and ctas == set(range(grid))


def test_a_chain_without_room_for_two_stages_raises():
    """A skip past the first layer behind a 336-wide input leaves the
    forward one ring stage: ``check_limits`` refuses it on both routes; 320
    wide it fits."""
    for e, ok in ((320, True), (336, False)):
        for cd in ("float32", "bfloat16"):
            spec = fm.ChainSpec((e, 256, 256, 256), ("relu",) * 3, (False, False, True),
                                (1.0,) * 3, compute_dtype=cd)
            if ok:
                fm.check_limits(spec)
            else:
                with pytest.raises(ValueError, match="two weight stages"):
                    fm.check_limits(spec)
