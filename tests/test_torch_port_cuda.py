"""K1, K2, K3, K4 and K5 on the card against their plain versions, and the
training loop on the card.

Needs an NVIDIA GPU with ``nvcc`` (the kernels are built at first use) and
skips elsewhere.  The file imports no JAX, so it runs on a machine that has
only PyTorch:

    python -m pytest -o addopts= --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerances, relative to each array's largest magnitude: f32 1e-5 forward and
1e-4 backward (sums in another order); bf16 1e-2 forward and 3e-2 backward
(hidden activations and cotangents rounded to bf16, where a rounding flips
with the sum order); K4 is held as a forward (``y``, ``j``) and K5 as a
backward (against autograd through K4's plain version).  K2's bf16 data pass
is also held to f32 products of its own stashes (1e-5, one bf16 unit) and,
on one-layer probes, to the f32 weights (one unit of the last place).  K3
multiplies and adds without FMA contraction, one rounding an operation as
the plain version: ``t``, the triangle index and ``hit`` are held exactly,
over a culling index, on an adversarial box mesh too, in each of its modes
(exact, and the sweeps' barycentric tolerance).
"""

import math

import numpy as np
import pytest
import torch

from nunerf_tpu_torch.ops import fused_mlp as fm
from nunerf_tpu_torch.ops import ray_intersect as ri

SPECS = {
    # the SDF chain's shape: softplus100, a NeuS skip (1/sqrt(2)), 257 wide out
    "sdf": ((39, 256, 217, 256, 257), ("softplus100",) * 3 + ("none",),
            (False, False, True, False), (1.0, 1.0, 1 / math.sqrt(2), 1.0)),
    # a predictor head: relu chain with a 3-wide linear output
    "relu": ((131, 64, 64, 64, 3), ("relu",) * 3 + ("none",),
             (False,) * 4, (1.0,) * 4),
    # a material head: the input (feature + point) wider than the hidden layers
    "relu259": ((259, 256, 256, 256, 3), ("relu",) * 3 + ("none",),
                (False,) * 4, (1.0,) * 4),
    # the NeRF++ trunk's shape: a post-activation skip, every layer relu
    "trunk": ((84, 256, 256, 256), ("relu",) * 3, (False, False, True), (1.0,) * 3),
    # the value-only SDF chain: the last layer sliced to its first column
    "sdf_value": ((39, 256, 217, 256, 1), ("softplus100",) * 3 + ("none",),
                  (False, False, True, False), (1.0, 1.0, 1 / math.sqrt(2), 1.0)),
    # the same at full depth, as the sweeps and the extraction run it
    "sdf_value_full": ((39, 256, 256, 256, 217, 256, 256, 256, 256, 1),
                       ("softplus100",) * 8 + ("none",), (False,) * 4 + (True,) + (False,) * 4,
                       (1.0,) * 4 + (1 / math.sqrt(2),) + (1.0,) * 4),
    # a skip on layer 1 and on the last layer, a relu among the activations
    "jac_skips": ((20, 64, 64, 64, 5), ("softplus100", "relu", "softplus100", "none"),
                  (False, True, False, True), (1.0, 0.5, 1.0, 0.7)),
    # the widest input K1/K2 take, a relu last layer
    "wide512": ((512, 256, 256, 64), ("relu",) * 3, (False,) * 3, (1.0,) * 3),
    # a softplus last layer 257 wide, scaled, behind a 259-wide input
    "sp_out": ((259, 256, 257), ("relu", "softplus100"), (False, False), (1.0, 0.5)),
}
TOL = {("fwd", "float32"): 1e-5, ("bwd", "float32"): 1e-4,
       ("fwd", "bfloat16"): 1e-2, ("bwd", "bfloat16"): 3e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _make(name, n, compute_dtype, dev, seed=5):
    dims, acts, skip, scales = SPECS[name]
    spec = fm.ChainSpec(dims, acts, skip, scales, compute_dtype=compute_dtype)
    rs = np.random.RandomState(seed)
    flat = [(rs.randn(*s) / np.sqrt(s[0])).astype(np.float32)
            for s in fm.flat_weight_shapes(spec)]
    flat += [rs.randn(1, d).astype(np.float32) * 0.1 for d in dims[1:]]
    x = rs.randn(n, dims[0]).astype(np.float32)
    g = rs.randn(n, dims[-1]).astype(np.float32)
    return spec, *(torch.as_tensor(a, device=dev) for a in (x, g)), \
        [torch.as_tensor(f, device=dev) for f in flat]


def _assert_close(a, e, rtol, what):
    err = float((a - e).abs().max())
    bound = rtol * float(e.abs().max())
    assert err <= bound, f"{what}: max err {err:.3e} > {bound:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,n", [("sdf", 1000), ("relu", 333), ("relu259", 333),
                                    ("trunk", 200),
                                    # shapes that can break a tiled MMA: ragged
                                    # and single-row tiles, the 259- and 84-wide
                                    # inputs, the 217-deep layer, last layers of
                                    # 1, 3 and 257
                                    ("sdf", 1), ("sdf", 63), ("sdf", 65),
                                    ("sdf_value", 1000), ("sdf_value", 1),
                                    ("relu259", 65), ("relu259", 1000),
                                    ("trunk", 63), ("trunk", 1000), ("relu", 1),
                                    ("wide512", 65), ("wide512", 1000),
                                    ("sp_out", 63), ("sp_out", 1000)])
def test_kernels_match_plain_version(cuda, name, n, compute_dtype):
    """K1 (y and every hidden activation of its stash) and K2 (dx, every dW,
    every db, by the largest error over all rows).

    A relu whose pre-activation is within rounding of 0 opens or closes with
    the order of the sums, and in bf16 also where an activation before it
    rounds the other way; its unit's whole share of the row's gradients then
    comes or goes.  So a relu chain in bf16 is held against autograd through
    the plain chain at the kernel's own gates, at the same tolerance; the
    hidden activations hold the gates themselves (one that differs where the
    plain pre-activation is not small shows there), and a row of dx that is
    off against plain autograd has to be one in which a gate differs."""
    spec, x, g, flat = _make(name, n, compute_dtype, cuda)
    t_f, t_b = TOL[("fwd", compute_dtype)], TOL[("bwd", compute_dtype)]
    leaves = [a.clone().requires_grad_(True) for a in [x] + flat]
    y_ref, h_ref = fm.chain_hidden_reference(spec, *leaves)
    assert torch.equal(y_ref, fm.chain_mlp_reference(spec, x, *flat))
    ref = torch.autograd.grad(torch.sum(y_ref * g), leaves)

    fm.reset_launches()
    y = fm.chain_fwd_cuda(spec, x, flat)
    dx, dflat = fm.chain_bwd_cuda(spec, x, g, flat)
    torch.cuda.synchronize()
    assert fm.launches["chain_fwd"] == 1 and fm.launches["chain_bwd"] == 1
    y_k, h_k = fm.chain_hidden_cuda(spec, x, flat)
    _assert_close(y, y_ref.detach(), t_f, "K1")
    assert torch.equal(y_k, y)
    for i, (a, r) in enumerate(zip(h_k, h_ref)):
        _assert_close(a, r.detach(), t_f, f"K1 hidden {i}")
    if compute_dtype == "bfloat16" and "relu" in spec.acts:
        gates = fm.relu_gates(spec, h_k, y_k)
        flipped = torch.zeros(n, dtype=torch.bool, device=cuda)
        for gate, a in zip(gates, h_ref + [y_ref]):
            if gate is not None:
                flipped |= ((a.detach() > 0) != (gate > 0)).any(dim=1)
        row = (dx - ref[0]).abs().amax(dim=1) / ref[0].abs().max()
        assert not ((row > t_b) & ~flipped).any(), "a row of dx is off and no gate differs"
        y_g, _ = fm.chain_hidden_reference(spec, *leaves, gates=gates)
        ref = torch.autograd.grad(torch.sum(y_g * g), leaves)
    for i, (a, r) in enumerate(zip((dx,) + dflat, ref)):
        _assert_close(a, r, t_b, f"K2 grad {i}")


K2_SHAPES = [("sdf", 1000), ("sdf", 1), ("sdf", 63), ("sdf", 65), ("sdf_value", 1000),
             ("relu", 333), ("relu259", 65), ("relu259", 1000), ("trunk", 63),
             ("trunk", 1000), ("jac_skips", 1000), ("wide512", 1000), ("sp_out", 1000)]


@pytest.mark.cuda
@pytest.mark.parametrize("name,n", K2_SHAPES)
def test_k2_data_pass_gives_the_f32_products(cuda, name, n):
    """K2's bf16 data pass, which multiplies by the three bf16 pieces of the
    f32 ``W^T``, held to f32 ``torch.matmul`` (TF32 off) of its own stashes:
    dx within 1e-5 of its scale, every rounded gz within one bf16 unit
    (``data_pass_errors``).  The 3e-2 of the chain tolerance cannot tell a
    dropped piece from the exact split; this sees a dropped ``mid``, and
    ``test_k2_split_probe_gives_the_f32_weights`` a dropped ``lo`` too."""
    spec, x, g, flat = _make(name, n, "bfloat16", cuda)
    kept = {}
    dx, _ = fm.chain_bwd_cuda(spec, x, g, flat, keep=kept)
    torch.cuda.synchronize()
    dx_err, gzs_ulps = fm.data_pass_errors(spec, g, flat, kept, dx)
    assert dx_err <= 1e-5, f"dx {dx_err:.2e}"
    assert gzs_ulps <= 1.0, f"gz off by {gzs_ulps:.2f} bf16 units"


@pytest.mark.cuda
@pytest.mark.parametrize("k,m", [(39, 1), (39, 257), (84, 256), (259, 3), (512, 512)])
def test_k2_split_probe_gives_the_f32_weights(cuda, k, m):
    """``split_probe``: a one-layer chain at one-entry cotangents, whose dx
    is the f32 weights times powers of two in any order of the sums.  K2's
    bf16 data pass gives it within one unit of the last place; without
    ``lo`` it would be off by tens of units (``split_probe_units``)."""
    spec, x, g, flat = fm.split_probe(k, m, 1000, seed=k + m, device=cuda)
    dx, _ = fm.chain_bwd_cuda(spec, x, g, flat)
    torch.cuda.synchronize()
    units = fm.split_probe_units(g, flat, dx)
    assert units <= 1.0, f"dx off by {units:.0f} units of the last place"


# rows the main path gives K1: the legs' 512 rays x 16, BENCH_CFG's sweeps
# and occlusion march of 1024 rays (16 to 128 points a ray), the
# extraction's chunks of 2^21 points
K1_MAIN_N = [8192, 16384, 32768, 65536, 131072, 2 ** 21]


@pytest.mark.cuda
@pytest.mark.parametrize("n", K1_MAIN_N)
def test_k1_at_the_main_paths_shapes(cuda, n):
    """K1's bf16 forward on the value-only SDF chain at full depth, at the
    rows the main path gives it (a CTA walks several 128-row tile pairs from
    65,536 rows on), against the plain chain at the bf16 forward tolerance;
    one launch, every output finite."""
    spec, x, _, flat = _make("sdf_value_full", n, "bfloat16", cuda)
    fm.reset_launches()
    y = fm.chain_fwd_cuda(spec, x, flat)
    torch.cuda.synchronize()
    assert fm.launches["chain_fwd"] == 1
    assert y.shape == (n, 1) and bool(torch.isfinite(y).all())
    _assert_close(y, fm.chain_mlp_reference(spec, x, *flat), TOL[("fwd", "bfloat16")],
                  f"K1 N={n}")


@pytest.mark.cuda
@pytest.mark.parametrize("name,n", [("sdf_value_full", 70000), ("sdf", 70000),
                                    ("relu259", 70000)])
def test_k1_is_the_same_from_run_to_run(cuda, name, n):
    """A CTA takes its tile pairs in a fixed order and every sum's order is
    fixed: two runs of K1's bf16 forward (with its stash: pass 1 of K2, K4
    and K5) give equal bits, over more rows than one turn of the grid."""
    spec, x, _, flat = _make(name, n, "bfloat16", cuda)
    runs = [fm.chain_hidden_cuda(spec, x, flat) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_k2_is_the_same_from_run_to_run_over_many_tile_pairs(cuda):
    """K2's bf16 result over more rows than one turn of K1's grid (pass 1
    is K1's forward): two runs give equal bits."""
    spec, x, g, flat = _make("sdf_value_full", 70000, "bfloat16", cuda)
    runs = []
    for _ in range(2):
        dx, dflat = fm.chain_bwd_cuda(spec, x, g, flat)
        torch.cuda.synchronize()
        runs.append((dx,) + dflat)
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_k2_is_the_same_from_run_to_run(cuda, compute_dtype):
    """db and dW come from per-block and per-split partials summed in a fixed
    order, dx from one thread an element: two runs give equal bits."""
    spec, x, g, flat = _make("sdf", 5000, compute_dtype, cuda)
    runs = []
    for _ in range(2):
        dx, dflat = fm.chain_bwd_cuda(spec, x, g, flat)
        torch.cuda.synchronize()
        runs.append((dx,) + dflat)
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_autograd_function_runs_the_kernels(cuda):
    spec, x, g, flat = _make("relu", 200, "float32", cuda)
    leaves = [a.clone().requires_grad_(True) for a in [x] + flat]
    fm.reset_launches()
    torch.sum(fm.fused_chain_mlp(spec, *leaves) * g).backward()
    assert fm.launches["chain_fwd"] == 1 and fm.launches["chain_bwd"] == 1
    ref = [a.clone().requires_grad_(True) for a in [x] + flat]
    torch.sum(fm.chain_mlp_reference(spec, *ref) * g).backward()
    for a, r in zip(leaves, ref):
        _assert_close(a.grad, r.grad, TOL[("bwd", "float32")], "grad")
    # a CUDA tensor the kernel does not take raises: no plain fallback
    with pytest.raises(ValueError):
        fm.fused_chain_mlp(spec, x.double(), *flat)


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,n", [("sdf", 1000), ("jac_skips", 333), ("sdf", 64),
                                    ("sdf", 1), ("sdf", 63), ("sdf", 65),
                                    ("jac_skips", 1000), ("jac_skips", 1)])
def test_jacobian_kernels_match_plain_version(cuda, monkeypatch, name, n, compute_dtype):
    """K4 (y, j) and K5 (dx, every dW, every db); 40 rows a chunk, so that
    the ragged cases also cross chunks whose last one is short."""
    monkeypatch.setattr(fm, "JAC_CHUNK_ROWS", 40 * 16)
    spec, x, gy, flat = _make(name, n, compute_dtype, cuda)
    gj = torch.as_tensor(np.random.RandomState(9).randn(*x.shape).astype(np.float32),
                         device=cuda)
    leaves = [a.clone().requires_grad_(True) for a in [x] + flat]
    y_ref, j_ref = fm.chain_mlp_with_grad0_reference(spec, *leaves)
    (torch.sum(y_ref * gy) + torch.sum(j_ref * gj)).backward()

    fm.reset_launches()
    y, j = fm.chain_jac_fwd_cuda(spec, x, flat)
    dx, dflat = fm.chain_jac_bwd_cuda(spec, x, gy, gj, flat)
    torch.cuda.synchronize()
    assert fm.launches == {"chain_fwd": 0, "chain_bwd": 0, "chain_jac_fwd": 1,
                           "chain_jac_bwd": 1}
    _assert_close(y, y_ref.detach(), TOL[("fwd", compute_dtype)], "K4 y")
    _assert_close(j, j_ref.detach(), TOL[("bwd", compute_dtype)], "K4 j")
    for i, (a, r) in enumerate(zip((dx,) + dflat, leaves)):
        _assert_close(a, r.grad, TOL[("bwd", compute_dtype)], f"K5 grad {i}")


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_jacobian_backward_is_the_same_from_run_to_run(cuda, monkeypatch, compute_dtype):
    """dW comes from per-split partials summed in a fixed order, with no
    atomics: two runs give equal bits, across chunks too."""
    monkeypatch.setattr(fm, "JAC_CHUNK_ROWS", 2048)
    spec, x, gy, flat = _make("sdf", 5000, compute_dtype, cuda)
    gj = torch.as_tensor(np.random.RandomState(9).randn(*x.shape).astype(np.float32),
                         device=cuda)
    runs = []
    for _ in range(2):
        dx, dflat = fm.chain_jac_bwd_cuda(spec, x, gy, gj, flat)
        torch.cuda.synchronize()
        runs.append((dx,) + dflat)
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("name,n,jac", [
    ("sdf", 1000, False), ("sdf", 1000, True), ("sdf", 65, False), ("sdf", 65, True),
    ("relu259", 333, False), ("jac_skips", 5000, False), ("jac_skips", 5000, True),
    ("sdf_value", 1, False), ("sdf_value", 1, True)])
def test_grouped_dw_kernel_matches_matmul(cuda, name, n, jac):
    """The one-launch dW kernel alone, on random bf16 stashes: every tile is
    ``a1^T b1 + s a2^T b2`` of exact bf16 products, so it agrees with f32
    matmuls of the same stashes to the order of the sums (1e-5), whatever
    rounding the passes before it would have done."""
    spec = fm.ChainSpec(*SPECS[name], compute_dtype="bfloat16")
    lay = fm.mma_layout(spec)
    gen = torch.Generator(device="cpu").manual_seed(n)
    sizes = {"x0": lay.ep, "gj": lay.ep, "h": lay.psum_hidden, "qbar": lay.psum_hidden,
             "p": lay.psum_hidden, "zs": lay.psum}
    bufs = {k: torch.randn(n * w, generator=gen).to(cuda).to(torch.bfloat16)
            for k, w in sizes.items() if jac or k in ("x0", "h", "zs")}
    got = fm._dw_grouped(fm._lib(), spec, n, bufs, jac)
    torch.cuda.synchronize()

    def operand(op):
        name_, l = op
        if l is None:
            return bufs[name_].view(n, lay.ep).float()
        _, wp, _, _, base = lay.layers[l]
        return bufs[name_][n * base:n * (base + wp)].view(n, wp).float()

    want = torch.zeros(lay.wtot, device=cuda)
    slots = lay.weight_slots(spec)
    for slot, i0, mext, c0, next_, a1, b1, a2, b2, scale in fm.dw_work_table(spec, jac):
        off, rp, cp, _, _ = slots[slot]
        tile = operand(a1)[:, i0:i0 + mext].t() @ operand(b1)[:, c0:c0 + next_]
        if a2 is not None:
            tile = tile + scale * (operand(a2)[:, i0:i0 + mext].t()
                                   @ operand(b2)[:, c0:c0 + next_])
        want[off:off + rp * cp].view(rp, cp)[i0:i0 + mext, c0:c0 + next_] = tile
    _assert_close(got, want, 1e-5, "grouped dW")


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_chain_beyond_the_limits_raises(cuda, compute_dtype):
    """No route takes a hidden layer wider than 256, an input wider than 512
    (256 for K4/K5) or more than 16 layers, and neither falls back."""
    rs = np.random.RandomState(0)
    for dims, jac_only in (((39, 272, 272, 1), False), ((520, 256, 3), False),
                           ((39,) + (64,) * 16 + (1,), False),
                           ((259, 256, 256, 3), True)):
        n_l = len(dims) - 1
        spec = fm.ChainSpec(dims, ("softplus100",) * (n_l - 1) + ("none",),
                            (False,) * n_l, (1.0,) * n_l, compute_dtype=compute_dtype)
        flat = [torch.as_tensor(rs.randn(*s).astype(np.float32), device=cuda)
                for s in fm.flat_weight_shapes(spec)]
        flat += [torch.zeros((1, d), device=cuda) for d in dims[1:]]
        x = torch.zeros((8, dims[0]), device=cuda)
        fm.reset_launches()
        with pytest.raises(ValueError):
            fm.chain_mlp_with_grad0(spec, x, *flat)
        if not jac_only:
            with pytest.raises(ValueError):
                fm.fused_chain_mlp(spec, x, *flat)
        assert not any(fm.launches.values())


@pytest.mark.cuda
def test_grad0_autograd_function_runs_the_kernels(cuda):
    spec, x, gy, flat = _make("sdf", 200, "float32", cuda)
    leaves = [a.clone().requires_grad_(True) for a in [x] + flat]
    fm.reset_launches()
    y, j = fm.chain_mlp_with_grad0(spec, *leaves)
    (torch.sum(y * gy) + torch.sum(j ** 2)).backward()
    assert fm.launches["chain_jac_fwd"] == 1 and fm.launches["chain_jac_bwd"] == 1
    ref = [a.clone().requires_grad_(True) for a in [x] + flat]
    yr, jr = fm.chain_mlp_with_grad0_reference(spec, *ref)
    (torch.sum(yr * gy) + torch.sum(jr ** 2)).backward()
    for a, r in zip(leaves, ref):
        _assert_close(a.grad, r.grad, TOL[("bwd", "float32")], "grad")
    # a CUDA tensor the kernels do not take raises: no plain fallback
    with pytest.raises(ValueError):
        fm.chain_mlp_with_grad0(spec, x.double(), *flat)


# chains of the backward walks' cases (``chain_bwd_wgmma_kernel``): inputs 39
# (padded to 48) and 259 wide, a 217-wide layer, last layers of 3; relu, no
# activation and softplus100; a skip on a hidden layer (dx and j from two
# products) and on the last layer
WALK_SPECS = {
    "w39_217": ((39, 217, 256, 3), ("softplus100", "relu", "none"),
                (False, True, False), (1.0, 1 / math.sqrt(2), 1.0)),
    "w259_none": ((259, 128, 64, 3), ("none", "softplus100", "none"),
                  (False, False, True), (0.5, 1.0, 1.0)),
    # K4/K5 take inputs up to 256 wide
    "w64_none": ((64, 217, 128, 3), ("none", "relu", "none"), (False, True, True),
                 (0.5, 1.0, 0.8)),
}
WALK_N = [1, 63, 65, 127, 129, 4097]


def _walk_case(name, n, dev):
    dims, acts, skip, scales = WALK_SPECS[name]
    spec = fm.ChainSpec(dims, acts, skip, scales, compute_dtype="bfloat16")
    rs = np.random.RandomState(n + len(name))
    flat = [(rs.randn(*s) / np.sqrt(s[0])).astype(np.float32)
            for s in fm.flat_weight_shapes(spec)]
    flat += [rs.randn(1, d).astype(np.float32) * 0.1 for d in dims[1:]]
    arrays = [rs.randn(n, dims[0]), rs.randn(n, dims[-1]), rs.randn(n, dims[0])]
    x, g, gj = (torch.as_tensor(a.astype(np.float32), device=dev) for a in arrays)
    return spec, x, g, gj, [torch.as_tensor(f, device=dev) for f in flat]


@pytest.mark.cuda
@pytest.mark.parametrize("n", WALK_N)
@pytest.mark.parametrize("name", list(WALK_SPECS))
def test_k2_backward_walk_matches_plain_version(cuda, name, n):
    """K2's bf16 data pass (its wgmma walk down the layers, the split
    ``W^T``) and its dW GEMM at ragged rows: dx, every dW and db against
    autograd through the plain chain at the kernel's own relu gates (3e-2),
    and the data pass against f32 products of its own stashes (dx 1e-5, the
    rounded gz one bf16 unit).  dx goes to device memory from the
    accumulators, the first product writing it and the others adding."""
    spec, x, g, _, flat = _walk_case(name, n, cuda)
    kept = {}
    dx, dflat = fm.chain_bwd_cuda(spec, x, g, flat, keep=kept)
    torch.cuda.synchronize()
    leaves = [a.clone().requires_grad_(True) for a in [x] + flat]
    gates = fm.relu_gates(spec, kept["hidden"], kept["y"])
    y_g, _ = fm.chain_hidden_reference(spec, *leaves, gates=gates)
    ref = torch.autograd.grad(torch.sum(y_g * g), leaves)
    for i, (a, r) in enumerate(zip((dx,) + dflat, ref)):
        _assert_close(a, r, TOL[("bwd", "bfloat16")], f"K2 grad {i}")
    dx_err, gzs_ulps = fm.data_pass_errors(spec, g, flat, kept, dx)
    assert dx_err <= 1e-5 and gzs_ulps <= 1.0, (dx_err, gzs_ulps)


@pytest.mark.cuda
@pytest.mark.parametrize("n", WALK_N)
@pytest.mark.parametrize("name", ["w39_217", "w64_none"])
def test_k4_k5_backward_walks_match_plain_version(cuda, monkeypatch, name, n):
    """K4's J-pass and K5's J-pass, its reverse and its data pass (wgmma
    walks), with the dW GEMM of both terms, at ragged rows and across
    chunks: y, j, dx, every dW and db against the plain version (3e-2)."""
    monkeypatch.setattr(fm, "JAC_CHUNK_ROWS", 2048)
    spec, x, gy, gj, flat = _walk_case(name, n, cuda)
    leaves = [a.clone().requires_grad_(True) for a in [x] + flat]
    y_ref, j_ref = fm.chain_mlp_with_grad0_reference(spec, *leaves)
    (torch.sum(y_ref * gy) + torch.sum(j_ref * gj)).backward()
    y, j = fm.chain_jac_fwd_cuda(spec, x, flat)
    dx, dflat = fm.chain_jac_bwd_cuda(spec, x, gy, gj, flat)
    torch.cuda.synchronize()
    t = TOL[("bwd", "bfloat16")]
    _assert_close(y, y_ref.detach(), TOL[("fwd", "bfloat16")], "K4 y")
    _assert_close(j, j_ref.detach(), t, "K4 j")
    for i, (a, r) in enumerate(zip((dx,) + dflat, leaves)):
        _assert_close(a, r.grad, t, f"K5 grad {i}")


def _sphere_soup(n_lat, n_lon, radius=0.5, pad_to=256):
    """(v0, e1, e2) of a latitude/longitude sphere, padded with far-away
    degenerate triangles to a multiple of ``pad_to``."""
    th = np.linspace(0.0, np.pi, n_lat + 1)
    ph = np.linspace(0.0, 2 * np.pi, n_lon, endpoint=False)
    grid = np.stack([np.outer(np.sin(th), np.cos(ph)), np.outer(np.sin(th), np.sin(ph)),
                     np.outer(np.cos(th), np.ones_like(ph))], -1) * radius
    tris = []
    for i in range(n_lat):
        for j in range(n_lon):
            a, b = grid[i, j], grid[i, (j + 1) % n_lon]
            c, d = grid[i + 1, j], grid[i + 1, (j + 1) % n_lon]
            tris += [(a, c, b), (b, c, d)]
    tv = np.asarray(tris, np.float32)
    v0, e1, e2 = tv[:, 0], tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0]
    pad = (-len(v0)) % pad_to
    v0 = np.concatenate([v0, np.full((pad, 3), 1e8, np.float32)])
    e1 = np.concatenate([e1, np.zeros((pad, 3), np.float32)])
    e2 = np.concatenate([e2, np.zeros((pad, 3), np.float32)])
    return v0, e1, e2, len(tv)


def _rays(n, seed):
    """A third each: from outside towards the sphere, from inside it, and
    pointing away from it (misses)."""
    rs = np.random.RandomState(seed)
    d = rs.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.empty((n, 3), np.float32)
    k = np.arange(n) % 3
    target = rs.randn(n, 3).astype(np.float32) * 0.2
    o[k == 0] = (target - 2.0 * d)[k == 0]
    o[k == 1] = (rs.rand(n, 3).astype(np.float32) * 0.4 - 0.2)[k == 1]
    o[k == 2] = (target + 2.0 * d)[k == 2]
    return o, d


@pytest.mark.cuda
@pytest.mark.parametrize("n_rays", [1, 1024, 5000])
@pytest.mark.parametrize("n_lat,n_lon", [(6, 8), (90, 180)])
def test_closest_hit_matches_plain_version(cuda, n_rays, n_lat, n_lon):
    v0, e1, e2, n_tris = _sphere_soup(n_lat, n_lon)
    o, d = _rays(n_rays, seed=n_rays)
    tri = [torch.as_tensor(a, device=cuda) for a in (v0, e1, e2)]
    ro, rd = torch.as_tensor(o, device=cuda), torch.as_tensor(d, device=cuda)
    cut = [a[:n_tris] for a in tri]
    index, index_cut = ri.build_cull_index(*tri), ri.build_cull_index(*cut)
    ri.reset_launches()
    t, idx, hit = ri.ray_mesh_closest_hit(ro, rd, *tri, index=index)
    # without the padding rows, which can never be hit: the same answer
    t2, idx2, hit2 = ri.ray_mesh_closest_hit(ro, rd, *cut, index=index_cut)
    torch.cuda.synchronize()
    assert ri.launches == {"closest_hit": 2, "cull_bin": 0}
    rt, ridx, rhit = ri.closest_hit_reference(ro, rd, *tri)
    for a, b in ((t, rt), (idx, ridx), (hit, rhit), (t2, rt), (idx2, ridx), (hit2, rhit)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    if n_rays >= 1024:
        k = torch.arange(n_rays, device=cuda) % 3
        assert hit[k == 0].float().mean() > 0.9 and hit[k == 1].all()
        assert not hit[k == 2].any()
        assert (idx[~hit] == 0).all() and (t[~hit] == ri.MISS_T).all()
    # the same answer on the CPU from the plain version
    ct, cidx, chit = ri.ray_mesh_closest_hit(
        torch.as_tensor(o), torch.as_tensor(d), *(torch.as_tensor(a) for a in (v0, e1, e2)))
    assert torch.equal(chit, hit.cpu())
    np.testing.assert_allclose(ct.numpy(), t.cpu().numpy(), rtol=1e-5)


@pytest.mark.cuda
def test_closest_hit_ties_and_refusals(cuda):
    # two coincident triangles: the lowest index wins whatever the chunking
    tri = np.array([[[-1, -1, 1], [1, -1, 1], [0, 1, 1]]], np.float32)
    tv = np.repeat(tri, 2000, axis=0)
    v0, e1, e2 = tv[:, 0], tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0]
    ro = torch.zeros((300, 3), device=cuda)
    rd = torch.tensor([[0.0, 0.0, 1.0]], device=cuda).repeat(300, 1)
    tri = [torch.as_tensor(a, device=cuda) for a in (v0, e1, e2)]
    for tile in (32, 64, 128):
        t, idx, hit = ri.closest_hit_cuda(ro, rd, ri.build_cull_index(*tri, tile=tile))
        assert hit.all() and (idx == 0).all() and torch.allclose(t, torch.ones_like(t))
    # a CUDA tensor the kernel does not take raises, and so does a call
    # without the index: no plain fallback, no index built behind the caller
    index = ri.build_cull_index(*tri)
    with pytest.raises(ValueError):
        ri.ray_mesh_closest_hit(ro.double(), rd.double(), *tri, index=index)
    with pytest.raises(ValueError, match="CullIndex"):
        ri.ray_mesh_closest_hit(ro, rd, *tri)
    with pytest.raises(ValueError):
        ri.closest_hit_cuda(ro.cpu(), rd.cpu(),
                            ri.build_cull_index(*(torch.as_tensor(a) for a in (v0, e1, e2))))


def _box_case(cuda, tile=8):
    from nunerf_tpu_torch.tracing.probes import adversarial_rays, box_mesh
    verts, tris = box_mesh()
    tv = verts[tris]
    tri = [torch.as_tensor(a, device=cuda)
           for a in (tv[:, 0], tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0])]
    index = ri.build_cull_index(*tri, tile=tile)
    o, d = adversarial_rays(verts, index.box.cpu().numpy())
    return tri, index, torch.as_tensor(o, device=cuda), torch.as_tensor(d, device=cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [8, 32])
def test_culled_closest_hit_is_exact_on_the_adversarial_box(cuda, tile):
    """Rays along the cube's faces, through its edges and vertices, with zero
    (and -0.0) direction components, from origins on the tile boxes' planes:
    t, index and hit equal the brute plain version's bit for bit; the
    kernel's walk finds the tiles of the plain box test, no more, no fewer;
    the pair counters add up."""
    tri, index, o, d = _box_case(cuda, tile)
    stats = torch.zeros(2, dtype=torch.int64, device=cuda)
    got = ri.closest_hit_cuda(o, d, index, stats=stats)
    cand = ri.cull_candidates_cuda(o, d, index)
    torch.cuda.synchronize()
    ref = ri.closest_hit_reference(o, d, *tri)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and torch.equal(a, b)
    plain = ri.cull_candidates_reference(o, d, index)
    assert torch.equal(plain, cand)
    assert int(stats[0]) == int(cand.sum()) and int(stats[1]) == int(cand.sum()) * index.tile
    assert got[2].any() and not got[2].all()


@pytest.mark.cuda
def test_culled_closest_hit_with_nothing_to_do(cuda):
    """No rays; an index with no tiles (every row padding); rays whose box
    tests all fail, so no tile is swept."""
    tri, index, o, d = _box_case(cuda)
    for a in ri.closest_hit_cuda(o[:0], d[:0], index):
        assert a.shape == (0,)
    pad = [torch.full((256, 3), 1e8, device=cuda), torch.zeros((256, 3), device=cuda),
           torch.zeros((256, 3), device=cuda)]
    t, idx, hit = ri.closest_hit_cuda(o, d, ri.build_cull_index(*pad))
    assert (t == ri.MISS_T).all() and not idx.any() and not hit.any()
    away_o = torch.tensor([[0.0, 0.0, 3.0]] * 5, device=cuda)
    away_d = torch.tensor([[0.0, 0.0, 1.0]] * 5, device=cuda)
    stats = torch.zeros(2, dtype=torch.int64, device=cuda)
    t, idx, hit = ri.closest_hit_cuda(away_o, away_d, index, stats=stats)
    assert (t == ri.MISS_T).all() and not idx.any() and not hit.any()
    assert not stats.any() and not ri.cull_candidates_cuda(away_o, away_d, index).any()


@pytest.mark.cuda
def test_culled_closest_hit_in_one_launch_of_a_million_rays(cuda):
    """2^20 rays against the 507 tiles of a 32,400-triangle sphere (532 M
    ray-tile pairs) in one launch: the answer equals the plain version's on a sample of 8,192
    rays, the counters add up to the plain box test's pairs, and two runs
    give the same bits."""
    v0, e1, e2, _ = _sphere_soup(90, 180)
    o, d = _rays(1 << 20, seed=13)
    tri = [torch.as_tensor(a, device=cuda) for a in (v0, e1, e2)]
    ro, rd = torch.as_tensor(o, device=cuda), torch.as_tensor(d, device=cuda)
    index = ri.build_cull_index(*tri)
    assert ro.shape[0] * index.box.shape[0] > 64 << 20
    ri.reset_launches()
    stats = torch.zeros(2, dtype=torch.int64, device=cuda)
    first = ri.closest_hit_cuda(ro, rd, index, stats=stats, tol=ri.BARY_TOL)
    again = ri.closest_hit_cuda(ro, rd, index, tol=ri.BARY_TOL)
    torch.cuda.synchronize()
    assert ri.launches == {"closest_hit": 2, "cull_bin": 0}
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    sub = torch.as_tensor(np.random.RandomState(2).choice(1 << 20, 8192, replace=False),
                          device=cuda)
    ref = ri.closest_hit_reference(ro[sub], rd[sub], *tri, tol=ri.BARY_TOL)
    for a, b in zip(first, ref):
        assert a.dtype == b.dtype and torch.equal(a[sub], b)
    pairs = sum(int(ri.cull_candidates_reference(ro[i:i + 65536], rd[i:i + 65536],
                                                 index).sum())
                for i in range(0, 1 << 20, 65536))
    assert int(stats[0]) == pairs and int(stats[1]) == pairs * index.tile
    assert first[2].any() and not first[2].all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["sphere", "box8", "box32"])
def test_tolerant_closest_hit_matches_tolerant_plain_version(cuda, case):
    """K3 in the tolerant mode (the scene's default, the barycentric
    tolerance of the sweeps) and in the exact mode, each bit-equal to the
    plain version of the same mode: at 1024 rays on a sphere of 32,400
    triangles, and on the adversarial box, where the two modes differ."""
    if case == "sphere":
        v0, e1, e2, _ = _sphere_soup(90, 180)
        o, d = _rays(1024, seed=3)
        tri = [torch.as_tensor(a, device=cuda) for a in (v0, e1, e2)]
        ro, rd = torch.as_tensor(o, device=cuda), torch.as_tensor(d, device=cuda)
        index = ri.build_cull_index(*tri)
    else:
        tri, index, ro, rd = _box_case(cuda, int(case[3:]))
    answers = {}
    for tol in (ri.BARY_TOL, 0.0):
        got = ri.closest_hit_cuda(ro, rd, index, tol=tol)
        torch.cuda.synchronize()
        ref = ri.closest_hit_reference(ro, rd, *tri, tol=tol)
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype and torch.equal(a, b)
        answers[tol] = got
    assert not (answers[0.0][2] & ~answers[ri.BARY_TOL][2]).any()
    if case != "sphere":
        assert (answers[ri.BARY_TOL][2] & ~answers[0.0][2]).any()


@pytest.mark.cuda
def test_trainer_runs_on_the_card(cuda, tmp_path, monkeypatch):
    """Three steps of ``Trainer(cfg).run()`` on a small scene written with
    the port's PNG writer: the store lies on the card, K1 runs the value-only
    SDF sweeps, the validation renders, and a new trainer reloads the
    checkpoint to the same parameters and Adam state."""
    from chip_smoke import SMALL_CFG, write_blender_scene
    from nunerf_tpu_torch.train.trainer import Trainer

    monkeypatch.chdir(tmp_path)
    write_blender_scene(str(tmp_path / "ds" / "tiny"), 4, 1, 32)
    cfg = dict(SMALL_CFG, name="tiny", database_name="nerf/tiny",
               dataset_dir=str(tmp_path / "ds"), model_dir=str(tmp_path / "model"),
               total_step=3, train_log_step=1, save_interval=3, val_interval=3,
               test_ray_num=256, downsample_ratio=0.5)
    tr = Trainer(cfg, device=cuda)
    assert all(v.is_cuda for k, v in tr.store.items() if k != "aux")
    fm.reset_launches()
    best = tr.run()
    torch.cuda.synchronize()
    assert fm.launches["chain_fwd"] > 0 and fm.launches["chain_bwd"] > 0
    assert math.isfinite(best)
    again = Trainer(cfg, device=cuda)
    assert again.load(tr.ckpt_path)[0] == 3 and again.train.n_updates == 3
    for (n, p), (_, q) in zip(tr.renderer.named_parameters(), again.renderer.named_parameters()):
        assert torch.equal(p, q), n
        if p.requires_grad:
            assert torch.equal(tr.train.optimizer.state[p]["exp_avg_sq"],
                               again.train.optimizer.state[q]["exp_avg_sq"]), n


@pytest.mark.cuda
def test_extraction_through_k1_matches_the_plain_f32_extraction(cuda, tmp_path, monkeypatch):
    """``extract_mesh_stage1`` at 64^3 sweeps the stage-1 SDF through K1
    (bf16) on the card; the same weights through the plain f32 chain give a
    mesh whose vertices lie within a chamfer of (h/4)^2, h the grid
    spacing."""
    from chip_smoke import BENCH_CFG
    from nunerf_tpu_torch import cli
    from nunerf_tpu_torch.convert import to_jax_tree
    from nunerf_tpu_torch.models.stage1 import PARAM_KEYS, ShapeRenderer
    from nunerf_tpu_torch.ops.chamfer import chamfer_distance
    from nunerf_tpu_torch.tracing.mesh_ops import load_ply
    from nunerf_tpu_torch.train.trainer import save_checkpoint

    monkeypatch.chdir(tmp_path)
    ckpt = str(tmp_path / "s1.ckpt")
    save_checkpoint(ckpt, 7, to_jax_tree(ShapeRenderer(BENCH_CFG, device=cuda, seed=2),
                                         PARAM_KEYS), {}, 0.0)
    fm.reset_launches()
    k1 = cli.extract_mesh_stage1(BENCH_CFG, ckpt, 64, tag="k1", device=cuda)
    assert fm.launches["chain_fwd"] == 1  # one chunk of 2^21 points
    plain_cfg = dict(BENCH_CFG, fused_sdf_value=False, sdf_mixed_precision=False)
    plain = cli.extract_mesh_stage1(plain_cfg, ckpt, 64, tag="plain", device=cuda)
    assert fm.launches["chain_fwd"] == 1
    assert k1["mesh"] == f"data/meshes/{BENCH_CFG['name']}-7_k1.ply"
    vk, tk = load_ply(k1["mesh"])
    vp, tp = load_ply(plain["mesh"])
    assert len(tk) > 1000 and abs(len(tk) - len(tp)) <= 0.01 * len(tp)
    d1, d2 = chamfer_distance(vk, vp, device=cuda)
    assert float(d1) + float(d2) <= (2.0 / 63 / 4) ** 2


@pytest.mark.cuda
def test_shell_step_on_the_card_matches_the_cpu(cuda):
    """A small curvature-shell step with K3 on the card against the same
    step on the CPU (``chip_smoke.phase_small_check_shell``)."""
    from chip_smoke import phase_small_check_shell

    phase_small_check_shell(cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 4, 15])
def test_device_erosion_equals_its_twin(cuda, k):
    """The mask eroder's max-pool on the card against the numpy minimum
    filter: integers in f32, exact."""
    from nunerf_tpu_torch.tools.render_mask import erode, erode_reference

    rs = np.random.RandomState(k)
    m = (rs.rand(203, 317) > 0.2).astype(np.uint8) * 255
    m[40:150, 60:250] = 255
    np.testing.assert_array_equal(erode(m, k, cuda), erode_reference(m, k))


@pytest.mark.cuda
def test_render_masks_with_k3_match_the_plain_closest_hit(cuda, tmp_path):
    """``render_masks`` on the card (K3, tolerant) writes the masks that the
    plain closest hit of the same scene gives, pixel for pixel."""
    from chip_smoke import lumpy_sphere_mesh, write_blender_scene
    from nunerf_tpu_torch.data import image_io
    from nunerf_tpu_torch.data.database import parse_database_name
    from nunerf_tpu_torch.tools import render_mask as rm
    from nunerf_tpu_torch.tracing.mesh_ops import save_ply
    from nunerf_tpu_torch.tracing.scene import Scene

    write_blender_scene(str(tmp_path / "ds" / "tiny"), 3, 1, 64)
    mesh = str(tmp_path / "outer.ply")
    save_ply(mesh, *lumpy_sphere_mesh(48))
    cfg = {"database_name": "nerf/tiny", "dataset_dir": str(tmp_path / "ds"), "is_nerf": True}
    before = ri.launches["closest_hit"]
    out = rm.render_masks(cfg, mesh, chunk=1000, device=cuda)
    assert ri.launches["closest_hit"] - before == 4 * 5  # 4 views of 4096 rays
    plain = Scene(mesh, device=cuda, use_kernel=False)
    db = parse_database_name("nerf/tiny", str(tmp_path / "ds"))
    for i in db.get_img_ids():
        o, d, h, w = rm.view_rays(db, i, True)
        want = rm.hit_mask(plain, o, d, h, w)
        got = image_io.imread(rm.mask_path(db.root, "mask", db.get_image_name(i)))
        assert want.any() and not want.all()
        np.testing.assert_array_equal(got, want)
    assert out.endswith("mask")


@pytest.mark.cuda
def test_real_boot_render_mask_with_k3_matches_the_plain_closest_hit(cuda, tmp_path):
    """``real_boot``'s ``render-mask`` on the card: its config
    (``configs/shape/real/nested_real_boot.yaml``: the capture layout, NeRO
    rays, the ``rawmask`` database; its size cut to the tiny capture's 32
    pixels) on a ``synth-scene --colmap --shell`` capture of 8 views and a
    small mesh; the masks K3 writes are the plain closest hit's, exactly,
    as {0, 255} PNGs."""
    import os

    from chip_smoke import lumpy_sphere_mesh
    from nunerf_tpu_torch import cli
    from nunerf_tpu_torch.config import load_cfg
    from nunerf_tpu_torch.data import image_io
    from nunerf_tpu_torch.data.database import parse_database_name
    from nunerf_tpu_torch.tools import render_mask as rm
    from nunerf_tpu_torch.tracing.mesh_ops import save_ply
    from nunerf_tpu_torch.tracing.scene import Scene

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cli.synth_scene(str(tmp_path / "ds" / "nested_real"), n_train=8, size=32, shell=True,
                    colmap=True)
    mesh = str(tmp_path / "outer.ply")
    save_ply(mesh, *lumpy_sphere_mesh(48))
    cfg = load_cfg(os.path.join(root, "configs/shape/real/nested_real_boot.yaml"))
    assert cfg["database_name"] == "custom/nested_real/128/rawmask" and not cfg["is_nerf"]
    cfg.update(database_name="custom/nested_real/32/rawmask", dataset_dir=str(tmp_path / "ds"))
    before = ri.launches["closest_hit"]
    out = rm.render_masks(cfg, mesh, chunk=1000, device=cuda)
    db = parse_database_name(cfg["database_name"], cfg["dataset_dir"])
    ids = db.get_img_ids()
    assert len(ids) == 8 and ri.launches["closest_hit"] - before > 0
    plain = Scene(mesh, device=cuda, use_kernel=False)
    for i in ids:
        o, d, h, w = rm.view_rays(db, i, False)
        want = rm.hit_mask(plain, o, d, h, w)
        got = image_io.imread(rm.mask_path(db.root, "mask", db.get_image_name(i)))
        assert want.any() and not want.all()
        assert got.dtype == np.uint8 and set(np.unique(got)) <= {0, 255}
        np.testing.assert_array_equal(got, want)
    # the boot database reads these raw silhouettes back as its masks
    assert out.endswith("mask")
    assert db.get_mask(ids[0]) is not None


@pytest.mark.cuda
def test_world_size_1_nccl_step_equals_the_plain_step(cuda, tmp_path):
    """Three small stage-1 steps at 25000 (perturbed samples, an occlusion
    subset of 64 points) and three small stage-2 steps through the mesh of a
    one-rank ``nccl`` group, where every collective runs (the global sums,
    the occlusion mask's gather, the gradient all-reduce): bit-equal to the
    same steps with no mesh (``chip_smoke.phase_parallel`` at full width)."""
    import torch.distributed as dist
    from chip_smoke import SMALL_CFG, SMALL_S2_CFG, parallel_steps
    from nunerf_tpu_torch.parallel.mesh import make_mesh
    from nunerf_tpu_torch.tracing.mesh_ops import extract_geometry
    from nunerf_tpu_torch.tracing.scene import Scene

    scene = Scene(extract_geometry(lambda p: np.linalg.norm(p, axis=-1) - 0.5, resolution=16),
                  tile=512, device=cuda)
    cfgs = (dict(SMALL_CFG, perturb=1.0, occ_loss_max_pn=64), SMALL_S2_CFG)
    ref = {k: parallel_steps(k, cuda, None, scene, 3, *cfgs) for k in ("s1", "s2")}
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'rendezvous'}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(1)
        got = {k: parallel_steps(k, cuda, mesh, scene, 3, *cfgs) for k in ("s1", "s2")}
    finally:
        dist.destroy_process_group()
    for k in ("s1", "s2"):
        assert got[k]["terms"] == ref[k]["terms"], k
        assert got[k]["collectives_per_step"] > 0 and len(got[k]["reduce_ms"]) == 3
        for n, p in ref[k]["params"].items():
            assert torch.equal(got[k]["params"][n], p), (k, n)
    assert got["s1"]["launches"]["chain_fwd"] > 0 and got["s2"]["launches"]["closest_hit"] > 0
