"""The bf16 (tensor-core) route of the chain kernels, as far as the CPU reaches
it: the padded bf16 weight packing, the grouped dW work table, and which of
K5's stashes are bf16-exact.

The kernels themselves run only on the card (``tests/test_torch_port_cuda.py``).
What surrounds them is plain Python: ``MmaLayout``/``pack_mma`` lay the weights
out, and ``dw_work_table`` tells the one dW launch which tile of which weight
is ``a1^T b1 + scale * a2^T b2``.  ``_k5_passes`` below writes K5's passes out
in plain PyTorch with the kernels' rounding points, so the table can be walked
over their intermediates and held against autograd.  No JAX is needed.
"""

import math

import numpy as np
import pytest
import torch

from nunerf_tpu_torch.ops import fused_mlp as fm

SQ2 = 1 / math.sqrt(2)
CHAINS = {
    # the full SDF chain: 39 inputs, the NeuS skip's 217, a 257-wide last layer
    "sdf_full": ((39, 256, 256, 256, 217, 256, 256, 256, 256, 257),
                 ("softplus100",) * 8 + ("none",),
                 (False,) * 4 + (True,) + (False,) * 4,
                 (1.0,) * 4 + (SQ2,) + (1.0,) * 4),
    # the value-only SDF chain: a 1-wide last layer
    "sdf_value": ((39, 256, 217, 256, 1), ("softplus100",) * 3 + ("none",),
                  (False, False, True, False), (1.0, 1.0, SQ2, 1.0)),
    # the NeRF++ trunk: 84 inputs, a post-activation skip
    "trunk": ((84, 256, 256, 256), ("relu",) * 3, (False, False, True), (1.0,) * 3),
    # a material head: 259 inputs, 3 outputs
    "head259": ((259, 256, 256, 256, 3), ("relu",) * 3 + ("none",),
                (False,) * 4, (1.0,) * 4),
    "relu131": ((131, 256, 256, 256, 3), ("relu",) * 3 + ("none",),
                (False,) * 4, (1.0,) * 4),
    # small chains for the gradient checks: odd widths, skips on a hidden and
    # on the last layer, a relu among the softplus layers
    "small_sdf": ((39, 144, 105, 144, 33), ("softplus100",) * 3 + ("none",),
                  (False, False, True, False), (1.0, 1.0, SQ2, 1.0)),
    "small_skips": ((20, 64, 40, 64, 5), ("softplus100", "relu", "softplus100", "none"),
                    (False, True, False, True), (1.0, 0.5, 1.0, 0.7)),
}


def _make(name, n, compute_dtype, seed=5):
    dims, acts, skip, scales = CHAINS[name]
    spec = fm.ChainSpec(dims, acts, skip, scales, compute_dtype=compute_dtype)
    rs = np.random.RandomState(seed)
    flat = [(rs.randn(*s) / np.sqrt(s[0])).astype(np.float32)
            for s in fm.flat_weight_shapes(spec)]
    flat += [rs.randn(1, d).astype(np.float32) * 0.1 for d in dims[1:]]
    x = rs.randn(n, dims[0]).astype(np.float32)
    gy = rs.randn(n, dims[-1]).astype(np.float32)
    gj = rs.randn(n, dims[0]).astype(np.float32)
    return spec, *(torch.as_tensor(a) for a in (x, gy, gj)), [torch.as_tensor(f) for f in flat]


@pytest.mark.parametrize("name", ["sdf_full", "sdf_value", "trunk", "head259", "relu131"])
def test_padded_bf16_packing_round_trips(name):
    spec, _, _, _, flat = _make(name, 1, "bfloat16")
    lay = fm.mma_layout(spec)
    meta = fm._layout(spec)[0]
    slots = lay.weight_slots(spec)
    assert len(slots) == fm.n_weights(spec)
    # the offsets the kernels get (meta: 12 ints a layer) are the layout's,
    # every padded extent a multiple of 16, the slots back to back
    end = 0
    for l, (ip, wp, pwh, pwx, pstash) in enumerate(lay.layers):
        assert meta[12 * l + 9:12 * l + 12] == (pwh, pwx, pstash)
        assert (meta[12 * l], meta[12 * l + 1]) == (spec.dims[l], spec.dims[l + 1])
        assert ip % 16 == 0 and wp % 16 == 0 and ip >= spec.dims[l] and wp >= spec.dims[l + 1]
        assert ip - spec.dims[l] < 16 and wp - spec.dims[l + 1] < 16
        assert pwh == end
        end += ip * wp
        if spec.has_skip[l]:
            assert pwx == end
            end += lay.ep * wp
        else:
            assert pwx == -1
        assert pstash == sum(w for _, w, _, _, _ in lay.layers[:l])
    assert end == lay.wtot and lay.psum == lay.psum_hidden + lay.layers[-1][1]

    for transposed in (False, True):
        pack = fm.pack_mma(spec, flat, transposed=transposed)
        assert pack.dtype == torch.bfloat16 and pack.shape == (lay.wtot,)
        rest = pack.clone().float()
        for w, (off, rp, cp, r, c) in zip(flat, slots):
            assert w.shape == (r, c)
            m = pack[off:off + rp * cp].float()
            m = m.view(cp, rp).t() if transposed else m.view(rp, cp)
            assert torch.equal(m[:r, :c], fm.round_to(w, "bfloat16"))
            # zero padding: nothing of the slot outside [:r, :c] is set
            assert int((m != 0).sum()) == int((m[:r, :c] != 0).sum())
            rest[off:off + rp * cp] = 0
        assert not rest.any()
    # unpack_mma reads the same slots
    for w, u in zip(flat, fm.unpack_mma(spec, fm.pack_mma(spec, flat))):
        assert torch.equal(u.float(), fm.round_to(w, "bfloat16"))


@pytest.mark.parametrize("jac", [False, True])
@pytest.mark.parametrize("name", ["sdf_full", "trunk", "head259", "small_skips"])
def test_dw_work_table_covers_every_weight_once(name, jac):
    if jac and CHAINS[name][1][-1] != "none":
        pytest.skip("the value+Jacobian chain needs a linear last layer")
    spec = fm.ChainSpec(*CHAINS[name], compute_dtype="bfloat16")
    lay = fm.mma_layout(spec)
    slots = lay.weight_slots(spec)
    cover = [torch.zeros(rp, cp, dtype=torch.int32) for _, rp, cp, _, _ in slots]
    for slot, i0, mext, c0, next_, a1, b1, a2, b2, scale in fm.dw_work_table(spec, jac):
        assert 0 < mext <= fm.DW_TILE and 0 < next_ <= fm.DW_TILE
        assert mext % 16 == 0 and next_ % 16 == 0 and i0 % fm.DW_TILE == 0
        assert b1[0] == "zs" and a1[0] in ("x0", "h")
        assert (a2 is None) == (b2 is None)
        if a2 is None:
            assert scale == 0.0
        cover[slot][i0:i0 + mext, c0:c0 + next_] += 1
    assert all(bool((c == 1).all()) for c in cover)


def _d2(act, d):
    return 100.0 * d * (1.0 - d) if act == "softplus100" else torch.zeros_like(d)


def _k5_passes(spec, x, gy, gj, flat):
    """K5's passes in plain PyTorch, with the kernels' rounding points: the
    forward (h), the J-pass (q, p), its reverse (dbar, qbar), the data pass
    (zs, db, dx).  Returns the dW operands by name and layer, and (dx, db,
    the seed's share of the last dW's column 0)."""
    cd = spec.compute_dtype
    n_l = spec.n_layers
    starts = fm._layer_starts(spec)
    wh = [fm.round_to(flat[starts[l]], cd) for l in range(n_l)]
    wx = [fm.round_to(flat[starts[l] + 1], cd) if spec.has_skip[l] else None
          for l in range(n_l)]
    biases = flat[fm.n_weights(spec):]
    s = spec.scales
    x0, gjr = fm.round_to(x, cd), fm.round_to(gj, cd)
    ops = {("x0", None): x0, ("gj", None): gjr}
    h, d = x0, []
    for l in range(n_l):
        z = h @ wh[l] + (x0 @ wx[l] if spec.has_skip[l] else 0.0)
        h = fm._act(spec.acts[l], z * s[l] + biases[l])
        if l < n_l - 1:
            h = fm.round_to(h, cd)
            ops[("h", l)] = h
            d.append(fm._act_grad_from_a(spec.acts[l], h))
    q = (s[-1] * flat[starts[-1]][:, 0])[None, :].expand(x.shape[0], -1)
    for l in reversed(range(n_l - 1)):
        ops[("q", l)] = q
        ops[("p", l)] = fm.round_to(q * d[l], cd)
        q = (ops[("p", l)] @ wh[l].t()) * s[l]
    qbar = gjr
    for l in range(n_l - 1):
        pbar = s[l] * (qbar @ wh[l] + (gjr @ wx[l] if spec.has_skip[l] else 0.0))
        ops[("dbar", l)] = pbar * ops[("q", l)]
        qbar = pbar * d[l]
        if l < n_l - 2:
            qbar = fm.round_to(qbar, cd)
            ops[("qbar", l)] = qbar
    col = [s[-1] * qbar.sum(0), s[-1] * gj.sum(0)]
    g, dx, db = gy, torch.zeros_like(x), [None] * n_l
    for l in reversed(range(n_l)):
        if l == n_l - 1:
            v = g * fm._act_grad_from_a(spec.acts[l], h)
        else:
            v = g * d[l] + ops[("dbar", l)] * _d2(spec.acts[l], d[l])
        db[l] = v.sum(0, keepdim=True)
        zs = fm.round_to(v * s[l], cd)
        ops[("zs", l)] = zs
        if spec.has_skip[l]:
            dx = dx + zs @ wx[l].t()
        if l == 0:
            dx = dx + zs @ wh[l].t()
        else:
            g = zs @ wh[l].t()
    return ops, dx, db, col


def _walk(spec, table, ops):
    """The grouped dW launch in plain PyTorch: every tile of the table, over
    operands zero-padded to the layout's widths; a buffer in ``pack_mma``'s
    layout."""
    lay = fm.mma_layout(spec)
    slots = lay.weight_slots(spec)

    def padded(op):
        t = ops[op]
        width = lay.ep if op[1] is None else lay.layers[op[1]][1]
        return torch.nn.functional.pad(t, (0, width - t.shape[1]))

    out = torch.full((lay.wtot,), float("nan"))
    for slot, i0, mext, c0, next_, a1, b1, a2, b2, scale in table:
        off, rp, cp, _, _ = slots[slot]
        tile = padded(a1)[:, i0:i0 + mext].t() @ padded(b1)[:, c0:c0 + next_]
        if a2 is not None:
            tile = tile + scale * (padded(a2)[:, i0:i0 + mext].t()
                                   @ padded(b2)[:, c0:c0 + next_])
        out[off:off + rp * cp].view(rp, cp)[i0:i0 + mext, c0:c0 + next_] = tile
    assert not torch.isnan(out).any()
    return out


def _assert_close(a, e, rtol, what):
    err = float((a - e).abs().max())
    bound = rtol * float(e.abs().max())
    assert err <= bound, f"{what}: max err {err:.3e} > {bound:.3e}"


@pytest.mark.parametrize("compute_dtype,rtol", [("float32", 1e-4), ("bfloat16", 3e-2)])
@pytest.mark.parametrize("name", ["small_sdf", "small_skips"])
def test_grouped_dw_table_gives_autograd_dw_of_the_jacobian_chain(name, compute_dtype, rtol):
    """K5's table (both terms a tile) walked over the passes' intermediates:
    autograd's dW of ``sum(y gy) + sum(j gj)`` through the plain version, for
    every layer, the skips' W_x and the last layer's column 0 included.  f32:
    nothing is rounded, 1e-4 (sums in another order); bf16: the tolerance the
    card holds K5 to (cotangents rounded where autograd passes them straight
    through)."""
    spec, x, gy, gj, flat = _make(name, 300, compute_dtype)
    leaves = [a.clone().requires_grad_(True) for a in [x] + flat]
    y, j = fm.chain_mlp_with_grad0_reference(spec, *leaves)
    (torch.sum(y * gy) + torch.sum(j * gj)).backward()

    ops, dx, db, col = _k5_passes(spec, x, gy, gj, flat)
    dws = [w.clone() for w in fm.unpack_mma(
        spec, _walk(spec, fm.dw_work_table(spec, jac=True), ops))]
    last = fm._layer_starts(spec)[-1]
    dws[last][:, 0] += col[0]
    if spec.has_skip[-1]:
        dws[last + 1][:, 0] += col[1]
    nw = fm.n_weights(spec)
    _assert_close(dx, leaves[0].grad, rtol, "dx")
    for i, (a, r) in enumerate(zip(dws, leaves[1:1 + nw])):
        assert a.shape == r.shape
        _assert_close(a, r.grad, rtol, f"dW {i}")
    for i, (a, r) in enumerate(zip(db, leaves[1 + nw:])):
        _assert_close(a, r.grad, rtol, f"db {i}")


@pytest.mark.parametrize("name", ["small_sdf", "small_skips"])
def test_grouped_dw_table_gives_autograd_dw_of_the_plain_chain(name):
    """K2's table (one term a tile) over the forward's activations and the
    data pass's gz: autograd's dW of ``sum(chain(x) g)``, f32."""
    spec, x, g, _, flat = _make(name, 300, "float32")
    leaves = [a.clone().requires_grad_(True) for a in [x] + flat]
    torch.sum(fm.chain_mlp_reference(spec, *leaves) * g).backward()
    # K5's passes with a zero Jacobian cotangent are K2's
    ops, dx, db, _ = _k5_passes(spec, x, g, torch.zeros_like(x), flat)
    dws = fm.unpack_mma(spec, _walk(spec, fm.dw_work_table(spec, jac=False), ops))
    _assert_close(dx, leaves[0].grad, 1e-4, "dx")
    for i, (a, r) in enumerate(zip(dws, leaves[1:1 + fm.n_weights(spec)])):
        _assert_close(a, r.grad, 1e-4, f"dW {i}")


@pytest.mark.parametrize("name", ["small_sdf", "small_skips"])
def test_which_stashes_are_bf16_exact(name):
    """h, p, zs and the stored qbar are bf16 values in the plain version, so
    the kernel stores them as bf16 and loses nothing; q and dbar are not, and
    stay f32."""
    spec, x, gy, gj, flat = _make(name, 200, "bfloat16")
    ops, _, _, _ = _k5_passes(spec, x, gy, gj, flat)
    seen = set()
    for (kind, l), t in ops.items():
        exact = torch.equal(t.to(torch.bfloat16).float(), t)
        seen.add(kind)
        if kind in ("x0", "gj", "h", "p", "zs", "qbar"):
            assert exact, f"{kind} of layer {l} is not bf16-exact"
        elif l < spec.n_layers - 2:
            # below the top (whose q is the f32 seed column itself)
            assert not exact, f"{kind} of layer {l} is bf16-exact"
    assert seen == {"x0", "gj", "h", "p", "zs", "qbar", "q", "dbar"}
    # the sizes the wrapper allocates follow: 3 bf16 + 2 f32 stashes of the
    # hidden layers and zs of all layers, under the f32 route's four
    lay = fm.mma_layout(spec)
    rows = 1000
    assert fm.jac_bwd_scratch_bytes(spec, rows) == rows * (
        lay.psum_hidden * 14 + lay.psum * 2)
    f32 = fm.ChainSpec(*CHAINS[name], compute_dtype="float32")
    assert fm.jac_bwd_scratch_bytes(f32, rows) == rows * sum(spec.dims[1:]) * 16


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["trunk", "head259", "small_skips", "small_sdf"])
def test_hidden_reference_is_the_plain_chain(name, compute_dtype):
    """``chain_hidden_reference`` (what the card checks hold a kernel's stash
    and gates against) gives ``chain_mlp_reference``'s output bit for bit and,
    handed the chain's own relu gates, its gradients."""
    spec, x, _, _, flat = _make(name, 64, compute_dtype)
    g = torch.as_tensor(np.random.RandomState(3).randn(64, spec.dims[-1]).astype(np.float32))
    leaves = [a.clone().requires_grad_(True) for a in [x] + flat]
    ref = torch.autograd.grad(torch.sum(fm.chain_mlp_reference(spec, *leaves) * g), leaves)
    y, hidden = fm.chain_hidden_reference(spec, *leaves)
    assert torch.equal(y, fm.chain_mlp_reference(spec, x, *flat))
    assert [h.shape[1] for h in hidden] == list(spec.dims[1:-1])
    gates = fm.relu_gates(spec, [h.detach() for h in hidden], y.detach())
    assert [gt is not None for gt in gates] == [a == "relu" for a in spec.acts]
    y_g, _ = fm.chain_hidden_reference(spec, *leaves, gates=gates)
    assert torch.equal(y_g, y)
    for a, r in zip(torch.autograd.grad(torch.sum(y_g * g), leaves), ref):
        assert torch.equal(a, r)


def test_a_flipped_relu_gate_moves_its_row_alone():
    """One gate of one row opened: that row's dx moves by the unit's whole
    share whatever its pre-activation was, every other row's stays."""
    spec, x, _, _, flat = _make("head259", 32, "float32")
    g = torch.ones((32, 3))
    xs = x.clone().requires_grad_(True)
    y, hidden = fm.chain_hidden_reference(spec, xs, *flat)
    dx = torch.autograd.grad(y.sum(), xs)[0]
    gates = fm.relu_gates(spec, [h.detach() for h in hidden], y.detach())
    unit = int((gates[1][7] == 0).nonzero()[0])
    gates[1][7, unit] = 1.0
    y_f, _ = fm.chain_hidden_reference(spec, xs, *flat, gates=gates)
    dx_f = torch.autograd.grad(torch.sum(y_f * g), xs)[0]
    moved = (dx_f - dx).abs().amax(dim=1)
    assert moved[7] > 1e-3 * dx.abs().max()
    moved[7] = 0
    assert not moved.any()
