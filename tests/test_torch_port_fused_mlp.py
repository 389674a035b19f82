"""The port's chain MLP (K1/K2's plain version, and the wrapper's CPU
dispatch) against the JAX ``fused_chain_mlp`` - K1 and K2 in Pallas
interpret mode, as ``tests/test_fused_mlp.py`` runs them - and against the
JAX ``chain_mlp_reference``.

f32: forward within 1e-5 of the output's scale, gradients within 1e-4 of
each gradient's scale (sums in another order).  The CUDA kernels themselves run
only on the card (``tests/test_torch_port_cuda.py``).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nunerf_tpu.ops import fused_mlp as jfm
from nunerf_tpu_torch.ops import fused_mlp as tfm
from port_helpers import assert_close, t

SPECS = {
    # the SDF chain's shape: softplus100, a NeuS skip (1/sqrt(2)), value-only
    "sdf_value": ((39, 64, 25, 64, 1), ("softplus100",) * 3 + ("none",),
                  (False, False, True, False),
                  (1.0, 1.0, 1 / math.sqrt(2), 1.0)),
    # a predictor head: relu chain with a 3-wide linear output
    "relu_predictor": ((131, 64, 64, 64, 3), ("relu",) * 3 + ("none",),
                       (False,) * 4, (1.0,) * 4),
}


def _make(name, n, seed, compute_dtype="float32"):
    dims, acts, skip, scales = SPECS[name]
    jspec = jfm.ChainSpec(dims, acts, skip, scales, compute_dtype=compute_dtype)
    tspec = tfm.ChainSpec(dims, acts, skip, scales, compute_dtype=compute_dtype)
    rs = np.random.RandomState(seed)
    flat = [(rs.randn(*s) / np.sqrt(s[0])).astype(np.float32)
            for s in tfm.flat_weight_shapes(tspec)]
    flat += [rs.randn(1, d).astype(np.float32) * 0.1 for d in dims[1:]]
    x = rs.randn(n, dims[0]).astype(np.float32)
    g = rs.randn(n, dims[-1]).astype(np.float32)
    return jspec, tspec, x, flat, g


@pytest.mark.parametrize("name,n", [("sdf_value", 300), ("relu_predictor", 77)])
def test_chain_matches_jax_kernels_and_reference(name, n):
    jspec, tspec, x, flat, g = _make(name, n, seed=len(name) + n)
    assert tfm.flat_weight_shapes(tspec) == jfm._flat_weight_shapes(jspec)
    jx, jflat = jnp.asarray(x), [jnp.asarray(f) for f in flat]

    y_kernel = jfm.fused_chain_mlp(jspec, jx, *jflat)        # K1, interpret
    y_ref = jfm.chain_mlp_reference(jspec, jx, *jflat)

    tx = t(x).requires_grad_(True)
    tflat = [t(f).requires_grad_(True) for f in flat]
    y = tfm.fused_chain_mlp(tspec, tx, *tflat)              # CPU: plain version
    assert y.shape == (n, tspec.dims[-1]) and y.dtype == torch.float32
    assert_close(y, y_kernel, 1e-5, what="vs K1")
    assert_close(y, y_ref, 1e-5, what="vs reference")

    torch.sum(y * t(g)).backward()
    args = (0,) + tuple(range(1, len(flat) + 1))

    def jloss(fn):
        return lambda xx, *ff: jnp.sum(fn(jspec, xx, *ff) * g)

    jg_kernel = jax.grad(jloss(jfm.fused_chain_mlp), argnums=args)(jx, *jflat)  # K2
    jg_ref = jax.grad(jloss(jfm.chain_mlp_reference), argnums=args)(jx, *jflat)
    for i, a in enumerate([tx] + tflat):
        assert_close(a.grad, jg_kernel[i], 1e-4, what=f"grad {i} vs K2")
        assert_close(a.grad, jg_ref[i], 1e-4, what=f"grad {i} vs reference")


def test_bf16_plain_version_follows_the_kernel():
    """In bf16 the plain version rounds matmul operands and hidden
    activations and keeps the last layer f32, as the TPU kernel's
    ``_forward_tile``: held to JAX K1 in interpret mode within 1e-2 of the
    scale (bf16 roundings that flip with the sum order)."""
    jspec, tspec, x, flat, _ = _make("sdf_value", 200, seed=3,
                                     compute_dtype="bfloat16")
    y = tfm.chain_mlp_reference(tspec, t(x), *[t(f) for f in flat])
    yk = jfm.fused_chain_mlp(jspec, jnp.asarray(x), *[jnp.asarray(f) for f in flat])
    assert_close(y, yk, 1e-2)
    # the f32 chain is measurably different: the rounding is really there
    y32 = tfm.chain_mlp_reference(_make("sdf_value", 200, 3)[1], t(x),
                                  *[t(f) for f in flat])
    assert (y - y32).abs().max() > 1e-4


def test_wrapper_dispatch_and_layout():
    _, tspec, x, flat, _ = _make("sdf_value", 10, seed=4)
    tfm.reset_launches()
    y = tfm.fused_chain_mlp(tspec, t(x), *[t(f) for f in flat])
    assert torch.equal(y, tfm.chain_mlp_reference(tspec, t(x), *[t(f) for f in flat]))
    assert tfm.launches["chain_fwd"] == 0 and tfm.launches["chain_bwd"] == 0
    with pytest.raises(ValueError):
        tfm.chain_fwd_cuda(tspec, t(x), [t(f) for f in flat])
    meta, scales, wsum = tfm._layout(tspec)
    # per layer: in, out, W_h, W_x, W_h^T, W_x^T, bias, act, stash offsets
    assert meta[9 * 2:9 * 3] == (25, 64, 39 * 64 + 64 * 25, 39 * 64 + 64 * 25 + 25 * 64,
                                 39 * 64 + 64 * 25, 39 * 64 + 64 * 25 + 25 * 64,
                                 64 + 25, tfm.ACT_CODES["softplus100"], 64 + 25)
    assert wsum == 64 + 25 + 64 + 1 and scales == tspec.scales

