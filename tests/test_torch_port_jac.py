"""The port's value+Jacobian chain (K4/K5's plain version, and the wrapper's
CPU dispatch) against the JAX ``chain_mlp_with_grad0`` - K4 and K5 in Pallas
interpret mode, as ``tests/test_fused_mlp.py`` runs them - and against the
JAX ``chain_mlp_with_grad0_reference``; and ``fused_sdf_all`` against the JAX
``fused_sdf_all`` and the port's own ``sdf_value_feature_grad``.

f32: ``y`` within 1e-5 and ``j`` within 1e-4 of their scale, gradients within
1e-4 of each gradient's scale (sums in another order; the second derivative
of softplus(beta=100) multiplies rounding by 100).  The CUDA kernels
themselves run only on the card (``tests/test_torch_port_cuda.py``).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nunerf_tpu.fields.sdf import SDFNetwork as JSDFNetwork
from nunerf_tpu.fields.sdf import fused_sdf_all as j_fused_sdf_all
from nunerf_tpu.ops import fused_mlp as jfm
from nunerf_tpu_torch.convert import flat_leaves, load_jax_params, to_jax_tree
from nunerf_tpu_torch.fields.sdf import (
    SDFNetwork,
    fused_sdf_all,
    sdf_value_feature_grad,
)
from nunerf_tpu_torch.ops import fused_mlp as tfm
from port_helpers import assert_close, jitter_tree, t

SP3 = ("softplus100",) * 3 + ("none",)
SPECS = {
    # the SDF chain's shape: a NeuS skip (1/sqrt(2)), sdf + 128 features out
    "sdf": ((39, 128, 89, 128, 129), SP3, (False, False, True, False),
            (1.0, 1.0, 1 / math.sqrt(2), 1.0)),
    # a skip on layer 1 and a relu among the activations
    "skip1": ((20, 64, 64, 64, 5), ("softplus100", "relu", "softplus100", "none"),
              (False, True, False, False), (1.0, 0.5, 1.0, 1.0)),
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
    gy = rs.randn(n, dims[-1]).astype(np.float32)
    gj = rs.randn(n, dims[0]).astype(np.float32)
    return jspec, tspec, x, flat, gy, gj


def _jax_grads(fn, jspec, x, flat, gy, gj):
    def loss(xx, *ff):
        y, j = fn(jspec, xx, *ff)
        return jnp.sum(y * gy) + jnp.sum(j * gj)

    args = tuple(range(len(flat) + 1))
    return jax.grad(loss, argnums=args)(jnp.asarray(x), *[jnp.asarray(f) for f in flat])


def _port_grads(tspec, x, flat, gy, gj):
    leaves = [t(a).requires_grad_(True) for a in [x] + flat]
    y, j = tfm.chain_mlp_with_grad0(tspec, *leaves)      # CPU: plain version
    (torch.sum(y * t(gy)) + torch.sum(j * t(gj))).backward()
    return y, j, [a.grad for a in leaves]


# 150 and 77 are ragged against the kernels' 64-row tiles
@pytest.mark.parametrize("name,n", [("sdf", 150), ("skip1", 77)])
def test_grad0_matches_jax_kernels_and_reference(name, n):
    jspec, tspec, x, flat, gy, gj = _make(name, n, seed=len(name) + n)
    jx, jflat = jnp.asarray(x), [jnp.asarray(f) for f in flat]
    yk, jk = jfm.chain_mlp_with_grad0(jspec, jx, *jflat)            # K4, interpret
    yr, jr = jfm.chain_mlp_with_grad0_reference(jspec, jx, *jflat)

    y, j, grads = _port_grads(tspec, x, flat, gy, gj)
    assert y.shape == (n, tspec.dims[-1]) and j.shape == (n, tspec.dims[0])
    assert y.dtype == j.dtype == torch.float32
    for what, ye, je in (("K4", yk, jk), ("reference", yr, jr)):
        assert_close(y, ye, 1e-5, what=f"y vs {what}")
        assert_close(j, je, 1e-4, what=f"j vs {what}")

    gk = _jax_grads(jfm.chain_mlp_with_grad0, jspec, x, flat, gy, gj)   # K5
    gr = _jax_grads(jfm.chain_mlp_with_grad0_reference, jspec, x, flat, gy, gj)
    for i, g in enumerate(grads):
        assert_close(g, gk[i], 1e-4, what=f"grad {i} vs K5")
        assert_close(g, gr[i], 1e-4, what=f"grad {i} vs reference")


def test_grad0_bf16_plain_version_follows_the_kernels():
    """In bf16 the plain version rounds where K4 and K5 do (operands, hidden
    activations, ``p = q * act'``): held to the JAX kernels in interpret mode
    within 1e-2 (values) and 3e-2 (gradients) of scale - bf16 roundings flip
    with the sum order - and measurably apart from the f32 chain."""
    jspec, tspec, x, flat, gy, gj = _make("sdf", 130, seed=3, compute_dtype="bfloat16")
    yk, jk = jfm.chain_mlp_with_grad0(jspec, jnp.asarray(x),
                                      *[jnp.asarray(f) for f in flat])
    y, j, grads = _port_grads(tspec, x, flat, gy, gj)
    assert_close(y, yk, 1e-2, what="y")
    assert_close(j, jk, 1e-2, what="j")
    gk = _jax_grads(jfm.chain_mlp_with_grad0, jspec, x, flat, gy, gj)
    for i, g in enumerate(grads):
        assert_close(g, gk[i], 3e-2, what=f"grad {i}")
    y32, j32, _ = _port_grads(_make("sdf", 130, 3)[1], x, flat, gy, gj)
    assert (y - y32).abs().max() > 1e-4 and (j - j32).abs().max() > 1e-4


def test_grad0_empty_batch_dispatch_and_refusals():
    _, tspec, x, flat, gy, gj = _make("sdf", 0, seed=5)
    y, j, grads = _port_grads(tspec, x, flat, gy, gj)
    assert y.shape == (0, 129) and j.shape == (0, 39)
    assert all(g is not None and not g.any() for g in grads[1:])

    _, tspec, x, flat, _, _ = _make("sdf", 10, seed=6)
    tfm.reset_launches()
    tflat = [t(f) for f in flat]
    y, j = tfm.chain_mlp_with_grad0(tspec, t(x), *tflat)
    yr, jr = tfm.chain_mlp_with_grad0_reference(tspec, t(x), *tflat)
    assert torch.equal(y, yr) and torch.equal(j, jr)
    assert torch.equal(y, tfm.chain_mlp_reference(tspec, t(x), *tflat))
    assert not any(tfm.launches.values())
    # the kernels' wrappers take CUDA tensors only
    with pytest.raises(ValueError):
        tfm.chain_jac_fwd_cuda(tspec, t(x), tflat)
    with pytest.raises(ValueError):
        tfm.chain_jac_bwd_cuda(tspec, t(x), y, j, tflat)
    # a chain whose last layer is not linear has no value+Jacobian form
    relu = tfm.ChainSpec((39, 64, 3), ("relu", "relu"), (False, False), (1.0, 1.0))
    with pytest.raises(ValueError, match="linear last layer"):
        tfm.chain_mlp_with_grad0_reference(relu, t(x), *tflat)


def test_fused_gates_read_the_env(monkeypatch):
    for name, fn in (("NUNERF_FUSED_SDF", tfm.use_fused_sdf),
                     ("NUNERF_FUSED_MLP", tfm.use_fused_mlp)):
        monkeypatch.delenv(name, raising=False)
        assert fn() is False
        for val, want in (("1", True), ("0", False), ("false", False), ("", False)):
            monkeypatch.setenv(name, val)
            assert fn() is want, (name, val)


@pytest.fixture(scope="module")
def sdf_pair():
    jmod = JSDFNetwork(n_layers=4, d_hidden=128, d_out=129, skip_in=(2,))
    x = np.random.RandomState(2).randn(100, 3).astype(np.float32) * 0.5
    params = jitter_tree(jmod.init(jax.random.PRNGKey(1), jnp.asarray(x)), 3, 0.05)
    tmod = SDFNetwork(n_layers=4, d_hidden=128, d_out=129, skip_in=(2,), device="cpu")
    load_jax_params(tmod, params)
    return jmod, tmod, params, x


def _eikonal_loss(v, f, g, lib):
    norm = (g ** 2).sum(-1) ** 0.5
    return lib.mean((norm - 1.0) ** 2) + lib.mean(v ** 2) + lib.mean(f ** 2)


def test_fused_sdf_all_matches_jax_and_the_double_backward(sdf_pair):
    """Values, and the gradient of an eikonal-style loss THROUGH the normal,
    against the JAX ``fused_sdf_all`` (K4/K5 in interpret mode) and against
    the port's autograd double backward."""
    jmod, tmod, params, x = sdf_pair
    jv, jf, jg = j_fused_sdf_all(jmod, params, jnp.asarray(x))
    for fn in (fused_sdf_all, sdf_value_feature_grad):
        v, f, g = fn(tmod, t(x))
        assert v.shape == (100,) and f.shape == (100, 128) and g.shape == (100, 3)
        assert_close(v, jv, 1e-5, what=f"{fn.__name__} sdf")
        assert_close(f, jf, 1e-5, what=f"{fn.__name__} feats")
        assert_close(g, jg, 1e-4, what=f"{fn.__name__} grad")

    jgrads = flat_leaves(jax.grad(lambda p: _eikonal_loss(
        *j_fused_sdf_all(jmod, p, jnp.asarray(x)), jnp))(params))
    got = {}
    for fn in (fused_sdf_all, sdf_value_feature_grad):
        tmod.zero_grad()
        _eikonal_loss(*fn(tmod, t(x)), torch).backward()
        got[fn.__name__] = flat_leaves(to_jax_tree(tmod, what="grad"))
        assert sorted(got[fn.__name__]) == sorted(jgrads)
        for k, e in jgrads.items():
            assert_close(got[fn.__name__][k], e, 2e-4, what=f"{fn.__name__} {k}")
    for k, e in got["sdf_value_feature_grad"].items():
        assert_close(got["fused_sdf_all"][k], e, 1e-4, what=f"fused vs plain {k}")


def test_fused_sdf_all_differentiates_to_the_points(sdf_pair):
    """The pull-back through ``x * scale`` and the positional encoding is
    itself differentiable in ``x``: d loss / d points of the two paths agree,
    with a scale other than 1 and under ``no_grad`` for the values."""
    _, tmod, _, x = sdf_pair
    tmod.scale = 1.3
    try:
        got = []
        for fn in (fused_sdf_all, sdf_value_feature_grad):
            pts = t(x).requires_grad_(True)
            _eikonal_loss(*fn(tmod, pts), torch).backward()
            got.append(pts.grad)
            with torch.no_grad():
                v, f, g = fn(tmod, t(x))
            assert not (v.requires_grad or f.requires_grad or g.requires_grad)
        assert_close(got[0], got[1].numpy(), 1e-4, what="d loss / d points")
        lead = fused_sdf_all(tmod, t(x).reshape(4, 25, 3))
        assert lead[0].shape == (4, 25) and lead[2].shape == (4, 25, 3)
    finally:
        tmod.scale = 1.0
