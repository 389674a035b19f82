"""The port's bf16 dense layers and SDF round where the JAX ones do (CPU).

JAX's ``WNDense`` and ``Dense`` in bf16 take ``jnp.dot(x_bf16, k_bf16,
preferred_element_type=f32)``, add the f32 bias in f32 and round once to
bf16.  A layer that rounds the product to bf16 first and the biased sum
again loses most of a result's bits where the products nearly cancel the
bias, and then disagrees with JAX's bf16 in about a quarter of its outputs.

The same numpy-seeded inputs and the same JAX-initialised, jittered weights
(carried by ``nunerf_tpu_torch.convert``) go through both packages:
- one 256x256 layer: at most ``MAX_UNEQUAL`` of the outputs not bit-equal to
  JAX's, and each output within one bf16 unit of JAX's plus what the order
  of the f32 sums and the weight norm's own f32 rounding may move it (a
  kernel element whose bf16 rounding flips); its gradients within one bf16
  unit of their scale;
- a 4-layer bf16 ``SDFNetwork``: value and normal within ``SDF_BOUNDS`` of
  the JAX f32 value's scale, set from the repaired port with the parent's
  gaps beside them.  The normal also needs softplus's derivative as JAX
  takes it (``exp(t - softplus(t))``).

Controls put back either rounding the port had (a layer rounding twice;
softplus differentiated through its forward's ops) and check that the same
comparison then breaks its bound, so neither fault can come back unseen.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nunerf_tpu.fields.mlp import Dense as JDense
from nunerf_tpu.fields.mlp import WNDense as JWNDense
from nunerf_tpu.fields.sdf import SDFNetwork as JSDF
from nunerf_tpu.fields.sdf import sdf_value_feature_grad as j_sdf_vfg
from nunerf_tpu_torch.convert import flat_leaves, load_jax_params, to_jax_tree
from nunerf_tpu_torch.fields import mlp, sdf
from nunerf_tpu_torch.fields.mlp import Dense, WNDense
from nunerf_tpu_torch.fields.sdf import SDFNetwork, sdf_value_feature_grad
from port_helpers import jitter_tree, t

N_ROWS, WIDTH, N_POINTS = 8192, 256, 4096
MAX_UNEQUAL = 1e-3  # measured 6.3e-4 (WNDense) and 6.5e-5 (Dense); 0.27 rounding twice
# (value, normal) of the JAX f32 value's scale; measured 5.5e-4 / 3.7e-3.
# Rounding twice: 1.7e-3 / 5.8e-3; softplus differentiated through its
# forward's ops: 5.5e-4 / 8.0e-3; both: 1.7e-3 / 7.5e-3.
SDF_BOUNDS = (1.0e-3, 5.0e-3)
LAYERS = {"wndense": (JWNDense, WNDense), "dense": (JDense, Dense)}
_RS = np.random.RandomState(5)
X_ROWS, W_ROWS = (_RS.randn(N_ROWS, WIDTH).astype(np.float32) for _ in range(2))


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jit_rounding_every_op(f, *args):
    """``f(*args)`` compiled whole, with XLA's excess precision off: every
    bf16 op rounds where the JAX code says, as run op by op.  With it on,
    XLA's CPU fusions keep some elementwise bf16 chains in f32 (on this
    SDF's normal, 4.8e-3 of scale against op by op)."""
    return jax.jit(f).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _of_scale(got, want, want32):
    got, want, want32 = (np.asarray(x, np.float64) for x in (got, want, want32))
    return np.abs(got - want).max() / np.abs(want32).max()


@functools.lru_cache(maxsize=None)
def _jax_layers():
    """Both JAX layers on the same rows, from one compile each of the
    init and of the forward and backward: per layer, (params, output,
    parameter gradients, input gradient)."""
    mods = {k: jcls(WIDTH, dtype=jnp.bfloat16) for k, (jcls, _) in LAYERS.items()}
    inits = jax.jit(lambda key, z: {k: m.init(key, z) for k, m in mods.items()})(
        jax.random.PRNGKey(1), jnp.zeros((1, WIDTH)))
    params = {k: jitter_tree(inits[k], 2) for k in LAYERS}

    def grads(ps, xx, ww):  # ww an argument: a closed-over one is folded slowly
        def loss(m):
            def f(p, xi):
                y = m.apply(p, xi)
                return jnp.sum(y.astype(jnp.float32) * ww), y
            return f
        return {k: jax.value_and_grad(loss(m), argnums=(0, 1), has_aux=True)(ps[k], xx)
                for k, m in mods.items()}

    out = jit_rounding_every_op(grads, params, jnp.asarray(X_ROWS), jnp.asarray(W_ROWS))
    return {k: (mods[k], params[k], out[k][0][1], *out[k][1]) for k in LAYERS}


def _layer(kind):
    """(unequal share, largest error over its bound, largest gradient error
    in bf16 units of its scale) of one bf16 layer against JAX's."""
    jmod, params, jy, jg, jdx = _jax_layers()[kind]
    tmod = LAYERS[kind][1](WIDTH, WIDTH, dtype=torch.bfloat16, device="cpu")
    load_jax_params(tmod, params)
    x, w = X_ROWS, W_ROWS
    xt = t(x).requires_grad_(True)
    y = tmod(xt)
    assert y.dtype == torch.bfloat16
    torch.sum(y.float() * t(w)).backward()

    got, want = y.detach().float(), torch.as_tensor(np.asarray(jy, np.float32))
    unequal = (got != want).float().mean().item()
    # one bf16 unit at the output, the f32 sums' order (each of WIDTH terms
    # within 2^-24 of their magnitude) and the kernels' own bf16 difference
    kt = (tmod.weight() if kind == "wndense" else tmod.kernel).detach().bfloat16().float()
    kj = torch.as_tensor(np.array(jmod.apply(params, jnp.asarray(x[:1]), return_weights=True)[0],
                                    np.float32)).bfloat16().float()
    xb = t(x).bfloat16().float().abs()
    _, e = torch.frexp(torch.maximum(got.abs(), want.abs()))
    bound = (torch.ldexp(torch.ones_like(got), e - 8) + WIDTH * 2.0 ** -24 * (xb @ kt.abs())
             + xb @ (kt - kj).abs())
    over = ((got - want).abs() / bound).max().item()
    grads = flat_leaves(to_jax_tree(tmod, what="grad"))
    grads["x"] = xt.grad.numpy()
    jgrads = dict(flat_leaves(jg), x=np.asarray(jdx))
    units = max(_of_scale(grads[k], v, v) for k, v in jgrads.items()) * 2.0 ** 7
    return unequal, over, units


@functools.lru_cache(maxsize=None)
def _jax_sdf():
    """(points, params, JAX bf16, JAX f32), each JAX (value, normal), of a
    4-layer SDF; both JAX precisions from one compile."""
    x = (np.random.RandomState(3).randn(N_POINTS, 3) * 0.6).astype(np.float32)
    params = jitter_tree(jax.jit(JSDF(n_layers=4, skip_in=(2,)).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 3))), 2)
    applies = [JSDF(n_layers=4, skip_in=(2,), dtype=dt).apply for dt in (jnp.bfloat16, None)]
    outs = jit_rounding_every_op(lambda p, xx: [j_sdf_vfg(a, p, xx) for a in applies],
                                 params, jnp.asarray(x))
    return (x, params, *((np.asarray(js, np.float32), np.asarray(jn, np.float32))
                         for js, _, jn in outs))


def _sdf():
    """The port's bf16 SDF against JAX's: (value, normal) of the JAX f32
    value's scale."""
    x, params, jax16, jax32 = _jax_sdf()
    tmod = SDFNetwork(n_layers=4, skip_in=(2,), dtype=torch.bfloat16, device="cpu")
    load_jax_params(tmod, params)
    with torch.no_grad():
        ts, _, tn = sdf_value_feature_grad(tmod, t(x))
    return [_of_scale(p.float().numpy(), jax16[i], jax32[i]) for i, p in enumerate((ts, tn))]


@pytest.mark.parametrize("case", ["wndense", "dense", "sdf"])
def test_bf16_layers_round_once_after_the_bias_as_jax(case):
    if case in LAYERS:
        unequal, over, units = _layer(case)
        assert unequal <= MAX_UNEQUAL, f"{unequal:.2%} of the outputs differ from JAX's"
        assert over <= 1.0, f"an output is off JAX's by {over:.1f} times its bound"
        assert units <= 1.0, f"a gradient is {units:.2f} bf16 units of its scale off JAX's"
        return
    for what, err, bound in zip(("value", "normal"), _sdf(), SDF_BOUNDS):
        assert err <= bound, f"{what}: {err:.3e} of scale > {bound:.1e}"


def _rounding_twice(x, k, b):
    """A bf16 layer as the port had it: the bf16 product rounded, then the
    f32 bias added and the sum rounded again."""
    return ((x @ k).float() + b).to(torch.bfloat16)


def _softplus_by_autograd(t):
    """softplus differentiated by autograd through its forward's ops."""
    return torch.clamp(t, min=0.0) + torch.log1p(torch.exp(-t.abs()))


CONTROLS = {"rounding_twice": (mlp._Bf16Dense, _rounding_twice),
            "softplus_by_autograd": (sdf._Softplus, _softplus_by_autograd)}


@pytest.mark.parametrize("case,control", [("wndense", "rounding_twice"),
                                          ("dense", "rounding_twice"),
                                          ("sdf", "rounding_twice"),
                                          ("sdf", "softplus_by_autograd")])
def test_the_bounds_catch_each_rounding_the_port_had(case, control, monkeypatch):
    """Controls: with either of the two roundings the port had put back,
    the same comparison breaks its bound (measured beside the bounds)."""
    monkeypatch.setattr(CONTROLS[control][0], "apply", CONTROLS[control][1])
    if case in LAYERS:
        unequal, _, _ = _layer(case)
        assert unequal > 100 * MAX_UNEQUAL, f"only {unequal:.2%} of the outputs differ"
        return
    errs = _sdf()
    assert any(e > b for e, b in zip(errs, SDF_BOUNDS)), f"{errs} within {SDF_BOUNDS}"
