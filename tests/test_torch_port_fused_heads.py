"""The ``fused_mlp`` gate of the port: ``Predictor(fused=True)`` and
``NeRFNetwork(fused=True)`` (the fused chain's plain version on the CPU)
against the JAX modules with ``fused=True`` (K1 and K2 in Pallas interpret
mode) and against the port's own unfused modules; ``AppShadingNetwork``
hands the flag to the heads the JAX module hands it to.

f32: values within 1e-5 of scale, gradients within 1e-4 of each gradient's
scale (sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nunerf_tpu.fields.mlp import Predictor as JPredictor
from nunerf_tpu.fields.nerf import NeRFNetwork as JNeRF
from nunerf_tpu_torch.convert import flat_leaves, load_jax_params, to_jax_tree
from nunerf_tpu_torch.fields.mlp import Predictor
from nunerf_tpu_torch.fields.nerf import NeRFNetwork
from nunerf_tpu_torch.fields.shading import AppShadingNetwork
from nunerf_tpu_torch.ops import fused_mlp as tfm
from port_helpers import assert_close, assert_trees_close, jitter_tree, t

RTOL_FWD, RTOL_GRAD = 1e-5, 1e-4

PREDICTORS = {
    # an outer-light head: IDE input, exp activation, constant last bias
    "light72": dict(in_dim=72, out_dim=3, activation="exp", exp_max=3.0,
                    final_bias=float(np.log(0.5))),
    # a material head: feature + point input, wider than the hidden layers
    "material259": dict(in_dim=259, out_dim=1, activation="sigmoid"),
}


@pytest.mark.parametrize("name", sorted(PREDICTORS))
def test_fused_predictor_matches_jax_fused_and_unfused(name):
    kw = dict(PREDICTORS[name])
    in_dim = kw.pop("in_dim")
    rs = np.random.RandomState(in_dim)
    x = rs.randn(3, 30, in_dim).astype(np.float32) * 0.5
    w = rs.randn(3, 30, kw["out_dim"]).astype(np.float32)
    jmod = JPredictor(fused=True, **kw)
    params = jitter_tree(jmod.init(jax.random.PRNGKey(0), jnp.zeros((1, in_dim))), 1)
    jy = jmod.apply(params, jnp.asarray(x))                 # K1, interpret
    jg = jax.grad(lambda p, xx: jnp.sum(jmod.apply(p, xx) * w), argnums=(0, 1))(
        params, jnp.asarray(x))                             # K2, interpret

    got = {}
    for fused in (True, False):
        tmod = Predictor(in_dim, fused=fused, device="cpu", **kw)
        load_jax_params(tmod, params)
        tx = t(x).requires_grad_(True)
        y = tmod(tx)
        assert y.shape == (3, 30, kw["out_dim"]) and y.dtype == torch.float32
        torch.sum(y * t(w)).backward()
        got[fused] = (y.detach(), tx.grad, flat_leaves(to_jax_tree(tmod, what="grad")))
        assert_close(y, jy, RTOL_FWD, what=f"fused={fused} value")
        assert_close(tx.grad, jg[1], RTOL_GRAD, what=f"fused={fused} dx")
        assert_trees_close(got[fused][2], flat_leaves(jg[0]), RTOL_GRAD)
    assert_close(got[True][0], got[False][0].numpy(), RTOL_FWD, what="fused vs unfused")
    assert_trees_close(got[True][2], got[False][2], RTOL_GRAD)


# skips (2,): a split layer in the middle; skips (3,): the last layer is the
# skip, so the trunk's output is cat([enc, h])
@pytest.mark.parametrize("skips", [(2,), (3,)])
def test_fused_nerf_trunk_matches_jax_fused_and_unfused(skips):
    rs = np.random.RandomState(8 + skips[0])
    pts = rs.randn(50, 4).astype(np.float32)
    views = rs.randn(50, 3).astype(np.float32)
    kw = dict(depth=4, width=128, skips=skips, rgb_bias_init=0.3)
    jmod = JNeRF(fused=True, **kw)
    params = jitter_tree(jmod.init(jax.random.PRNGKey(2), jnp.zeros((1, 4)),
                                   jnp.zeros((1, 3))), 9)
    ja, jc = jmod.apply(params, jnp.asarray(pts), jnp.asarray(views))
    jd = jmod.apply(params, jnp.asarray(pts), method=JNeRF.density)
    jg = flat_leaves(jax.grad(lambda p: jnp.sum(jnp.concatenate(
        jmod.apply(p, jnp.asarray(pts), jnp.asarray(views)), -1) ** 2))(params))

    got = {}
    for fused in (True, False):
        tmod = NeRFNetwork(fused=fused, device="cpu", **kw)
        load_jax_params(tmod, params)
        ta, tc = tmod(t(pts), t(views))
        assert_close(ta, ja, RTOL_FWD, what=f"fused={fused} alpha")
        assert_close(tc, jc, RTOL_FWD, what=f"fused={fused} rgb")
        assert_close(tmod.density(t(pts)), jd, RTOL_FWD, what=f"fused={fused} density")
        torch.sum(torch.cat([ta, tc], -1) ** 2).backward()
        got[fused] = flat_leaves(to_jax_tree(tmod, what="grad"))
        assert_trees_close(got[fused], jg, RTOL_GRAD)
    assert_trees_close(got[True], got[False], RTOL_GRAD)
    trunk = NeRFNetwork(fused=True, device="cpu", **kw)._trunk(t(pts))
    assert trunk.shape == (50, 128 + (84 if skips == (3,) else 0))


def test_shading_network_hands_fused_to_its_heads():
    """Every head but the human-light one (as in the JAX module) takes the
    fused path; the shader's outputs and parameter gradients do not move."""
    rs = np.random.RandomState(10)
    n = 24
    args = [(rs.randn(n, 3) * 0.4).astype(np.float32), rs.randn(n, 3).astype(np.float32),
            rs.randn(n, 3).astype(np.float32), rs.randn(n, 256).astype(np.float32) * 0.5]
    poses = np.tile(np.eye(3, 4, dtype=np.float32), (n, 1, 1))
    mods = {}
    for fused in (True, False):
        m = AppShadingNetwork(human_light=True, fused=fused, device="cpu")
        m.reset_parameters(torch.Generator().manual_seed(5))
        mods[fused] = m
    heads = {k: v for k, v in mods[True].named_children() if isinstance(v, Predictor)}
    assert len(heads) == 9
    assert [k for k, v in heads.items() if not v.fused] == ["human_light_predictor"]
    assert not any(v.fused for v in mods[False].children() if isinstance(v, Predictor))

    tfm.reset_launches()
    got = {}
    for fused, m in mods.items():
        c, info = m(*[t(a) for a in args], human_poses=t(poses))
        (torch.sum(c ** 2) + torch.sum(info["occ_prob"] ** 2)).backward()
        got[fused] = (c.detach(), {k: p.grad for k, p in m.named_parameters()})
    assert not any(tfm.launches.values())  # CPU tensors: the plain versions
    assert_close(got[True][0], got[False][0].numpy(), RTOL_FWD, what="color")
    for k, g in got[False][1].items():
        assert_close(got[True][1][k], g.numpy(), RTOL_GRAD, what=k)


def test_kernel_limits_take_a_259_wide_input():
    """K1/K2 take an input wider than the hidden layers (259 = feature + 3);
    hidden widths stay at most 256, and K4/K5 keep the input at most 256."""
    def spec(dims):
        n_l = len(dims) - 1
        return tfm.ChainSpec(dims, ("relu",) * (n_l - 1) + ("none",),
                             (False,) * n_l, (1.0,) * n_l)

    tfm.check_limits(spec((259, 256, 256, 256, 3)))
    tfm.check_limits(spec((tfm.MAX_IN, 256, tfm.MAX_OUT)))
    for dims in ((tfm.MAX_IN + 1, 256, 3), (259, 257, 256, 3), (39, 256, tfm.MAX_OUT + 1)):
        with pytest.raises(ValueError, match="the kernels take"):
            tfm.check_limits(spec(dims))
    with pytest.raises(ValueError, match="the kernels take"):
        tfm.check_limits(spec((259, 256, 3)), max_in=tfm.MAX_WIDTH)
    meta, _, wsum = tfm._layout(spec((259, 256, 256, 256, 3)))
    assert meta[:4] == (259, 256, 0, -1) and meta[9:12] == (256, 256, 259 * 256)
    assert wsum == 3 * 256 + 3
