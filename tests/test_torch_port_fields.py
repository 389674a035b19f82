"""The port's fields against the JAX modules, weights carried by
``nunerf_tpu_torch.convert`` (CPU, f32).

Tolerances: rtol 1e-5 of each array's scale on forward values (f32 sums in
another order), 1e-4 on gradients (longer sums, and the SDF's second-order
path).  The shader's IDE polynomials reach degree 16 with large alternating
coefficients, which makes its f32 results ill-conditioned; the shader is held
to those rtols plus ten times the port's own f32 error against the port in
float64, and JAX's own f32 error against JAX in float64
(``assert_close_calibrated``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nunerf_tpu.fields import aux as j_aux
from nunerf_tpu.fields.nerf import NeRFNetwork as JNeRF
from nunerf_tpu.fields.sdf import SDFNetwork as JSDF
from nunerf_tpu.fields.sdf import fused_sdf_apply as j_fused_sdf_apply
from nunerf_tpu.fields.sdf import sdf_value_feature_grad as j_sdf_vfg
from nunerf_tpu.fields.shading import AppShadingNetwork as JShade
from nunerf_tpu.fields.variance import SingleVarianceNetwork as JVar
from nunerf_tpu_torch.convert import flat_leaves, load_jax_params, to_jax_tree
from nunerf_tpu_torch.fields import aux
from nunerf_tpu_torch.fields.nerf import NeRFNetwork
from nunerf_tpu_torch.fields.sdf import SDFNetwork, fused_sdf_apply, sdf_value_feature_grad
from nunerf_tpu_torch.fields.shading import AppShadingNetwork
from nunerf_tpu_torch.fields.variance import SingleVarianceNetwork
from port_helpers import (assert_close, assert_close_calibrated,
                          assert_trees_close, jitter_tree, t)

RTOL_FWD, RTOL_GRAD = 1e-5, 1e-4


def _points(n, seed, scale=0.6):
    return np.random.RandomState(seed).randn(n, 3).astype(np.float32) * scale


def _jax_grads(loss, params):
    return flat_leaves(jax.grad(loss)(params))


def test_sdf_value_feature_grad_and_param_grads():
    x = _points(64, 1)
    jmod = JSDF(n_layers=4, skip_in=(2,))
    params = jitter_tree(jmod.init(jax.random.PRNGKey(0), jnp.zeros((1, 3))), 2)
    tmod = SDFNetwork(n_layers=4, skip_in=(2,), device="cpu")
    load_jax_params(tmod, params)

    js, jf, jg = j_sdf_vfg(jmod.apply, params, jnp.asarray(x))
    ts, tf, tg = sdf_value_feature_grad(tmod, t(x))
    assert_close(ts, js, RTOL_FWD, what="sdf")
    assert_close(tf, jf, RTOL_FWD, what="feature")
    assert_close(tg, jg, RTOL_FWD, what="grad_x")

    # second order: a loss of value, feature and normal, as the renderer's
    w = np.random.RandomState(3).randn(64, 256).astype(np.float32)

    def jloss(p):
        s, f, g = j_sdf_vfg(jmod.apply, p, jnp.asarray(x))
        return jnp.sum(s ** 2) + jnp.sum(f * w) + jnp.sum((jnp.linalg.norm(g, axis=-1) - 1) ** 2)

    s, f, g = sdf_value_feature_grad(tmod, t(x))
    (torch.sum(s ** 2) + torch.sum(f * t(w))
     + torch.sum((torch.linalg.norm(g, dim=-1) - 1) ** 2)).backward()
    assert_trees_close(flat_leaves(to_jax_tree(tmod, what="grad")),
                       _jax_grads(jloss, params), RTOL_GRAD)


def test_fused_sdf_value_only_matches_jax_kernel():
    """The value-only path through the port's fused entry (its plain version
    on the CPU) against JAX ``fused_sdf_apply`` (K1 in interpret mode), and
    the VJP against K2 (interpret mode)."""
    x = _points(70, 4)  # not a multiple of any tile: ragged tail
    jmod = JSDF(n_layers=4, skip_in=(2,))
    params = jitter_tree(jmod.init(jax.random.PRNGKey(1), jnp.zeros((1, 3))), 5)
    tmod = SDFNetwork(n_layers=4, skip_in=(2,), device="cpu")
    load_jax_params(tmod, params)

    jy = j_fused_sdf_apply(jmod, params, jnp.asarray(x), value_only=True)
    ty = fused_sdf_apply(tmod, t(x), value_only=True)
    assert ty.shape == (70, 1)
    assert_close(ty, jy, RTOL_FWD, what="value")
    assert_close(ty, tmod(t(x))[..., :1].detach(), RTOL_FWD, what="vs module")

    gw = np.random.RandomState(6).randn(70, 1).astype(np.float32)
    jg = _jax_grads(lambda p: jnp.sum(
        j_fused_sdf_apply(jmod, p, jnp.asarray(x), value_only=True) * gw), params)
    torch.sum(fused_sdf_apply(tmod, t(x), value_only=True) * t(gw)).backward()
    # the sliced-off feature columns of the last layer get exact zeros
    assert_trees_close(flat_leaves(to_jax_tree(tmod, what="grad")), jg, RTOL_GRAD)


def test_geometric_init_is_near_sphere():
    """The port's own init (its generator, not JAX's) gives the same
    near-sphere SDF, about |x| - 0.5, as the JAX init."""
    x = _points(256, 7, scale=0.4)
    jmod = JSDF()
    jp = jmod.init(jax.random.PRNGKey(0), jnp.zeros((1, 3)))
    js = np.asarray(jmod.apply(jp, jnp.asarray(x))[..., 0])
    tmod = SDFNetwork(device="cpu")
    tmod.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        ts = tmod(t(x))[..., 0].numpy()
    target = np.linalg.norm(x, axis=-1) - 0.5
    for s in (js, ts):
        assert np.abs(s - target).mean() < 0.15
        assert np.corrcoef(s, target)[0, 1] > 0.9


def test_nerf_forward_and_grads():
    rs = np.random.RandomState(8)
    pts = rs.randn(48, 4).astype(np.float32)
    views = rs.randn(48, 3).astype(np.float32)
    jmod = JNeRF(rgb_bias_init=float(np.log(0.5)))
    params = jitter_tree(jmod.init(jax.random.PRNGKey(2), jnp.zeros((1, 4)),
                                   jnp.zeros((1, 3))), 9)
    tmod = NeRFNetwork(rgb_bias_init=float(np.log(0.5)), device="cpu")
    load_jax_params(tmod, params)
    ja, jc = jmod.apply(params, jnp.asarray(pts), jnp.asarray(views))
    ta, tc = tmod(t(pts), t(views))
    assert_close(ta, ja, RTOL_FWD, what="alpha")
    assert_close(tc, jc, RTOL_FWD, what="rgb")
    jg = _jax_grads(lambda p: jnp.sum(jnp.concatenate(
        jmod.apply(p, jnp.asarray(pts), jnp.asarray(views)), -1) ** 2), params)
    torch.sum(torch.cat(tmod(t(pts), t(views)), -1) ** 2).backward()
    assert_trees_close(flat_leaves(to_jax_tree(tmod, what="grad")), jg, RTOL_GRAD)


def _outputs(color, spec, info, inter):
    out = {"color": color, "outer_light_for_dir": spec}
    out.update({f"info/{k}": v for k, v in info.items()})
    out.update({f"inter/{k}": v for k, v in inter.items()})
    return out


def test_app_shading_forward_and_grads():
    rs = np.random.RandomState(10)
    n = 40
    pts = (rs.randn(n, 3) * 0.4).astype(np.float32)
    normals = rs.randn(n, 3).astype(np.float32)
    view = rs.randn(n, 3).astype(np.float32)
    feats = rs.randn(n, 256).astype(np.float32) * 0.5
    jmod = JShade()
    params = jitter_tree(jmod.init(jax.random.PRNGKey(3), *(jnp.zeros((1, 3)),) * 3,
                                   jnp.zeros((1, 256))), 11)
    args_j = [jnp.asarray(a) for a in (pts, normals, view, feats)]
    jc, jinfo, jinter = jax.jit(lambda p, *a: jmod.apply(p, *a, inter_results=True))(
        params, *args_j)
    jspec = jmod.apply(params, args_j[0], args_j[2],
                       method=JShade.outer_light_for_dir)

    def jloss(p, *a):
        c, info = jmod.apply(p, *a)
        return jnp.sum(c ** 2) + jnp.sum(info["occ_prob"] ** 2)

    jgrad = jax.jit(jax.grad(jloss))
    jg = flat_leaves(jgrad(params, *args_j))
    with jax.enable_x64(True):
        jg64 = flat_leaves(jgrad(
            jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64), params),
            *[jnp.asarray(a, jnp.float64) for a in (pts, normals, view, feats)]))

    res = {}
    for dt in (torch.float32, torch.float64):
        tmod = AppShadingNetwork(device="cpu")
        load_jax_params(tmod, params)
        tmod.to(dt)
        args_t = [t(a).to(dt) for a in (pts, normals, view, feats)]
        with torch.no_grad():
            tc, tinfo, tinter = tmod(*args_t, inter_results=True)
            tspec = tmod.outer_light_for_dir(args_t[0], args_t[2])
        c, info = tmod(*args_t)
        (torch.sum(c ** 2) + torch.sum(info["occ_prob"] ** 2)).backward()
        res[dt] = (_outputs(tc, tspec, tinfo, tinter),
                   flat_leaves(to_jax_tree(tmod, what="grad")))
    (o32, g32), (o64, g64) = res[torch.float32], res[torch.float64]
    expected = _outputs(jc, jspec, jinfo, jinter)
    assert sorted(o32) == sorted(expected)
    for k, e in expected.items():
        assert_close_calibrated(o32[k], e, o64[k], RTOL_FWD, what=k)
    assert sorted(g32) == sorted(jg)
    for k, e in jg.items():
        assert_close_calibrated(g32[k], e, g64[k], RTOL_GRAD, what=k,
                                expected64=jg64[k])


def test_variance():
    jmod = JVar(init_val=0.3)
    params = jmod.init(jax.random.PRNGKey(0), jnp.zeros((1, 3)))
    tmod = SingleVarianceNetwork(init_val=0.3, device="cpu")
    x = _points(5, 12)
    assert_close(tmod(t(x)), jmod.apply(params, jnp.asarray(x)), RTOL_FWD)


@pytest.mark.parametrize("name", ["InfOutNetwork", "IoRNetwork", "ThicknessNetwork",
                                  "MaterialFeatsNetwork"])
def test_aux_forward_and_grads(name):
    x = _points(32, 13)
    jmod = getattr(j_aux, name)()
    params = jitter_tree(jmod.init(jax.random.PRNGKey(4), jnp.zeros((1, 3))), 14)
    tmod = getattr(aux, name)(device="cpu")
    load_jax_params(tmod, params)
    assert_close(tmod(t(x)), jmod.apply(params, jnp.asarray(x)), RTOL_FWD)
    jg = _jax_grads(lambda p: jnp.sum(jmod.apply(p, jnp.asarray(x)) ** 2), params)
    torch.sum(tmod(t(x)) ** 2).backward()
    assert_trees_close(flat_leaves(to_jax_tree(tmod, what="grad")), jg, RTOL_GRAD)
