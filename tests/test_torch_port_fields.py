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


def _shade_inputs(seed, n=40):
    rs = np.random.RandomState(seed)
    return [(rs.randn(n, 3) * 0.4).astype(np.float32), rs.randn(n, 3).astype(np.float32),
            rs.randn(n, 3).astype(np.float32), rs.randn(n, 256).astype(np.float32) * 0.5]


def _shade_case(jmod, params, tmod_kwargs, jcall, tcall, unused=()):
    """Outputs, input gradients and parameter gradients of one shader entry
    point on both sides, calibrated by float64 on both sides as in
    ``test_app_shading_forward_and_grads``.  The loss reaches every output."""
    arrs = _shade_inputs(21)

    def jloss(p, *a):
        c, info = jcall(p, *a)
        return jnp.sum(c ** 2) + sum(jnp.sum(v ** 2) for v in info.values())

    jfwd = jax.jit(jcall)
    jgrad = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3, 4)))
    args_j = [jnp.asarray(a) for a in arrs]
    jc, jinfo = jfwd(params, *args_j)
    jg = jgrad(params, *args_j)
    with jax.enable_x64(True):
        jg64 = jgrad(jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64), params),
                     *[jnp.asarray(a, jnp.float64) for a in arrs])

    res = {}
    for dt in (torch.float32, torch.float64):
        tmod = AppShadingNetwork(device="cpu", **tmod_kwargs)
        load_jax_params(tmod, params)
        tmod.to(dt)
        leaves = [t(a).to(dt).requires_grad_(True) for a in arrs]
        c, info = tcall(tmod, *leaves)
        (torch.sum(c ** 2) + sum(torch.sum(v ** 2) for v in info.values())).backward()
        out = {"color": c, **{f"info/{k}": v for k, v in info.items()}}
        grads = flat_leaves(to_jax_tree(tmod, what="grad"))
        grads.update({f"input{i}": a.grad.numpy() for i, a in enumerate(leaves)})
        res[dt] = ({k: v.detach() for k, v in out.items()}, grads)
    (o32, g32), (o64, g64) = res[torch.float32], res[torch.float64]

    expected = {"color": jc, **{f"info/{k}": v for k, v in jinfo.items()}}
    assert sorted(o32) == sorted(expected)
    for k, e in expected.items():
        assert_close_calibrated(o32[k], e, o64[k], RTOL_FWD, what=k)

    def with_inputs(g):
        out = flat_leaves(g[0])
        out.update({f"input{i}": np.asarray(a) for i, a in enumerate(g[1:])})
        return out

    jg, jg64 = with_inputs(jg), with_inputs(jg64)
    assert sorted(g32) == sorted(jg)
    for k, e in jg.items():
        assert_close_calibrated(g32[k], e, g64[k], RTOL_GRAD, what=k, expected64=jg64[k])
    # the gradient reaches the inputs (positions and normals carry it on to
    # the IoR field in stage 2) ...
    assert all(np.abs(g32[f"input{i}"]).max() > 0 for i in range(4))
    # ... and heads the entry point does not evaluate get exactly zero
    for k, v in g32.items():
        if k.split("/")[0] in unused:
            assert not v.any() and not jg[k].any(), k
    return o32


@pytest.mark.parametrize("is_internal", [False, True])
@pytest.mark.parametrize("sphere_direction", [False, True])
def test_s2_shade_forward_and_grads(is_internal, sphere_direction):
    jmod = JShade(sphere_direction=sphere_direction)
    params = jitter_tree(jmod.init(jax.random.PRNGKey(5), *(jnp.zeros((1, 3)),) * 3,
                                   jnp.zeros((1, 256))), 22)
    out = _shade_case(
        jmod, params, {"sphere_direction": sphere_direction},
        lambda p, *a: jmod.apply(p, *a, is_internal, method=JShade.s2_shade),
        lambda m, *a: m.s2_shade(*a, is_internal), unused=("refrac_light",))
    assert "info/refraction_coefficient" in out
    assert bool(out["color"].any()) != is_internal


@pytest.mark.parametrize("sphere_direction", [False, True])
def test_predict_diffuse_lights_forward_and_grads(sphere_direction):
    """The outer light at roughness 1, with and without the sphere-direction
    encoding: its value, and the gradients of its squares' sum at the
    parameters and at both inputs, calibrated by float64 on both sides; every
    head but ``outer_light`` gets exactly zero."""
    jmod = JShade(sphere_direction=sphere_direction)
    params = jitter_tree(jmod.init(jax.random.PRNGKey(7), *(jnp.zeros((1, 3)),) * 3,
                                   jnp.zeros((1, 256))), 24)
    arrs = _shade_inputs(25)[:2]

    def jcall(p, pts, normals):
        return jmod.apply(p, pts, normals, method=JShade.predict_diffuse_lights)

    jgrad = jax.jit(jax.grad(lambda p, *a: jnp.sum(jcall(p, *a) ** 2), argnums=(0, 1, 2)))
    args_j = [jnp.asarray(a) for a in arrs]
    jout = jax.jit(jcall)(params, *args_j)
    with jax.enable_x64(True):
        jg64 = jgrad(jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64), params),
                     *[jnp.asarray(a, jnp.float64) for a in arrs])

    def flat(g):
        out = flat_leaves(g[0])
        out.update({f"input{i}": np.asarray(a) for i, a in enumerate(g[1:])})
        return out

    jg, jg64 = flat(jgrad(params, *args_j)), flat(jg64)
    res = {}
    for dt in (torch.float32, torch.float64):
        tmod = AppShadingNetwork(device="cpu", sphere_direction=sphere_direction)
        load_jax_params(tmod, params)
        tmod.to(dt)
        leaves = [t(a).to(dt).requires_grad_(True) for a in arrs]
        out = tmod.predict_diffuse_lights(*leaves)
        torch.sum(out ** 2).backward()
        grads = flat_leaves(to_jax_tree(tmod, what="grad"))
        grads.update({f"input{i}": (np.zeros(a.shape) if a.grad is None else a.grad.numpy())
                      for i, a in enumerate(leaves)})
        res[dt] = (out.detach(), grads)
    (o32, g32), (o64, g64) = res[torch.float32], res[torch.float64]
    assert o32.shape == (arrs[0].shape[0], 3)
    assert_close_calibrated(o32, jout, o64, RTOL_FWD, what="diffuse light")
    assert sorted(g32) == sorted(jg)
    for k, e in jg.items():
        assert_close_calibrated(g32[k], e, g64[k], RTOL_GRAD, what=k, expected64=jg64[k])
        if not k.startswith(("outer_light/", "input")):
            assert not g32[k].any() and not np.asarray(e).any(), k
    # the points reach the light only through the sphere-direction encoding
    assert bool(np.abs(g32["input0"]).max() > 0) == sphere_direction
    assert np.abs(g32["input1"]).max() > 0


def test_diffuse_only_shader_forward_and_grads():
    """The lambertian inner variant: the parameter set of the full shader,
    metallic and transmission reported as zero."""
    jmod = JShade(diffuse_only=True)
    params = jitter_tree(jmod.init(jax.random.PRNGKey(6), *(jnp.zeros((1, 3)),) * 3,
                                   jnp.zeros((1, 256))), 23)
    full = JShade().init(jax.random.PRNGKey(6), *(jnp.zeros((1, 3)),) * 3,
                         jnp.zeros((1, 256)))
    assert sorted(flat_leaves(params)) == sorted(flat_leaves(full))
    out = _shade_case(jmod, params, {"diffuse_only": True},
                      lambda p, *a: jmod.apply(p, *a), lambda m, *a: m(*a),
                      unused=("refrac_light", "inner_light"))
    assert not out["info/metallic"].any() and not out["info/transmission_weight"].any()
    assert sorted(n for n, _ in AppShadingNetwork(device="cpu", diffuse_only=True)
                  .named_parameters()) == sorted(
        n for n, _ in AppShadingNetwork(device="cpu").named_parameters())


def test_jax_checkpoint_is_read_by_the_port(tmp_path):
    """A checkpoint written by the JAX trainer's ``save_checkpoint`` (stage-1
    tree and two-level stage-2 tree) is read with pickle alone and loads
    into the port's modules leaf by leaf."""
    import optax
    from nunerf_tpu.models.stage1 import ShapeRenderer as JShapeRenderer
    from nunerf_tpu.train.trainer import save_checkpoint
    from nunerf_tpu_torch.convert import load_jax_checkpoint
    from nunerf_tpu_torch.models.stage1 import PARAM_KEYS, ShapeRenderer
    from nunerf_tpu_torch.models.stage2 import Stage2Renderer, tree_keys
    from nunerf_tpu_torch.tracing.scene import Scene

    s1_cfg = {"sdf_n_layers": 2, "is_nerf": True}
    params = jitter_tree(JShapeRenderer(s1_cfg).init_params(jax.random.PRNGKey(0)), 30)
    path = str(tmp_path / "s1" / "model.pth")
    save_checkpoint(path, 1234, params, optax.adam(1e-3).init(params), 7.5)
    step, tree, best = load_jax_checkpoint(path)
    assert (step, best) == (1234, 7.5)
    r = ShapeRenderer(s1_cfg, device="cpu")
    load_jax_params(r, tree, PARAM_KEYS)
    back = flat_leaves(to_jax_tree(r, PARAM_KEYS))
    expected = flat_leaves(params)
    assert sorted(back) == sorted(expected)
    for k, e in expected.items():
        np.testing.assert_array_equal(back[k], e, err_msg=k)

    # stage 2: the frozen stage-1 weights come from that checkpoint
    # (stage1_ckpt_dir), and the renderer's own tree round-trips through one
    tri = (np.array([[0, 0, 1], [1, 0, 1], [0, 1, 1]], np.float32), np.array([[0, 1, 2]]))
    cfg = {"stage1_cfg": s1_cfg, "stage1_ckpt_dir": path, "sdf_n_layers": 2,
           "learn_absorption": True, "mixed_precision": False}
    r2 = Stage2Renderer(cfg, Scene(tri, device="cpu"), device="cpu", seed=5)
    tree2 = to_jax_tree(r2, tree_keys())
    assert sorted(tree2) == ["frozen", "train"]
    assert tree2["train"]["iors_vec"].shape == (10,)
    assert tree2["train"]["absorption"].shape == (3,)
    assert "params" in tree2["train"]["sdf_inner"] and "params" in tree2["frozen"]["sdf"]
    frozen = flat_leaves(tree2["frozen"])
    for k, e in expected.items():
        np.testing.assert_array_equal(frozen[k], e, err_msg=k)
    path2 = str(tmp_path / "s2" / "model.pth")
    save_checkpoint(path2, 5, jitter_tree(tree2, 31), None, 0.0)
    _, tree2b, _ = load_jax_checkpoint(path2)
    r3 = Stage2Renderer(cfg, Scene(tri, device="cpu"), device="cpu", seed=6)
    load_jax_params(r3, tree2b, tree_keys())
    back2, want2 = flat_leaves(to_jax_tree(r3, tree_keys())), flat_leaves(tree2b)
    assert sorted(back2) == sorted(want2)
    for k, e in want2.items():
        np.testing.assert_array_equal(back2[k], e, err_msg=k)
    with pytest.raises(KeyError):
        load_jax_params(r3, {"train": tree2b["train"]}, tree_keys())


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
