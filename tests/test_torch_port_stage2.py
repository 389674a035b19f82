"""The port's stage-2 (zero-thickness) training step against the JAX step
(CPU, f32).

Both sides build ``Scene`` from one mesh (a marched sphere of 840 triangles,
closest hit by the brute sweep) and ``Stage2Renderer`` from the same JAX
parameter tree (carried by ``nunerf_tpu_torch.convert``), and take the same
batch, made with numpy from a seed.  Stage 2 draws no random numbers.

Sizes: 8 rays, 4-layer SDFs, 8 outer samples, 4 + 1x4 inside the glass.  One
jitted ``value_and_grad`` of the JAX step is shared by the whole-step cases;
the configuration variants compare the forward outputs only.

Tolerances.  As in the stage-1 test the shader's IDE polynomials make parts
of the step ill-conditioned in f32, so each quantity is held to
``rtol * scale + 10 * f32_error``: rtol (1e-5 on losses and outputs, 1e-4 on
gradients, for sum order) plus ten times the measured f32 error, which is
the port's difference from the same port in float64 and, for the gradients,
also the JAX step's difference from the same JAX step in float64 (the
compiled f32 graph is the less exact of the two: its gradients sit up to
1e-2 of their scale from the float64 ones, the port's 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nunerf_tpu.models.stage1 import ShapeRenderer as JShapeRenderer
from nunerf_tpu.models.stage2 import Stage2Renderer as JStage2Renderer
from nunerf_tpu.tracing.scene import Scene as JScene
from nunerf_tpu.train.loss import compute_losses as j_compute_losses
from nunerf_tpu_torch.convert import flat_leaves, load_jax_params, to_jax_tree
from nunerf_tpu_torch.models.stage2 import Stage2Renderer, tree_keys
from nunerf_tpu_torch.tracing.mesh_ops import extract_geometry
from nunerf_tpu_torch.tracing.scene import Scene
from nunerf_tpu_torch.train.trainer import TrainStep
from port_helpers import jitter_tree

LR = 1e-3
RTOL_LOSS, RTOL_GRAD, K_COND = 1e-5, 1e-4, 10.0
RN = 8
STEP = 10

S1_CFG = {
    "is_nerf": True, "shader_config": {"sphere_direction": False},
    "n_samples": 8, "n_bg_samples": 4, "n_importance": 8, "up_sample_steps": 2,
    "apply_occ_loss": False, "sdf_n_layers": 4,
}
CFG = {
    "is_nerf": True, "zero_thickness": True, "stage1_cfg": S1_CFG,
    "shader_config": {"sphere_direction": False},
    "n_samples_outer": 8, "n_bg_importance": 2, "n_samples_inner": 4,
    "inner_up_rounds": 1, "inner_up_each": 4, "sdf_n_layers": 4,
    "loss": ["nerf_render", "eikonal", "std"], "eikonal_weight": 0.02,
    "mixed_precision": False,
}


def _batch():
    rs = np.random.RandomState(0)
    origins = np.tile(np.array([[0.0, 0.0, -2.5]], np.float32), (RN, 1))
    dirs = rs.randn(RN, 3).astype(np.float32) * 0.35 - origins
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return {"rays_o": origins, "rays_d": dirs.astype(np.float32),
            "rgbs": rs.rand(RN, 3).astype(np.float32)}


@pytest.fixture(scope="module")
def setup():
    verts, tris = extract_geometry(lambda p: np.linalg.norm(p, axis=-1) - 0.5,
                                   resolution=12)
    jscene = JScene((verts, tris), tile=512)
    s1 = JShapeRenderer(S1_CFG)
    s1_params = jitter_tree(s1.init_params(jax.random.PRNGKey(7)), 1, 0.05)
    renderer = JStage2Renderer(CFG, scene=jscene, stage1_params=s1_params)
    params = renderer.init_params(jax.random.PRNGKey(8))
    params = {"train": jitter_tree(params["train"], 2, 0.05), "frozen": s1_params}
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}

    def loss_fn(p, step):
        out = renderer.train_outputs(p, batch, jax.random.PRNGKey(1), step)
        terms = j_compute_losses(out, batch, step, renderer.cfg)
        return terms["loss_total"], terms

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    return (verts, tris), jscene, params, batch, grad_fn


def _jax_grads_f64(mesh, params):
    """The JAX step's gradients with float64 arrays throughout."""
    with jax.enable_x64(True):
        scene = JScene(mesh, tile=512)
        for name in ("v0", "e1", "e2", "verts", "vertex_normals", "vertex_curvature"):
            setattr(scene, name, jnp.asarray(np.asarray(getattr(scene, name)), jnp.float64))
        p64 = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), params)
        batch = {k: jnp.asarray(v, jnp.float64) for k, v in _batch().items()}
        renderer = JStage2Renderer(CFG, scene=scene, stage1_params=p64["frozen"])

        def loss_fn(p, step):
            out = renderer.train_outputs(p, batch, jax.random.PRNGKey(1), step)
            return j_compute_losses(out, batch, step, renderer.cfg)["loss_total"]

        grads = jax.jit(jax.grad(loss_fn))(p64, jnp.asarray(STEP, jnp.int32))
        return {k: np.asarray(v, np.float64) for k, v in flat_leaves(grads).items()}


def _port_renderer(mesh, params, cfg, dtype):
    scene = Scene(mesh, tile=512, device="cpu")
    for name in ("v0", "e1", "e2", "verts", "vertex_normals", "vertex_curvature"):
        setattr(scene, name, getattr(scene, name).to(dtype))
    renderer = Stage2Renderer(cfg, scene, params["frozen"], device="cpu")
    load_jax_params(renderer, params, tree_keys())
    return renderer.to(dtype)


def _in_dtype(dtype, fn):
    prev = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        return fn()
    finally:
        torch.set_default_dtype(prev)


def _port_step(mesh, params, cfg, dtype):
    def run():
        renderer = _port_renderer(mesh, params, cfg, dtype)
        train = TrainStep(renderer, LR)
        assert not any(p.requires_grad for p in renderer.stage1.parameters())
        assert len(train.params) == sum(
            1 for n, _ in renderer.named_parameters() if not n.startswith("stage1."))
        batch = {k: torch.as_tensor(v).to(dtype) for k, v in _batch().items()}
        terms = train.compute_grads(batch, STEP)
        # the frozen subtree gets no gradient at all
        assert all(p.grad is None for p in renderer.stage1.parameters())
        grads = flat_leaves(to_jax_tree(renderer, tree_keys(), "grad"))
        before = flat_leaves(to_jax_tree(renderer, tree_keys()))
        train.apply()
        after = flat_leaves(to_jax_tree(renderer, tree_keys()))
        return ({k: float(v.detach()) for k, v in terms.items()}, grads, before, after)
    return _in_dtype(dtype, run)


def _bound(rtol, ref64, port32):
    return rtol * np.abs(ref64).max() + K_COND * np.abs(port32 - ref64).max()


def test_stage2_step_matches_jax(setup):
    mesh, _, params, _, grad_fn = setup
    (_, jterms), jgrads = grad_fn(params, jnp.asarray(STEP, jnp.int32))
    jterms = {k: float(v) for k, v in jterms.items()}
    jgrads = flat_leaves(jgrads)
    jgrads64 = _jax_grads_f64(mesh, params)

    t32, g32, before, after = _port_step(mesh, params, CFG, torch.float32)
    t64, g64, _, _ = _port_step(mesh, params, CFG, torch.float64)

    # every loss term
    assert sorted(t32) == sorted(jterms)
    assert jterms["loss_rgb"] > 1e-2 and jterms["loss_eikonal"] > 0
    for k, v in jterms.items():
        bound = _bound(RTOL_LOSS, np.float64(t64[k]), np.float64(t32[k])) + 1e-9
        assert abs(t32[k] - v) <= bound, (k, t32[k], v, bound)

    # every gradient: the trainable ones match, the frozen ones are zero on
    # both sides, and the IoR field is reached through the frozen shader
    assert sorted(g32) == sorted(jgrads)
    noise = {}
    for k, v in jgrads.items():
        noise[k] = (_bound(RTOL_GRAD, g64[k], g32[k])
                    + K_COND * np.abs(v - jgrads64[k]).max())
        err = np.abs(g32[k] - v).max()
        assert err <= noise[k], (k, err, noise[k])
        # in float64 the two steps agree to 1e-4 of each gradient's scale
        # (tables and constants stay f32 on the JAX side)
        assert np.abs(g64[k] - jgrads64[k]).max() <= 1e-4 * np.abs(g64[k]).max() + 1e-12, k
        if k.startswith("frozen/"):
            assert not v.any() and not g32[k].any(), k
    for head in ("train/sdf_inner", "train/shade_inner", "train/ior", "train/var_inner"):
        assert sum(np.abs(v).sum() for k, v in g32.items() if k.startswith(head)) > 0, head

    # one Adam step: the port's update is optax.adam's on the port's grads,
    # to 1e-5 of the step size; the frozen subtree is bit-identical
    opt = optax.adam(LR)
    upd, _ = opt.update(g32, opt.init(before), before)
    for k in before:
        if k.startswith("frozen/"):
            np.testing.assert_array_equal(after[k], before[k], err_msg=k)
            np.testing.assert_array_equal(before[k], flat_leaves(params)[k], err_msg=k)
        else:
            np.testing.assert_allclose(after[k], before[k] + np.asarray(upd[k]),
                                       rtol=1e-6, atol=1e-5 * LR, err_msg=k)

    # ... and the parameters after it match JAX's multi_transform step (adam
    # on 'train', set_to_zero on 'frozen').  Where the gradient is clear of
    # the noise bound both take the same step; elsewhere Adam's first step
    # (lr * g / (|g| + eps)) may differ by at most 2 lr.
    jupd, _ = opt.update(jgrads, opt.init(before), before)
    for k in before:
        if k.startswith("frozen/"):
            continue
        jafter = before[k] + np.asarray(jupd[k])
        clear = np.abs(jgrads[k]) > 10.0 * noise[k] + 1e-6
        diff = np.abs(after[k] - jafter)
        assert (diff[clear] <= 1e-6 + 1e-6 * np.abs(jafter[clear])).all(), k
        assert (diff <= 2 * LR + 1e-6).all(), k


def _port_forward(mesh, params, cfg, dtype, fn="train_outputs"):
    def run():
        renderer = _port_renderer(mesh, params, cfg, dtype)
        batch = {k: torch.as_tensor(v).to(dtype) for k, v in _batch().items()}
        with torch.no_grad():
            out = getattr(renderer, fn)(batch, STEP)
        return {k: v.detach().numpy().astype(np.float64) for k, v in out.items()}
    return _in_dtype(dtype, run)


VARIANTS = {
    "test_outputs": ({}, "test_outputs"),
    "freeze_ior_inv_s": ({"freeze_ior_step": 5, "freeze_ior_inv_s": 1e6}, "train_outputs"),
    "inv_s_floor_max": ({"inv_s_floor_max": 400.0, "inv_s_floor_start": 0,
                         "inv_s_floor_end": 20, "inv_s_floor_base": 32.0}, "train_outputs"),
    "sphere_clip_outer": ({"sphere_clip_outer": True}, "train_outputs"),
    "inner_diffuse_only": ({"inner_diffuse_only": True}, "train_outputs"),
    "bg_sampling_stage1": ({"bg_sampling": "stage1", "n_samples_outer": 10}, "train_outputs"),
    "bg_sampling_linear64": ({"bg_sampling": "linear64", "bg_srgb_composite": False},
                             "train_outputs"),
    "parity_quirk": ({"inner_upsample_parity_quirk": True}, "train_outputs"),
}


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_stage2_outputs_match_jax(setup, name):
    """``render`` through ``train_outputs`` / ``test_outputs``, output by
    output, for the default configuration's validation forward and one case
    for each option."""
    mesh, jscene, params, batch, _ = setup
    extra, fn = VARIANTS[name]
    cfg = dict(CFG, **extra)
    jr = JStage2Renderer(cfg, scene=jscene, stage1_params=params["frozen"])
    jout = jax.jit(lambda p: getattr(jr, fn)(p, batch, jax.random.PRNGKey(1),
                                             jnp.asarray(STEP, jnp.int32)))(params)
    o32 = _port_forward(mesh, params, cfg, torch.float32, fn)
    o64 = _port_forward(mesh, params, cfg, torch.float64, fn)
    assert sorted(o32) == sorted(jout)
    for k, v in jout.items():
        v = np.asarray(v, np.float64)
        assert o32[k].shape == v.shape, k
        bound = _bound(RTOL_LOSS, o64[k], o32[k]) + 1e-7
        assert np.abs(o32[k] - v).max() <= bound, (k, np.abs(o32[k] - v).max(), bound)
    if name == "freeze_ior_inv_s":
        assert float(jout["ior_frozen"]) == 1.0
    if name == "inv_s_floor_max":  # the floor is live: std = 1 / floor
        assert abs(float(jout["std"]) - 1 / (32.0 * (400.0 / 32.0) ** 0.5)) < 1e-6


def test_ray_trace_bounces_match_jax(setup):
    mesh, jscene, params, batch, _ = setup
    jr = JStage2Renderer(CFG, scene=jscene, stage1_params=params["frozen"])
    jb, jtir = jr.ray_trace(params, batch["rays_o"], batch["rays_d"], STEP)
    r = _port_renderer(mesh, params, CFG, torch.float32)
    pb, ptir = r.ray_trace(torch.as_tensor(_batch()["rays_o"]),
                           torch.as_tensor(_batch()["rays_d"]), STEP)
    assert len(pb) == len(jb) == 3
    assert int(np.asarray(jb[0]["hit"]).sum()) >= 4 and not np.asarray(jb[0]["hit"]).all()
    np.testing.assert_array_equal(ptir.numpy(), np.asarray(jtir))
    for a, e in zip(pb, jb):
        assert sorted(a) == sorted(e)
        for k in e:
            av, ev = a[k].detach().numpy(), np.asarray(e[k])
            if ev.dtype == bool:
                np.testing.assert_array_equal(av, ev, err_msg=k)
            else:  # f32 sums in another order, through three refractions
                np.testing.assert_allclose(av, ev, rtol=1e-4, atol=1e-5, err_msg=k)


def test_freeze_ior_gate_gradients_match_jax(setup):
    """Past ``freeze_ior_step`` the IoR field still gets no gradient until the
    inner inv_s crosses the threshold; with the threshold met its gradient
    matches JAX's (a ``lax.cond`` there, a ``torch.where`` on a tensor flag
    here)."""
    mesh, jscene, params, batch, _ = setup

    def ior_grads(extra, step):
        cfg = dict(CFG, **extra)
        jr = JStage2Renderer(cfg, scene=jscene, stage1_params=params["frozen"])

        def loss(p):
            bounces, _ = jr.ray_trace(p, batch["rays_o"], batch["rays_d"],
                                      jnp.asarray(step, jnp.int32))
            return sum(jnp.sum(b["next_dir"] ** 2 * jnp.arange(1.0, 4.0)) for b in bounces)

        jg = flat_leaves(jax.grad(loss)(params)["train"]["ior"])
        r = _port_renderer(mesh, params, cfg, torch.float32)
        bounces, _ = r.ray_trace(torch.as_tensor(_batch()["rays_o"]),
                                 torch.as_tensor(_batch()["rays_d"]), step)
        w = torch.arange(1.0, 4.0)
        sum(torch.sum(b["next_dir"] ** 2 * w) for b in bounces).backward()
        pg = {k[len("train/ior/"):]: v for k, v in flat_leaves(
            to_jax_tree(r, tree_keys(), "grad")).items() if k.startswith("train/ior/")}
        return jg, pg

    for extra, step, live in (({"freeze_ior_step": 5, "freeze_ior_inv_s": 1e6}, 100, False),
                              ({"freeze_ior_step": 5, "freeze_ior_inv_s": 0.5}, 100, True),
                              ({"freeze_ior_step": 5, "freeze_ior_inv_s": 0.5}, 2, False)):
        jg, pg = ior_grads(extra, step)
        assert sorted(jg) == sorted(pg)
        total = sum(np.abs(v).sum() for v in pg.values())
        assert (total > 0) == live, (extra, step, total)
        for k, v in jg.items():
            np.testing.assert_allclose(pg[k], v, rtol=1e-3,
                                       atol=1e-4 * (np.abs(v).max() + 1e-12), err_msg=k)


def test_stage2_entry_points_and_refusals(setup):
    mesh, _, params, _, _ = setup
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Scene(mesh)
        with pytest.raises(RuntimeError, match="CUDA"):
            Stage2Renderer(CFG, Scene(mesh, device="cpu"), params["frozen"])
    with pytest.raises(ValueError, match="use_kernel"):
        Scene(mesh, use_kernel=True, device="cpu")
    scene = Scene(mesh, device="cpu")
    assert not scene.use_kernel
    with pytest.raises(ValueError, match="stage-1"):
        Stage2Renderer(CFG, scene, None, device="cpu")
    with pytest.raises(NotImplementedError):
        Stage2Renderer(dict(CFG, fused_sdf=True), scene, params["frozen"], device="cpu")
    r = Stage2Renderer(dict(CFG, learn_absorption=True), scene, params["frozen"],
                       device="cpu")
    assert tuple(r.absorption.shape) == (3,) and float(r.absorption.detach()[0]) == -2.0
    assert r._inv_s_floor(500) is None
    r2 = Stage2Renderer(dict(CFG, inv_s_floor_max=400.0, inv_s_floor_start=100,
                             inv_s_floor_end=1000), scene, params["frozen"], device="cpu")
    assert r2._inv_s_floor(None) is None and r2._inv_s_floor(50) == 0.0
    np.testing.assert_allclose([r2._inv_s_floor(100), r2._inv_s_floor(550),
                                r2._inv_s_floor(1000)],
                               [32.0, 32.0 * (400.0 / 32.0) ** 0.5, 400.0], rtol=1e-6)
