"""The port's curvature-shell stage 2 (``Stage2ShellRenderer``) against the
JAX renderer (CPU, f32).

Both sides build ``Scene`` from one mesh (a marched sphere of 840
triangles, closest hit by the brute sweep, raw angle-defect curvature of
both signs) and the renderer from the same JAX parameter tree (carried by
``nunerf_tpu_torch.convert``: the SpecInner ``shade_inner``, ``thickness``,
``ior`` and ``absorption`` included), and take the same batch, made with
numpy from a seed, with an object mask.  Stage 2 draws no random numbers.

Sizes: 16 rays (half of them aimed at negative curvature), 4-layer SDFs, 8 outer samples, 4 + 1x4 inside the glass,
``learn_absorption`` on, and the three freeze gates configured: released at
the compared step in the whole-step case, held in one forward variant.  One
jitted ``value_and_grad`` of the JAX step, whose outputs come along as its
auxiliary value, carries the whole-step case; each variant compiles its
forward once.

Tolerances, the convention of ``test_torch_port_stage2.py``: each quantity
is held to ``rtol * scale + 10 * f32_error``, where rtol is 1e-5 on losses
and outputs and 1e-4 on gradients (sum order), and the f32 error is the
port's difference from the same port in float64 and, for the gradients,
also the JAX step's difference from the same JAX step in float64.  The
bounces of ``ray_trace`` have equal masks, and values within 1e-4 of their
scale plus ten times the port's f32 error (plus 1e-6): the shell chord
``|r cos - sqrt(r^2 cos^2 - 2 r t + t^2)|`` cancels badly where the
curvature radius ``r`` is large, and the jitted JAX trace rounds it
otherwise than the eager one (up to 3e-5 on a lane whose own f32 error is
1.4e-5).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nunerf_tpu.models.stage2_shell import Stage2ShellRenderer as JShellRenderer
from nunerf_tpu.tracing.scene import Scene as JScene
from nunerf_tpu.train.loss import compute_losses as j_compute_losses
from nunerf_tpu_torch.convert import flat_leaves, load_jax_params, to_jax_tree
from nunerf_tpu_torch.models.stage1 import PARAM_KEYS as STAGE1_KEYS
from nunerf_tpu_torch.models.stage1 import ShapeRenderer
from nunerf_tpu_torch.models.stage2 import tree_keys
from nunerf_tpu_torch.models.stage2_shell import SHELL_DEFAULTS, Stage2ShellRenderer
from nunerf_tpu_torch.tracing.mesh_ops import extract_geometry, vertex_normals_curvature
from nunerf_tpu_torch.tracing.scene import Scene
from nunerf_tpu_torch.train.trainer import TrainStep
from port_helpers import jitter_tree

LR = 1e-3
RTOL_LOSS, RTOL_GRAD, K_COND = 1e-5, 1e-4, 10.0
RN = 16
STEP = 10

S1_CFG = {
    "is_nerf": True, "shader_config": {"sphere_direction": False},
    "n_samples": 8, "n_bg_samples": 4, "n_importance": 8, "up_sample_steps": 2,
    "apply_occ_loss": False, "sdf_n_layers": 4,
}
# the gates release at STEP: the step is past each freeze step and the
# inv_s thresholds are below the inner inv_s
CFG = {
    "is_nerf": True, "zero_thickness": False, "stage1_cfg": S1_CFG,
    "shader_config": {"sphere_direction": False},
    "n_samples_outer": 8, "n_samples_inner": 4,
    "inner_up_rounds": 1, "inner_up_each": 4, "sdf_n_layers": 4,
    "loss": ["nerf_render", "eikonal", "std"], "eikonal_weight": 0.02,
    "mixed_precision": False, "learn_absorption": True,
    "freeze_ior_step": 5, "freeze_ior_inv_s": 0.5,
    "freeze_thickness_step": 5, "freeze_thickness_inv_s": 0.5,
    "freeze_absorption_step": 5, "freeze_absorption_inv_s": 0.5,
}
HELD = {"freeze_ior_inv_s": 1e6, "freeze_thickness_inv_s": 1e6,
        "freeze_absorption_inv_s": 1e6}
PHYSICAL = ("train/ior", "train/thickness", "train/absorption")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small CPU tensors gain nothing from torch's threads, and the suite's
    workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _mesh():
    return extract_geometry(lambda p: np.linalg.norm(p, axis=-1) - 0.5, resolution=12)


def _batch():
    """Half the rays at random around the sphere, half aimed into triangles
    next to vertices of negative curvature on the side facing the camera."""
    rs = np.random.RandomState(0)
    origin = np.array([0.0, 0.0, -2.5], np.float32)
    origins = np.tile(origin[None], (RN, 1))
    verts, tris = _mesh()
    _, curv = vertex_normals_curvature(verts, tris)
    front = (curv[tris[:, 0]] < -1.0) & (verts[tris[:, 0], 2] < -0.25)
    pick = tris[np.flatnonzero(front)[:RN // 2]]
    targets = 0.8 * verts[pick[:, 0]] + 0.1 * verts[pick[:, 1]] + 0.1 * verts[pick[:, 2]]
    n_rand = RN - len(targets)
    targets = np.concatenate([rs.randn(n_rand, 3).astype(np.float32) * 0.35, targets])
    dirs = targets - origins
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return {"rays_o": origins, "rays_d": dirs.astype(np.float32),
            "rgbs": rs.rand(RN, 3).astype(np.float32),
            "masks": (rs.rand(RN) > 0.25).astype(np.float32)}


@pytest.fixture(scope="module")
def setup():
    verts, tris = _mesh()
    jscene = JScene((verts, tris), tile=512)
    # stage 1's tree in the JAX layout, drawn by the port (the JAX init of
    # the stage-1 networks alone takes 17 s eagerly on the CPU)
    s1_tree = to_jax_tree(ShapeRenderer(S1_CFG, device="cpu", seed=7), STAGE1_KEYS)
    s1_params = jitter_tree(s1_tree, 1, 0.05)
    renderer = JShellRenderer(CFG, scene=jscene, stage1_params=s1_params)
    params = renderer.init_params(jax.random.PRNGKey(8))
    params = {"train": jitter_tree(params["train"], 2, 0.05), "frozen": s1_params}
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}

    def loss_fn(p, step):
        out = renderer.train_outputs(p, batch, jax.random.PRNGKey(1), step)
        terms = j_compute_losses(out, batch, step, renderer.cfg)
        return terms["loss_total"], (terms, out)

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
        renderer = JShellRenderer(CFG, scene=scene, stage1_params=p64["frozen"])

        def loss_fn(p, step):
            out = renderer.train_outputs(p, batch, jax.random.PRNGKey(1), step)
            return j_compute_losses(out, batch, step, renderer.cfg)["loss_total"]

        grads = jax.jit(jax.grad(loss_fn))(p64, jnp.asarray(STEP, jnp.int32))
        return {k: np.asarray(v, np.float64) for k, v in flat_leaves(grads).items()}


def _in_dtype(dtype, fn):
    prev = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        return fn()
    finally:
        torch.set_default_dtype(prev)


def _port_renderer(mesh, params, cfg, dtype):
    scene = Scene(mesh, tile=512, device="cpu")
    for name in ("v0", "e1", "e2", "verts", "vertex_normals", "vertex_curvature"):
        setattr(scene, name, getattr(scene, name).to(dtype))
    renderer = Stage2ShellRenderer(cfg, scene, params["frozen"], device="cpu")
    load_jax_params(renderer, params, tree_keys())
    return renderer.to(dtype)


def _port_batch(dtype):
    return {k: torch.as_tensor(v).to(dtype) for k, v in _batch().items()}


def _port_step(mesh, params, cfg, dtype):
    """The port's step: (loss terms, the forward's outputs, gradients, the
    parameters before and after the Adam update)."""
    def run():
        renderer = _port_renderer(mesh, params, cfg, dtype)
        train = TrainStep(renderer, LR)
        assert not any(p.requires_grad for p in renderer.stage1.parameters())
        forward, outputs = renderer.train_outputs, {}

        def keep(batch, step, generator=None):  # the step's own forward
            outputs.update(forward(batch, step, generator))
            return outputs

        renderer.train_outputs = keep
        terms = train.compute_grads(_port_batch(dtype), STEP)
        assert all(p.grad is None for p in renderer.stage1.parameters())
        grads = flat_leaves(to_jax_tree(renderer, tree_keys(), "grad"))
        before = flat_leaves(to_jax_tree(renderer, tree_keys()))
        train.apply()
        after = flat_leaves(to_jax_tree(renderer, tree_keys()))
        out = {k: v.detach().numpy().astype(np.float64) for k, v in outputs.items()}
        return ({k: float(v.detach()) for k, v in terms.items()}, out, grads, before, after)
    return _in_dtype(dtype, run)


def _port_forward(mesh, params, cfg, dtype, fn="train_outputs"):
    def run():
        renderer = _port_renderer(mesh, params, cfg, dtype)
        with torch.no_grad():
            out = getattr(renderer, fn)(_port_batch(dtype), STEP)
        return {k: v.detach().numpy().astype(np.float64) for k, v in out.items()}
    return _in_dtype(dtype, run)


def _bound(rtol, ref64, port32):
    return rtol * np.abs(ref64).max() + K_COND * np.abs(port32 - ref64).max()


def _assert_outputs(jout, o32, o64):
    assert sorted(o32) == sorted(jout)
    for k, v in jout.items():
        v = np.asarray(v, np.float64)
        assert o32[k].shape == v.shape, k
        bound = _bound(RTOL_LOSS, o64[k], o32[k]) + 1e-7
        assert np.abs(o32[k] - v).max() <= bound, (k, np.abs(o32[k] - v).max(), bound)


def test_shell_ray_trace_matches_jax(setup):
    """The three bounces, key by key, on rays that meet both curvature signs
    and total internal reflection."""
    mesh, jscene, params, batch, _ = setup
    jr = JShellRenderer(CFG, scene=jscene, stage1_params=params["frozen"])
    jb, jtir = jax.jit(lambda p: jr.ray_trace(p, batch["rays_o"], batch["rays_d"],
                                              jnp.asarray(STEP, jnp.int32)))(params)
    r = _port_renderer(mesh, params, CFG, torch.float32)
    o, d = torch.as_tensor(_batch()["rays_o"]), torch.as_tensor(_batch()["rays_d"])
    pb, ptir = r.ray_trace(o, d, STEP)
    assert len(pb) == len(jb) == 3

    # the rays meet what the shell branches on: hits of both curvature signs
    # on entry and on exit, and total internal reflection
    hit0 = np.asarray(jb[0]["hit"])
    assert RN // 2 <= hit0.sum() < RN
    res0 = r.scene.dintersect(o, torch.nn.functional.normalize(d, dim=-1))
    k0 = res0["curvature"].detach().numpy()[hit0, 0]
    assert (k0 > 0).any() and (k0 < 0).any(), k0
    hit1 = np.asarray(jb[1]["hit"])
    assert hit1.sum() >= 4
    assert (hit0 & ~np.asarray(jb[0]["conv"])).any()  # TIR or no exit
    assert not np.asarray(jtir).all()

    def trace64():
        r64 = _port_renderer(mesh, params, CFG, torch.float64)
        return r64.ray_trace(o.double(), d.double(), STEP)[0]
    pb64 = _in_dtype(torch.float64, trace64)

    np.testing.assert_array_equal(ptir.numpy(), np.asarray(jtir))
    for i, (a, e, a64) in enumerate(zip(pb, jb, pb64)):
        assert sorted(a) == sorted(e)
        for k in e:
            av, ev = a[k].detach().numpy(), np.asarray(e[k])
            if ev.dtype == bool:
                np.testing.assert_array_equal(av, ev, err_msg=f"bounce {i} {k}")
            else:
                ref = a64[k].detach().numpy()
                bound = _bound(1e-4, ref, av) + 1e-6
                assert np.abs(av - ev).max() <= bound, (i, k, np.abs(av - ev).max(), bound)
    # the chord is the shell's: thickness-sized on converged lanes
    c0 = pb[0]["chord"].detach().numpy()[np.asarray(jb[0]["conv"]), 0]
    assert (c0 > 0.001).all() and (c0 < 0.05).all(), c0


def test_shell_step_matches_jax(setup):
    """The whole step: every loss term and observability output, every
    gradient (IoR, thickness and absorption included), one Adam update."""
    mesh, _, params, _, grad_fn = setup
    (_, (jterms, jout)), jgrads = grad_fn(params, jnp.asarray(STEP, jnp.int32))
    jterms = {k: float(v) for k, v in jterms.items()}
    jgrads = flat_leaves(jgrads)
    jgrads64 = _jax_grads_f64(mesh, params)

    t32, o32, g32, before, after = _port_step(mesh, params, CFG, torch.float32)
    t64, o64, g64, _, _ = _port_step(mesh, params, CFG, torch.float64)

    assert sorted(t32) == sorted(jterms)
    for k in ("thickness_mean", "thickness_frozen", "kappa_r", "ior_frozen"):
        assert k in jterms, k
    assert jterms["thickness_frozen"] == 0.0 and jterms["ior_frozen"] == 0.0
    assert jterms["loss_rgb"] > 1e-2 and jterms["loss_eikonal"] > 0
    for k, v in jterms.items():
        bound = _bound(RTOL_LOSS, np.float64(t64[k]), np.float64(t32[k])) + 1e-9
        assert abs(t32[k] - v) <= bound, (k, t32[k], v, bound)

    _assert_outputs(jout, o32, o64)

    assert sorted(g32) == sorted(jgrads)
    noise = {}
    for k, v in jgrads.items():
        noise[k] = (_bound(RTOL_GRAD, g64[k], g32[k])
                    + K_COND * np.abs(v - jgrads64[k]).max())
        err = np.abs(g32[k] - v).max()
        assert err <= noise[k], (k, err, noise[k])
        if k.startswith("frozen/"):
            assert not v.any() and not g32[k].any(), k
    for head in ("train/sdf_inner", "train/shade_inner", "train/var_inner") + PHYSICAL:
        assert sum(np.abs(v).sum() for k, v in g32.items() if k.startswith(head)) > 0, head

    # one Adam step: optax.adam's update on the port's grads; the frozen
    # subtree is bit-identical
    opt = optax.adam(LR)
    upd, _ = opt.update(g32, opt.init(before), before)
    for k in before:
        if k.startswith("frozen/"):
            np.testing.assert_array_equal(after[k], before[k], err_msg=k)
        else:
            np.testing.assert_allclose(after[k], before[k] + np.asarray(upd[k]),
                                       rtol=1e-6, atol=1e-5 * LR, err_msg=k)


VARIANTS = {
    "test_outputs": ({}, "test_outputs"),
    "gates_held_bg_inverse_diffuse_inner": (
        dict(HELD, bg_sampling="inverse", inner_diffuse_only=True), "train_outputs"),
}


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_shell_outputs_match_jax(setup, name):
    """``render`` through ``train_outputs`` / ``test_outputs``, output by
    output: the validation forward (object mask on the loss), and the three
    gates held with the inverse-depth background law and the DiffuseInner
    shader."""
    mesh, jscene, params, batch, _ = setup
    extra, fn = VARIANTS[name]
    cfg = dict(CFG, **extra)
    jr = JShellRenderer(cfg, scene=jscene, stage1_params=params["frozen"])
    jout = jax.jit(lambda p: getattr(jr, fn)(p, batch, jax.random.PRNGKey(1),
                                             jnp.asarray(STEP, jnp.int32)))(params)
    o32 = _port_forward(mesh, params, cfg, torch.float32, fn)
    o64 = _port_forward(mesh, params, cfg, torch.float64, fn)
    _assert_outputs(jout, o32, o64)
    if name.startswith("gates_held"):
        assert float(jout["ior_frozen"]) == 1.0 and float(jout["thickness_frozen"]) == 1.0

        # held fields get no gradient in the port either
        def run():
            r = _port_renderer(mesh, params, cfg, torch.float32)
            train = TrainStep(r, LR)
            train.compute_grads(_port_batch(torch.float32), STEP)
            return flat_leaves(to_jax_tree(r, tree_keys(), "grad"))
        grads = _in_dtype(torch.float32, run)
        for head in PHYSICAL:
            assert not any(v.any() for k, v in grads.items() if k.startswith(head)), head
        assert any(v.any() for k, v in grads.items() if k.startswith("train/sdf_inner"))


def test_shell_trace_gate_gradients_match_jax(setup):
    """The VJP of ``ray_trace`` into the IoR and thickness fields, with each
    gate held (by the step or by the inv_s threshold) and released; held to
    1e-4 of each leaf's scale plus ten times the port's f32 error (the
    chord's cancellation puts some elements 1e-2 of themselves apart)."""
    mesh, jscene, params, batch, _ = setup
    w = np.arange(1.0, 4.0)
    jax_grads = {}  # one compile per configuration, the step an argument

    def grads(extra, step, dtype=None):
        """JAX's gradients and the port's, or the port's alone in ``dtype``."""
        cfg = dict(CFG, **extra)
        jg = None
        if dtype is None:
            key = tuple(sorted(extra.items()))
            if key not in jax_grads:
                jr = JShellRenderer(cfg, scene=jscene, stage1_params=params["frozen"])

                def loss(p, s):
                    bounces, _ = jr.ray_trace(p, batch["rays_o"], batch["rays_d"], s)
                    return sum(jnp.sum(b["next_dir"] ** 2 * w) + jnp.sum(b["chord"])
                               for b in bounces)

                jax_grads[key] = jax.jit(jax.grad(loss))
            jg = flat_leaves(jax_grads[key](params, jnp.asarray(step, jnp.int32))["train"])
        dt = dtype or torch.float32
        r = _port_renderer(mesh, params, cfg, dt)
        bounces, _ = r.ray_trace(torch.as_tensor(_batch()["rays_o"]).to(dt),
                                 torch.as_tensor(_batch()["rays_d"]).to(dt), step)
        wt = torch.as_tensor(w, dtype=dt)
        sum(torch.sum(b["next_dir"] ** 2 * wt) + torch.sum(b["chord"])
            for b in bounces).backward()
        pg = flat_leaves(to_jax_tree(r, tree_keys(), "grad")["train"])
        pg = {k: v.astype(np.float64) for k, v in pg.items()}
        return pg if dtype else (jg, pg)

    for extra, step, live in (({}, STEP, True), (HELD, STEP, False), ({}, 2, False)):
        jg, pg = grads(extra, step)
        pg64 = _in_dtype(torch.float64, lambda: grads(extra, step, torch.float64))
        for head in ("ior/", "thickness/"):
            keys = sorted(k for k in jg if k.startswith(head))
            assert keys and keys == sorted(k for k in pg if k.startswith(head))
            total = sum(np.abs(pg[k]).sum() for k in keys)
            assert (total > 0) == live, (head, extra, step, total)
            for k in keys:
                bound = _bound(RTOL_GRAD, pg64[k], pg[k]) + 1e-12
                assert np.abs(pg[k] - jg[k]).max() <= bound, (k, np.abs(pg[k] - jg[k]).max(),
                                                              bound)


def test_shell_construction(setup):
    mesh, _, params, _, _ = setup
    scene = Scene(mesh, tile=512, device="cpu")
    r = Stage2ShellRenderer(dict(CFG, mixed_precision=True), scene, params["frozen"],
                            device="cpu")
    assert r.color_inner.refrac_light.exp_max == -0.2
    assert r.color_inner.light_pos_freq == 8 and r.color_inner.refrac_freq == 2
    assert r.cfg["ior_offset"] == SHELL_DEFAULTS["ior_offset"] == 0.6
    assert r._is_internal(2) and not r._is_internal(0)
    # the scene a shell builds itself smooths the curvature over 20 rings
    assert r.cfg.get("curv_smooth_iters") is None
