"""Whole training steps with the fused gates on (CPU, f32, small sizes):

* path A - stage 1 with ``fused_sdf``: ``sdf_all`` through the
  value+Jacobian chain (K4/K5's plain version here);
* path B - stage 2 with ``fused_sdf``: the inner SDF the same way;
* path C - stage 1 with ``fused_mlp``: the NeRF++ trunk and the shading
  heads through the fused chain (K1/K2's plain version), ``sdf`` on the
  fused value path.

Each is held to the port's own step with the key off - same JAX parameter
tree (carried by ``nunerf_tpu_torch.convert``), same batch, no random draws
(``perturb`` 0, the occlusion subset takes every point) - and path A also to
the JAX step with ``fused_sdf: True`` (K4/K5 in Pallas interpret mode).  The
JAX stage-2 graph takes about a minute to compile and is not compiled again
here: its fused inner SDF is held at ``fused_sdf_all`` level in
``tests/test_torch_port_jac.py``.

Tolerances.  In f32 the fused and the plain step are the same function, but
parts of the step are ill-conditioned (the shader's IDE polynomials: the
light heads' gradients carry f32 errors near 1e-2 of their scale in any
evaluation).  As in the stage-1 and stage-2 step tests each quantity is held
to ``rtol * scale + 10 * |plain_f32 - plain_f64|``: rtol 1e-5 on losses and
1e-4 on gradients for the sum order, plus ten times the plain step's own f32
error, which measures that conditioning.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nunerf_tpu.models.stage1 import ShapeRenderer as JShapeRenderer
from nunerf_tpu.models.stage2 import Stage2Renderer as JStage2Renderer
from nunerf_tpu.tracing.scene import Scene as JScene
from nunerf_tpu.train.loss import compute_losses as j_compute_losses
from nunerf_tpu_torch.convert import flat_leaves, load_jax_params, to_jax_tree
from nunerf_tpu_torch.models import stage1 as s1mod
from nunerf_tpu_torch.models import stage2 as s2mod
from nunerf_tpu_torch.ops import fused_mlp as tfm
from nunerf_tpu_torch.tracing.mesh_ops import extract_geometry
from nunerf_tpu_torch.tracing.scene import Scene
from nunerf_tpu_torch.train.trainer import TrainStep
from port_helpers import jitter_tree

LR = 5e-4
RTOL_LOSS, RTOL_GRAD, K_COND = 1e-5, 1e-4, 10.0
STEP1, STEP2 = 25000, 10

S1_CFG = {
    "is_nerf": True,
    "loss": ["nerf_render", "eikonal", "std", "init_sdf_reg", "occ", "mask",
             "outer_reg"],
    "n_samples": 8, "n_importance": 8, "up_sample_steps": 2,
    "n_bg_samples": 4, "n_front_samples": 2, "n_back_samples": 2,
    "sdf_n_layers": 4, "perturb": 0.0, "train_ray_num": 16,
    "occ_loss_step": 20000, "occ_loss_max_pn": 1 << 20,
    "mixed_precision": False, "sdf_mixed_precision": False,
}
S2_STAGE1_CFG = {
    "is_nerf": True, "shader_config": {"sphere_direction": False},
    "n_samples": 8, "n_bg_samples": 4, "n_importance": 8, "up_sample_steps": 2,
    "apply_occ_loss": False, "sdf_n_layers": 4,
}
S2_CFG = {
    "is_nerf": True, "zero_thickness": True, "stage1_cfg": S2_STAGE1_CFG,
    "shader_config": {"sphere_direction": False},
    "n_samples_outer": 8, "n_bg_importance": 2, "n_samples_inner": 4,
    "inner_up_rounds": 1, "inner_up_each": 4, "sdf_n_layers": 4,
    "loss": ["nerf_render", "eikonal", "std"], "eikonal_weight": 0.02,
    "mixed_precision": False,
}


def _batch(rn, spread, stage2=False):
    rs = np.random.RandomState(0)
    origins = np.tile(np.array([[0.0, 0.0, -2.5]], np.float32), (rn, 1))
    dirs = rs.randn(rn, 3).astype(np.float32) * spread - origins
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    b = {"rays_o": origins, "rays_d": dirs.astype(np.float32)}
    if not stage2:
        b.update(near=np.full((rn, 1), 0.8, np.float32),
                 far=np.full((rn, 1), 4.5, np.float32))
    b["rgbs"] = rs.rand(rn, 3).astype(np.float32)
    if not stage2:
        b["masks"] = np.ones((rn,), np.float32)
    return b


def _in_dtype(dtype, fn):
    prev = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        return fn()
    finally:
        torch.set_default_dtype(prev)


def _run_step(make_renderer, keys, batch, step, dtype):
    """(terms, grads, params before, params after one Adam step, renderer)."""
    def run():
        renderer = make_renderer().to(dtype)
        train = TrainStep(renderer, LR)
        tb = {k: torch.as_tensor(v).to(dtype) for k, v in batch.items()}
        terms = train.compute_grads(tb, step)
        grads = flat_leaves(to_jax_tree(renderer, keys, "grad"))
        before = flat_leaves(to_jax_tree(renderer, keys))
        train.apply()
        after = flat_leaves(to_jax_tree(renderer, keys))
        return ({k: float(v.detach()) for k, v in terms.items()}, grads, before,
                after, renderer)
    return _in_dtype(dtype, run)


def _bound(rtol, ref64, plain32):
    return rtol * np.abs(ref64).max() + K_COND * np.abs(plain32 - ref64).max()


def _assert_steps_agree(fused, plain32, plain64):
    """The fused step's losses, gradients and updated parameters against the
    plain step's, with the plain step in float64 as the measure of f32 noise."""
    tf_, gf, before_f, after_f = fused
    t32, g32, before, after = plain32
    t64, g64 = plain64[:2]
    assert sorted(tf_) == sorted(t32)
    for k, v in t32.items():
        bound = _bound(RTOL_LOSS, np.float64(t64[k]), np.float64(v)) + 1e-9
        assert abs(tf_[k] - v) <= bound, (k, tf_[k], v, bound)
    assert sorted(gf) == sorted(g32)
    for k, v in g32.items():
        noise = _bound(RTOL_GRAD, g64[k], v)
        err = np.abs(gf[k] - v).max()
        assert err <= noise, (k, err, noise)
        # one Adam step: the same step where the gradient is clear of the
        # noise; elsewhere Adam's first step (lr * g / (|g| + eps)) may
        # differ by at most 2 lr
        np.testing.assert_array_equal(before_f[k], before[k], err_msg=k)
        clear = np.abs(v) > 10.0 * noise + 1e-6
        diff = np.abs(after_f[k] - after[k])
        assert (diff[clear] <= 1e-6 + 1e-6 * np.abs(after[k][clear])).all(), k
        assert (diff <= 2 * LR + 1e-6).all(), k


# ------------------------------------------------------------------ stage 1

@pytest.fixture(scope="module")
def stage1_params():
    renderer = JShapeRenderer(S1_CFG)
    return jitter_tree(renderer.init_params(jax.random.PRNGKey(0)), 1, 0.05)


def _stage1_step(params, extra, dtype):
    def make():
        r = s1mod.ShapeRenderer(dict(S1_CFG, **extra), device="cpu")
        load_jax_params(r, params, s1mod.PARAM_KEYS)
        return r
    return _run_step(make, s1mod.PARAM_KEYS, _batch(16, 0.3), STEP1, dtype)


@pytest.fixture(scope="module")
def stage1_plain(stage1_params):
    return (_stage1_step(stage1_params, {}, torch.float32)[:4],
            _stage1_step(stage1_params, {}, torch.float64)[:4])


@pytest.mark.parametrize("key", ["fused_sdf", "fused_mlp"])
def test_stage1_fused_step_matches_the_plain_step(stage1_params, stage1_plain, key):
    """Paths A and C: every loss, every gradient and the parameters after one
    Adam step; the occlusion loss is live; no kernel is launched on the CPU."""
    tfm.reset_launches()
    *fused, renderer = _stage1_step(stage1_params, {key: True}, torch.float32)
    assert renderer.fused_sdf == (key == "fused_sdf")
    assert renderer.fused == (key == "fused_mlp")
    assert renderer.outer_nerf.fused == renderer.color_net.albedo.fused == renderer.fused
    assert not any(tfm.launches.values())
    assert fused[0]["loss_occ"] > 1e-3 and fused[0]["loss_eikonal"] > 0
    _assert_steps_agree(fused, *stage1_plain)


def test_stage1_gates_follow_cfg_then_env(monkeypatch):
    for name in ("NUNERF_FUSED_SDF", "NUNERF_FUSED_MLP"):
        monkeypatch.delenv(name, raising=False)
    cfg = {"sdf_n_layers": 2}
    r = s1mod.ShapeRenderer(cfg, device="cpu")
    assert not (r.fused or r.fused_sdf or r.fused_sdf_value)
    monkeypatch.setenv("NUNERF_FUSED_SDF", "1")
    monkeypatch.setenv("NUNERF_FUSED_MLP", "1")
    r = s1mod.ShapeRenderer(cfg, device="cpu")
    assert r.fused and r.fused_sdf and r.color_net.metallic.fused
    # an explicit cfg key wins over the env
    r = s1mod.ShapeRenderer(dict(cfg, fused_sdf=False, fused_mlp=False), device="cpu")
    assert not (r.fused or r.fused_sdf or r.outer_nerf.fused)
    # fused_mlp puts the value-only SDF on the fused path too
    x = torch.zeros((5, 3))
    r = s1mod.ShapeRenderer(dict(cfg, fused_mlp=True, fused_sdf=False), device="cpu")
    assert r.sdf(x).shape == (5, 1)
    torch.testing.assert_close(r.sdf(x), r.sdf_net(x)[..., :1], rtol=1e-5, atol=1e-6)


def test_stage1_fused_sdf_step_matches_jax(stage1_params, stage1_plain):
    """Path A against the JAX step with ``fused_sdf: True`` (K4 forward and
    K5 backward in interpret mode inside the jitted step)."""
    cfg = dict(S1_CFG, fused_sdf=True)
    renderer = JShapeRenderer(cfg)
    assert renderer.fused_sdf
    batch = {k: jnp.asarray(v) for k, v in _batch(16, 0.3).items()}

    def loss_fn(p, step):
        out = renderer.train_outputs(p, batch, jax.random.PRNGKey(1), step)
        terms = j_compute_losses(out, batch, step, renderer.cfg)
        return terms["loss_total"], terms

    (_, jterms), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        stage1_params, jnp.asarray(STEP1, jnp.int32))
    jterms = {k: float(v) for k, v in jterms.items()}
    jgrads = flat_leaves(jgrads)

    t32, g32 = _stage1_step(stage1_params, {"fused_sdf": True}, torch.float32)[:2]
    (p32, pg32, _, _), (p64, pg64, _, _) = stage1_plain
    assert sorted(t32) == sorted(jterms) and jterms["loss_occ"] > 1e-3
    for k, v in jterms.items():
        bound = _bound(RTOL_LOSS, np.float64(p64[k]), np.float64(p32[k])) + 1e-9
        assert abs(t32[k] - v) <= bound, (k, t32[k], v, bound)
    assert sorted(g32) == sorted(jgrads)
    for k, v in jgrads.items():
        noise = _bound(RTOL_GRAD, pg64[k], pg32[k])
        assert np.abs(g32[k] - v).max() <= noise, (k, np.abs(g32[k] - v).max(), noise)


# ------------------------------------------------------------------ stage 2

@pytest.fixture(scope="module")
def stage2_setup():
    mesh = extract_geometry(lambda p: np.linalg.norm(p, axis=-1) - 0.5, resolution=12)
    s1 = JShapeRenderer(S2_STAGE1_CFG)
    s1_params = jitter_tree(s1.init_params(jax.random.PRNGKey(7)), 1, 0.05)
    renderer = JStage2Renderer(S2_CFG, scene=JScene(mesh, tile=512),
                               stage1_params=s1_params)
    params = renderer.init_params(jax.random.PRNGKey(8))
    return mesh, {"train": jitter_tree(params["train"], 2, 0.05), "frozen": s1_params}


def _stage2_step(mesh, params, extra, dtype):
    def make():
        scene = Scene(mesh, tile=512, device="cpu")
        for name in ("v0", "e1", "e2", "verts", "vertex_normals", "vertex_curvature"):
            setattr(scene, name, getattr(scene, name).to(dtype))
        r = s2mod.Stage2Renderer(dict(S2_CFG, **extra), scene, params["frozen"],
                                 device="cpu")
        load_jax_params(r, params, s2mod.tree_keys())
        return r
    return _run_step(make, s2mod.tree_keys(), _batch(8, 0.35, stage2=True), STEP2, dtype)


def test_stage2_fused_sdf_step_matches_the_plain_step(stage2_setup):
    """Path B: the inner SDF through the value+Jacobian chain; the frozen
    stage-1 subtree gets no gradient and does not move."""
    mesh, params = stage2_setup
    tfm.reset_launches()
    *fused, renderer = _stage2_step(mesh, params, {"fused_sdf": True}, torch.float32)
    assert renderer.fused_sdf and not renderer.stage1.fused_sdf
    assert not any(tfm.launches.values())
    assert all(p.grad is None for p in renderer.stage1.parameters())
    for k in fused[2]:
        if k.startswith("frozen/"):
            np.testing.assert_array_equal(fused[3][k], fused[2][k], err_msg=k)
            assert not fused[1][k].any(), k
    assert sum(np.abs(v).sum() for k, v in fused[1].items()
               if k.startswith("train/sdf_inner")) > 0
    assert fused[0]["loss_eikonal"] > 0
    plain32 = _stage2_step(mesh, params, {}, torch.float32)
    assert not plain32[4].fused_sdf
    _assert_steps_agree(fused, plain32[:4], _stage2_step(mesh, params, {}, torch.float64)[:4])
