"""The port's stage-1 training step against the JAX step (CPU, f32).

Both build ``ShapeRenderer`` from the same JAX parameters (carried by
``nunerf_tpu_torch.convert``) and take the same batch, made with numpy from a
seed.  The draws are made deterministic without reproducing ``jax.random``:
``perturb`` is 0, and ``occ_loss_max_pn`` exceeds the number of inner points,
so the occlusion loss's top-K takes every point and its masked mean does not
depend on their order.

Two steps: step 0 (init-SDF regulariser on; the SDF's last bias is raised so
that its "large" term is not zero) and step 25000 (occlusion loss on).

Tolerances.  Parts of the step are ill-conditioned in f32: the IDE
polynomials reach degree 16 with large alternating coefficients, so the
shader's light-head gradients carry errors near 1e-2 of their scale in any
f32 evaluation.  Each quantity is therefore held to
``rtol * scale + 10 * |port_f32 - port_f64|``: rtol (1e-5 on losses, 1e-4
on gradients, for sum order) plus ten times the port's own f32 error against
the same port in float64, which measures that conditioning.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nunerf_tpu.models.stage1 import ShapeRenderer as JShapeRenderer
from nunerf_tpu.train.loss import compute_losses as j_compute_losses
from nunerf_tpu_torch.convert import flat_leaves, load_jax_params, to_jax_tree
from nunerf_tpu_torch.models.stage1 import PARAM_KEYS, ShapeRenderer
from nunerf_tpu_torch.train.trainer import TrainStep
from port_helpers import jitter_tree

LR = 5e-4
RTOL_LOSS, RTOL_GRAD, K_COND = 1e-5, 1e-4, 10.0
RN = 16

CFG = {
    "is_nerf": True,
    "loss": ["nerf_render", "eikonal", "std", "init_sdf_reg", "occ", "mask",
             "outer_reg"],
    "n_samples": 8, "n_importance": 8, "up_sample_steps": 2,
    "n_bg_samples": 4, "n_front_samples": 2, "n_back_samples": 2,
    "sdf_n_layers": 4, "perturb": 0.0, "train_ray_num": RN,
    "occ_loss_step": 20000, "occ_loss_max_pn": 1 << 20,
    "mixed_precision": False, "sdf_mixed_precision": False,
}


def _batch():
    rs = np.random.RandomState(0)
    origins = np.tile(np.array([[0.0, 0.0, -2.5]], np.float32), (RN, 1))
    dirs = rs.randn(RN, 3).astype(np.float32) * 0.3 - origins
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return {"rays_o": origins, "rays_d": dirs.astype(np.float32),
            "near": np.full((RN, 1), 0.8, np.float32),
            "far": np.full((RN, 1), 4.5, np.float32),
            "rgbs": rs.rand(RN, 3).astype(np.float32),
            "masks": np.ones((RN,), np.float32)}


@pytest.fixture(scope="module")
def jax_side():
    renderer = JShapeRenderer(CFG)
    params = jitter_tree(renderer.init_params(jax.random.PRNGKey(0)), 1, 0.05)
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}

    def loss_fn(p, step):
        out = renderer.train_outputs(p, batch, jax.random.PRNGKey(1), step)
        terms = j_compute_losses(out, batch, step, renderer.cfg)
        return terms["loss_total"], terms

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    return params, grad_fn


def _port_step(params, step, dtype):
    prev = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        renderer = ShapeRenderer(CFG, device="cpu")
        load_jax_params(renderer, params, PARAM_KEYS)
        renderer.to(dtype)
        train = TrainStep(renderer, LR)
        batch = {k: torch.as_tensor(v).to(dtype) for k, v in _batch().items()}
        terms = train.compute_grads(batch, step)
        grads = flat_leaves(to_jax_tree(renderer, PARAM_KEYS, "grad"))
        before = flat_leaves(to_jax_tree(renderer, PARAM_KEYS))
        train.apply()
        after = flat_leaves(to_jax_tree(renderer, PARAM_KEYS))
    finally:
        torch.set_default_dtype(prev)
    terms = {k: float(v.detach()) for k, v in terms.items()}
    return terms, grads, before, after


def _bound(rtol, ref64, port32):
    return rtol * np.abs(ref64).max() + K_COND * np.abs(port32 - ref64).max()


@pytest.mark.parametrize("step", [0, 25000])
def test_stage1_step_matches_jax(jax_side, step):
    params, grad_fn = jax_side
    if step < 1000:
        # raise the SDF (about |x| - 1.2) so the regulariser's "large" term
        # sees outer points with too small an SDF
        params = jax.tree_util.tree_map(np.array, params)
        params["sdf"]["params"][f"lin{CFG['sdf_n_layers']}"]["b"][0] -= 0.7
    (_, jterms), jgrads = grad_fn(params, jnp.asarray(step, jnp.int32))
    jterms = {k: float(v) for k, v in jterms.items()}
    jgrads = flat_leaves(jgrads)

    t32, g32, before, after = _port_step(params, step, torch.float32)
    t64, g64, _, _ = _port_step(params, step, torch.float64)

    # the gated terms are live in this step
    if step < 1000:
        assert jterms["loss_sdf_large"] > 1e-3
    else:
        assert jterms["loss_occ"] > 1e-3 and jterms["loss_outer_reg"] > 0

    assert sorted(t32) == sorted(jterms)
    for k, v in jterms.items():
        bound = _bound(RTOL_LOSS, np.float64(t64[k]), np.float64(t32[k])) + 1e-9
        assert abs(t32[k] - v) <= bound, (k, t32[k], v, bound)

    assert sorted(g32) == sorted(jgrads)
    noise = {}
    for k, v in jgrads.items():
        noise[k] = _bound(RTOL_GRAD, g64[k], g32[k])
        err = np.abs(g32[k] - v).max()
        assert err <= noise[k], (k, err, noise[k])

    # one Adam step: the port's update is optax.adam's on the port's grads,
    # to 1e-5 of the step size (the two order their f32 operations apart)
    opt = optax.adam(LR)
    upd, _ = opt.update(g32, opt.init(before), before)
    for k in before:
        np.testing.assert_allclose(after[k], before[k] + np.asarray(upd[k]),
                                   rtol=1e-6, atol=1e-5 * LR, err_msg=k)

    # ... and the parameters after it match JAX's.  Where the gradient is
    # clear of the noise bound both take the same step; elsewhere Adam's
    # first step (lr * g / (|g| + eps)) may differ by at most 2 lr.
    jupd, _ = opt.update(jgrads, opt.init(before), before)
    for k in before:
        jafter = before[k] + np.asarray(jupd[k])
        clear = np.abs(jgrads[k]) > 10.0 * noise[k] + 1e-6
        diff = np.abs(after[k] - jafter)
        assert (diff[clear] <= 1e-6 + 1e-6 * np.abs(jafter[clear])).all(), k
        assert (diff <= 2 * LR + 1e-6).all(), k


def _port_forward(params, cfg, dtype, fn, step):
    prev = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        renderer = ShapeRenderer(cfg, device="cpu")
        load_jax_params(renderer, params, PARAM_KEYS)
        renderer.to(dtype)
        batch = {k: torch.as_tensor(v).to(dtype) for k, v in _batch().items()}
        with torch.no_grad():
            out = getattr(renderer, fn)(batch, step)
    finally:
        torch.set_default_dtype(prev)
    return {k: v.detach().numpy().astype(np.float64) for k, v in out.items()
            if torch.is_tensor(v)}


@pytest.mark.parametrize("fn,partition", [("train_outputs", False),
                                          ("test_outputs", True)])
def test_stage1_forward_paths_match_jax(jax_side, fn, partition):
    """The unpartitioned sampler + ``render_core`` (both branches at every
    sample), and the validation forward (``test_outputs``:
    ``compute_validation_info`` with the shader's inter results), output by
    output, at step 25000 (occlusion loss on)."""
    params, _ = jax_side
    cfg = dict(CFG, partition_samples=partition)
    renderer = JShapeRenderer(cfg)
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    step = 25000
    jout = jax.jit(lambda p: getattr(renderer, fn)(p, batch, jax.random.PRNGKey(1),
                                                   jnp.asarray(step)))(params)
    o32 = _port_forward(params, cfg, torch.float32, fn, step)
    o64 = _port_forward(params, cfg, torch.float64, fn, step)
    assert sorted(o32) == sorted(jout)
    for k, v in jout.items():
        v = np.asarray(v, np.float64)
        bound = _bound(RTOL_LOSS, o64[k], o32[k]) + 1e-7
        assert np.abs(o32[k] - v).max() <= bound, (k, np.abs(o32[k] - v).max(), bound)
    if fn == "train_outputs":
        assert jout["loss_occ"] > 1e-3


def test_warm_up_cos_schedule_matches_jax():
    from nunerf_tpu.train.lr import warm_up_cos_schedule as j_sched
    from nunerf_tpu_torch.train.lr import warm_up_cos_schedule

    kw = dict(lr=5e-4, end_warm=5000, end_iter=300000, alpha=0.05)
    jf, tf = j_sched(**kw), warm_up_cos_schedule(**kw)
    for step in (0, 1, 2500, 4999, 5000, 5001, 150000, 299999, 300000):
        assert abs(tf(step) - float(jf(step))) <= 1e-6 * kw["lr"], step
