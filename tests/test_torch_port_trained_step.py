"""The port's stage-1 step against JAX's with the sampler's jitter on and
Adam's state carried over three steps, on the CPU.

``configs/shape/nerf/nested.yaml`` (the ``front`` leg) is cut as
``test_torch_port_leg_schedule.py`` cuts it (``CUT``: a 4-layer SDF, 8 + 8
SDF samples, 32 rays, ``occ_loss_max_pn`` 8) but keeps ``perturb`` 1.0
through ``sample_ray_partitioned``.  Three consecutive steps, 19,999 /
20,000 / 20,001 (``outer_reg`` starts at 20,000), from the port's init
jittered off it and Adam's moments made from JAX's own gradient there
(``count`` 19,999), so that every update after the first is no longer the
gradient's sign.

Every draw is injected into both packages (``tools/trained_step_compare.py``:
``jax.random.uniform`` and ``torch.rand`` hand out, in call order and
checked by shape, the front and back gap fractions, the background tail,
the chord jitter of ``_hierarchical_inner`` and the occlusion priorities).
JAX's dense layers pin float32 even on float64 operands; its float64 step
runs with those pins lifted (``jax_layers_in_f64``), so that both sides
compute the same step in float64.

* float64: each package carries its own parameters and Adam state through
  the three steps.  Each step's terms within ``RTOL64_LOSS`` of max(|term|,
  1), gradients within ``RTOL64_GRAD`` and updates within ``RTOL64_UPDATE``
  of each leaf's scale; the same occlusion candidates and ``spec_mask``
  count; ``loss_outer_reg`` 0 before 20,000 only; after the three steps
  every parameter and both moments within ``RTOL64_STATE`` of each leaf's
  scale (measured: terms 7e-16, gradients 2.0e-12, updates 8.6e-11, state
  5.8e-13).
* f32: at each step both packages start from the same state (JAX's float64
  trajectory, rounded to f32) and take one step; terms and gradients held by
  ``port_helpers.assert_close_calibrated`` against both packages' float64
  step from that state (rtol ``RTOL_LOSS`` / ``RTOL_GRAD``, as the leg
  test); the port's update is Adam's (``optax.scale_by_adam``'s formula,
  in numpy) from the carried moments on the port's own gradients.
"""

import importlib.util
import os
import threading

import jax
import numpy as np
import optax
import pytest
import torch
import yaml

from nunerf_tpu.models.stage1 import ShapeRenderer as JShapeRenderer
from nunerf_tpu.train.lr import warm_up_cos_schedule as j_schedule
from nunerf_tpu_torch.convert import flat_leaves, to_jax_tree
from nunerf_tpu_torch.models.stage1 import PARAM_KEYS, ShapeRenderer
from nunerf_tpu_torch.train.lr import warm_up_cos_host
from nunerf_tpu_torch.train.trainer import TrainStep
from port_helpers import assert_close_calibrated, jitter_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = [19999, 20000, 20001]
RN = 32
CUT = dict(sdf_n_layers=4, n_samples=8, n_importance=8, up_sample_steps=2, n_bg_samples=4,
           n_front_samples=2, n_back_samples=2, perturb=1.0, train_ray_num=RN,
           occ_loss_max_pn=8, mixed_precision=False, sdf_mixed_precision=False)
RTOL_LOSS, RTOL_GRAD, K_COND = 1e-5, 1e-4, 10.0
RTOL64_LOSS, RTOL64_GRAD, RTOL64_UPDATE, RTOL64_STATE = 1e-12, 1e-9, 1e-8, 1e-10


def _tool():
    spec = importlib.util.spec_from_file_location(
        "trained_step_compare", os.path.join(ROOT, "tools", "trained_step_compare.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


tsc = _tool()


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    with open(os.path.join(ROOT, "configs/shape/nerf/nested.yaml")) as f:
        return dict(yaml.safe_load(f), **CUT)


def _batch():
    rs = np.random.RandomState(0)
    origins = np.tile(np.array([[0.0, 0.0, -2.5]], np.float32), (RN, 1))
    dirs = rs.randn(RN, 3).astype(np.float32) * 0.3 - origins
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return {"rays_o": origins, "rays_d": dirs.astype(np.float32),
            "near": np.full((RN, 1), 0.8, np.float32),
            "far": np.full((RN, 1), 4.5, np.float32),
            "rgbs": rs.rand(RN, 3).astype(np.float32),
            "masks": (rs.rand(RN) < 0.7).astype(np.float32)}


def _draws(cfg, step):
    return tsc.step_draws(cfg, RN, 0, 7 + step)[1]


def _lr_args():
    lr = _cfg()["lr_cfg"]
    return dict(lr=lr.get("lr", 5e-4), end_warm=lr["end_warm"], end_iter=lr["end_iter"])


def _jax_side(f64):
    opt = optax.adam(learning_rate=j_schedule(**_lr_args()))
    return tsc.JaxSide(JShapeRenderer(_cfg()), opt, f64)


def _port_side(f64):
    """The port's renderer and ``TrainStep``; in float64 its lr is JAX's
    schedule evaluated in float64, as JAX's float64 step evaluates it (the
    port's own schedule is f32, ``warm_up_cos_host``: 9e-8 of each update
    off, which the next steps' occlusion head turns into 5e-7 of its
    gradient)."""
    renderer = ShapeRenderer(_cfg(), device="cpu")
    if f64:
        def schedule(count):
            with jax.enable_x64(True):
                return float(j_schedule(**_lr_args())(count))
    else:
        schedule = warm_up_cos_host(**_lr_args())
    return tsc.PortSide(renderer, TrainStep(renderer, schedule), f64, PARAM_KEYS)


@pytest.fixture(scope="module")
def jax_sides():
    """JAX's float64 and f32 sides, their steps traced one after the other
    and compiled side by side (XLA's compile leaves the interpreter free),
    and the port's init (JAX's layout) jittered off it."""
    p = _port_side(False)
    params = jitter_tree(to_jax_tree(p.renderer, PARAM_KEYS), 1, 0.05)
    zero = jax.tree_util.tree_map(np.zeros_like, params)
    sides, threads = [], []
    for f64 in (True, False):
        j = _jax_side(f64)
        j.load(params, {"count": 0, "exp_avg": zero, "exp_avg_sq": zero})
        lowered = j.lower(_batch(), _draws(j.cfg, STEPS[0]), STEPS[0])
        threads.append(threading.Thread(
            target=lambda j=j, lowered=lowered: setattr(j, "compiled", lowered.compile())))
        threads[-1].start()
        sides.append(j)
    for thread in threads:
        thread.join()
    assert all(j.compiled is not None for j in sides)
    return sides[0], sides[1], params


def _start(j, params):
    """Adam's state at count 19,999: moments made from the float64 gradient
    at ``params`` of the JAX side ``j`` (``exp_avg`` about half of it,
    ``exp_avg_sq`` about its square)."""
    zero = jax.tree_util.tree_map(np.zeros_like, params)
    j.load(params, {"count": 0, "exp_avg": zero, "exp_avg_sq": zero})
    grads = j.step(_batch(), _draws(j.cfg, STEPS[0]), STEPS[0])[1]
    rs = np.random.RandomState(3)
    mu, nu = {}, {}
    for k, g in grads.items():
        mu[k] = (0.5 * g * (1 + 0.2 * rs.randn(*g.shape))).astype(np.float32)
        nu[k] = (g * g * (1 + rs.rand(*g.shape)) + 1e-20).astype(np.float32)
    return {"count": STEPS[0], "exp_avg": _tree(params, mu), "exp_avg_sq": _tree(params, nu)}


def _tree(like, flat):
    """``flat`` ('a/b/c' -> array) in the layout of the JAX tree ``like``."""
    paths = jax.tree_util.tree_flatten_with_path(like)[0]
    leaves = []
    for path, _ in paths:
        key = "/".join(p.key for p in path if p.key != "params")
        leaves.append(flat[key])
    return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(like), leaves)


@pytest.fixture(scope="module")
def f64_runs(jax_sides):
    """Both packages' float64 trajectories: per step (JAX state before it,
    JAX result, port result), and each package's state after the last."""
    j, _, params = jax_sides
    p = _port_side(True)
    opt = _start(j, params)
    j.load(params, opt)
    p.load(params, opt)
    batch = _batch()
    steps = []
    for step in STEPS:
        state = (j.flat_params(), j.adam_state())
        draws = _draws(j.cfg, step)
        steps.append((state, j.step(batch, draws, step), p.step(batch, draws, step)))
    port_state = {"params": p.flat_params(), "exp_avg": p.flat_moments("exp_avg"),
                  "exp_avg_sq": p.flat_moments("exp_avg_sq")}
    adam = j.adam_state()
    jax_state = {"params": j.flat_params(), "exp_avg": flat_leaves(adam["exp_avg"]),
                 "exp_avg_sq": flat_leaves(adam["exp_avg_sq"])}
    return params, steps, port_state, jax_state


def test_three_steps_match_in_float64(f64_runs):
    _, steps, port_state, jax_state = f64_runs
    for step, (_, jres, pres) in zip(STEPS, steps):
        rec = tsc.compare_step(pres, jres)
        for k, r in rec["terms"].items():
            assert r["err"] <= RTOL64_LOSS * max(abs(r["jax"]), 1.0), (step, k, r)
        for k, r in rec["grads"].items():
            assert r["err"] <= RTOL64_GRAD * r["scale"] + 1e-300, (step, k, r)
        assert rec["worst_update"][0][0] <= RTOL64_UPDATE, (step, rec["worst_update"])
        assert rec["candidates"]["equal"], (step, rec["candidates"])
        # one subset a step, of 8 points out of more candidates
        assert rec["candidates"]["subset"] == [8] and rec["candidates"]["port"][0] > 8
        assert rec["spec_mask"]["port"] == rec["spec_mask"]["jax"] > 0
        assert (jres[0]["loss_outer_reg"] > 0) == (step >= 20000), (step, jres[0])
        assert (pres[0]["loss_outer_reg"] > 0) == (step >= 20000), (step, pres[0])
    for part in ("params", "exp_avg", "exp_avg_sq"):
        got, want = port_state[part], jax_state[part]
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            err = np.abs(np.asarray(got[k], np.float64) - w).max()
            assert err <= RTOL64_STATE * np.abs(w).max() + 1e-300, (part, k, err)


def test_three_steps_match_in_f32(jax_sides, f64_runs):
    """Each step from the same state in both packages: the float64 runs'
    state before it, rounded to f32."""
    params0, steps, _, _ = f64_runs
    j, p = jax_sides[1], _port_side(False)
    batch = _batch()
    for step, (state, jres64, pres64) in zip(STEPS, steps):
        flat, adam = state
        params = _tree(params0, {k: v.astype(np.float32) for k, v in flat.items()})
        opt = {"count": adam["count"],
               "exp_avg": jax.tree_util.tree_map(lambda x: x.astype(np.float32), adam["exp_avg"]),
               "exp_avg_sq": jax.tree_util.tree_map(lambda x: x.astype(np.float32),
                                                    adam["exp_avg_sq"])}
        assert opt["count"] == step
        j.load(params, opt)
        p.load(params, opt)
        draws = _draws(j.cfg, step)
        jterms, jgrads, _, jmasks, jspec = j.step(batch, draws, step)
        before = p.flat_params()
        pterms, pgrads, pupd, pcands, pspec = p.step(batch, draws, step)
        assert [m.sum() for m, _ in pcands] == [m.sum() for m in jmasks]
        assert pspec == jspec
        assert sorted(pterms) == sorted(jterms)
        for k, v in jterms.items():
            assert_close_calibrated(np.float64(pterms[k]), np.float64(v),
                                    np.float64(pres64[0][k]), RTOL_LOSS, K_COND,
                                    what=f"{step} {k}", expected64=np.float64(jres64[0][k]))
        assert sorted(pgrads) == sorted(jgrads)
        for k, v in jgrads.items():
            assert_close_calibrated(pgrads[k], v, pres64[1][k], RTOL_GRAD, K_COND,
                                    what=f"{step} {k}", expected64=jres64[1][k])
        # the port's Adam from the carried moments: optax.scale_by_adam's
        # formula on the port's own gradients, in f32
        lr, b1, b2, eps, t = p.train.optimizer.param_groups[0]["lr"], 0.9, 0.999, 1e-8, step + 1
        assert lr == pytest.approx(float(j_schedule(**_lr_args())(step)), rel=1e-6)
        mu, nu = flat_leaves(opt["exp_avg"]), flat_leaves(opt["exp_avg_sq"])
        assert sorted(before) == sorted(pgrads) == sorted(mu)
        for k, g in pgrads.items():
            m = b1 * mu[k] + (1 - b1) * g
            v = b2 * nu[k] + (1 - b2) * g * g
            u = -lr * (m / (1 - b1 ** t)) / (np.sqrt(v / (1 - b2 ** t)) + eps)
            # (the port's update is read as after - before, in f32: a few
            # ulps of the parameter)
            atol = 4 * np.finfo(np.float32).eps * np.abs(before[k]).max() + 1e-6 * np.abs(u).max()
            np.testing.assert_allclose(pupd[k], u, rtol=1e-5, atol=atol, err_msg=f"{step} {k}")
