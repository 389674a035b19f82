"""The nested ``front`` leg's first steps from one step-0 state in both
packages, every draw injected, beside JAX against itself one f32 ulp off
(CPU): the tier-1 twin of ``tools/trained_step_compare.py traj`` from an
``init`` checkpoint, which decided ROADMAP §3.12 (``PERF.md`` §6, PR 19).

``configs/shape/nerf/nested.yaml`` is cut as
``test_torch_port_trained_step.py`` cuts it (a 4-layer SDF, 8 + 8 SDF
samples, 32 rays, ``perturb`` 1.0, f32).  The state is the port's
initialisation with Adam's moments zero, as ``trained_step_compare.py
init`` writes it; its count is set to ``START`` so that the steps cross the
init-SDF regulariser's end at 1,000 inside the warm-up (to 2,000), where
the card's transmission weight collapsed.  Three sides take ``STEPS``
steps from it in f32, each carrying its own parameters and Adam state: the
port, JAX, and JAX from the state with every parameter one f32 ulp up (the
control: how far f32 roundings alone part two runs of one package).  Each
step's draws (``step_draws``: the sampler's four jitters and the occlusion
priorities) go to all three.

Checked after every step: the port's parameters lie within ``K_SPREAD``
times the control's distance from JAX's (global L2), and its shader
transmission weight ``T`` at the scene's outer sphere (radius 0.5; the
median of ``N_T`` points, read as ``traj`` reads it) within ``K_SPREAD``
times the control's gap plus ``T_FLOOR``; and every loss term of the port
within ``RTOL_TERM`` of max(|JAX's|, 1).  A fault in the port's step parts
it from JAX at the first step, orders of magnitude beyond the control.
"""

import importlib.util
import os

import jax
import numpy as np
import optax
import pytest
import torch
import yaml

from nunerf_tpu.models.stage1 import ShapeRenderer as JShapeRenderer
from nunerf_tpu.train.lr import warm_up_cos_schedule as j_schedule
from nunerf_tpu_torch.config import TRAINER_DEFAULTS
from nunerf_tpu_torch.convert import to_jax_tree
from nunerf_tpu_torch.models.stage1 import PARAM_KEYS, ShapeRenderer
from nunerf_tpu_torch.train.lr import warm_up_cos_host
from nunerf_tpu_torch.train.trainer import TrainStep

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RN = 32
CUT = dict(sdf_n_layers=4, n_samples=8, n_importance=8, up_sample_steps=2, n_bg_samples=4,
           n_front_samples=2, n_back_samples=2, perturb=1.0, train_ray_num=RN,
           occ_loss_max_pn=8, mixed_precision=False, sdf_mixed_precision=False)
START, STEPS = 997, 6          # steps 997 ... 1,002
K_SPREAD = 10.0                # the port within this many control spreads of JAX
T_FLOOR = 1e-6                 # below the f32 resolution of T's median
RTOL_TERM = 1e-4
N_T = 1024
R_OUTER = 0.5                  # synth-scene's outer sphere


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


def _lr_args():
    lr = _cfg()["lr_cfg"]
    return dict(lr=lr.get("lr", 5e-4), end_warm=lr["end_warm"], end_iter=lr["end_iter"])


def _dist(a, b):
    return float(np.sqrt(sum(np.sum((np.asarray(a[k], np.float64) - b[k]) ** 2) for k in b)))


@pytest.fixture(scope="module")
def trajectory():
    """Each side's record after every step: (parameters, T percentiles,
    terms)."""
    cfg = _cfg()
    renderer = ShapeRenderer(cfg, device="cpu", seed=TRAINER_DEFAULTS["random_seed"])
    port = tsc.PortSide(renderer, TrainStep(renderer, warm_up_cos_host(**_lr_args())), False,
                        PARAM_KEYS)
    params = to_jax_tree(renderer, PARAM_KEYS)
    zero = jax.tree_util.tree_map(np.zeros_like, params)
    opt = {"count": START, "exp_avg": zero, "exp_avg_sq": zero}
    jr = JShapeRenderer(cfg)
    adam = optax.adam(learning_rate=j_schedule(**_lr_args()))
    jax_side = tsc.JaxSide(jr, adam, False)
    control = tsc.JaxSide(jr, adam, False)
    jax_side.fn = control.fn = tsc.jax_step_fn(jr, adam, jax_side.candidates)
    control.candidates = jax_side.candidates
    port.load(params, opt)
    jax_side.load(params, opt)
    control.load(jax.tree_util.tree_map(
        lambda x: np.nextafter(np.asarray(x, np.float32), np.float32(np.inf)), params), opt)
    trans = tsc.Transmission(cfg, tsc.sphere_points(R_OUTER, N_T))
    batch = _batch()
    out = []
    for i in range(STEPS):
        step = START + i
        draws = tsc.step_draws(cfg, RN, 0, step)[1]
        rec = {}
        for name, side in (("jax", jax_side), ("control", control), ("port", port)):
            terms = side.step(batch, draws, step)[0]
            rec[name] = (side.flat_params(), trans(side), terms)
        out.append((step, rec))
    return out


def test_state_starts_from_the_port_init_with_zero_moments(trajectory):
    steps = [s for s, _ in trajectory]
    assert steps == list(range(START, START + STEPS)) and START < 1000 <= steps[-1] < 2000
    cfg = _cfg()
    assert cfg["lr_cfg"]["end_warm"] == 2000 and cfg["zero_thickness"]


@pytest.mark.parametrize("i", range(STEPS))
def test_port_stays_within_the_control_spread_of_jax(trajectory, i):
    step, rec = trajectory[i]
    jp, jt, jterms = rec["jax"]
    cp, ct, _ = rec["control"]
    pp, pt, pterms = rec["port"]
    spread, gap = _dist(cp, jp), _dist(pp, jp)
    assert spread > 0
    assert gap <= K_SPREAD * spread, (step, gap, spread)
    t_spread = abs(ct[1] - jt[1])
    assert abs(pt[1] - jt[1]) <= K_SPREAD * t_spread + T_FLOOR, (step, pt, jt, ct)
    assert sorted(pterms) == sorted(jterms)
    for k, v in jterms.items():
        assert abs(pterms[k] - v) <= RTOL_TERM * max(abs(v), 1.0), (step, k, pterms[k], v)
    # the init-SDF terms live before its end and off from it, in both
    reg = pterms["loss_sdf_small"] + pterms["loss_sdf_large"]
    if step >= 1000:
        assert reg == 0.0
