"""The port's curvature-shell stage-2 step against the JAX step under the
``shell_stage2`` leg's own config, at its schedule gates, and under the
``shell_stage2b`` leg's at its absorption gate (CPU).

``configs/stage2/nerf/nested_shell.yaml`` and the stage-1 config it names
(``configs/shape/nerf/nested_shell.yaml``, the frozen nets') are read as
they are; only depth and sample counts are cut (``S2_CUT``, ``S1_CUT``: 4-layer
SDFs, 8 outer and 4 + 1x4 inner samples, 16 rays on the marched sphere of
``test_torch_port_shell.py``).  Every key of the schedule stays:
``freeze_inv_s_step`` 1,500, ``freeze_ior_step`` and
``freeze_thickness_step`` 3,000, ``freeze_thickness_inv_s`` 100,
``anneal_end`` 8,000, the inv_s floor from 32 at 10,000 to 300 at 28,000,
the warm-up cosine lr of ``lr_cfg`` (1,000 / 30,000), ``inner_diffuse_only``,
``learn_absorption``, ``sdf_mixed_precision`` and the frozen nets'
``mixed_precision`` (stage 2's, on by default).  One whole step
(``train_outputs``, ``compute_losses``, one Adam update at the schedule's
lr through ``TrainStep``) is held at the steps on both sides of each gate
(``STEPS``); at 3,000 also with the inner inv_s on each side of
``freeze_thickness_inv_s`` (``INV_S``: 80 and 120), so that both branches of
the thickness gate are seen.  Stage 2 draws no random numbers; its one
draw, the rays, is the batch handed to both packages.

``configs/stage2/nerf/nested_shell_b.yaml`` is that config with the
absorption held at its init before ``freeze_absorption_step`` 3,000 and
while the inner inv_s is under ``freeze_absorption_inv_s`` 200: the same
step, checks and tolerances at 2,999 and 3,000 (``CASES_B``), each at the
jittered init's inv_s and at 180 and 220 (``INV_S_B``), so that at 3,000
the absorption is held at 180 and trains at 220 while the thickness gate
(100) is open at both.  The absorption's gradient is zero exactly where
the gate holds it, in both packages.  JAX's steps under that config are
traced and compiled beside the first config's, in the same fixture.

The JAX step is jitted once a kind (f32, float64, bf16) with the step and
the inner inv_s parameter as traced arguments, and its float64 step runs
with JAX's float32 pins lifted (``tools/trained_step_compare.py``'s
``jax_layers_in_f64``).

Checks, in f32 (``mixed_precision`` and ``sdf_mixed_precision`` off in both
configs): every loss term and output within ``RTOL_LOSS`` of its scale and
every gradient within ``RTOL_GRAD`` of its scale, each plus ten times both
packages' own f32 error against their float64 step
(``port_helpers.assert_close_calibrated``, the bounds of
``test_torch_port_shell.py``); in float64 the terms and gradients of the two
packages within ``RTOL64_LOSS`` / ``RTOL64_GRAD`` of scale, with no
conditioning term.  The gates, in both packages: the inner inv_s gradient
zero before 1,500 and where the floor lifts inv_s above its value (from
10,000 at inv_s 20), live otherwise; ``ior_frozen`` before 3,000;
``thickness_frozen`` before 3,000 and while the floored inv_s is under 100;
the IoR and thickness heads' gradients zero exactly where they are frozen;
the lr the schedule's.

In bf16 (the configs' precision) each quantity of the port is held to
JAX's within ``BF16_RTOL_* * scale + K_BF16 * |jax_bf16 - jax_f32|``, as
``test_torch_port_leg_schedule.py`` holds the stage-1 step: JAX's own bf16
rounding, measured against its f32 step, and none of the port's.

The Adam update: the port's equals optax.adam's at the schedule's lr on
the port's own gradients, and where JAX's gradient is clear of the bound
above, JAX's update (at least ``ADAM_HELD_F32`` / ``ADAM_HELD_BF16`` of the
trainable parameters).

Measured: in float64 the terms within 2.0e-16 of max(|term|, 1), the
outputs within 1.3e-14 and the gradients within 5.9e-13 of scale (the
bounds ``RTOL64_LOSS`` 1e-12, ``RTOL64_GRAD`` 1e-10); in bf16 at most 0.52
of the bound (the albedo head's first layer, 0.07-0.09 of its scale, where
JAX's own bf16 is 0.06-0.08 off its f32), terms and outputs within 1.4e-4
of scale.  JAX's bf16 step is compiled with XLA's excess precision off, as
``test_torch_port_bf16_rounding.py`` compiles it: with it on, XLA's CPU
fusions keep some bf16 chains of the SDF in f32 and the eikonal term at
inv_s 80 and 120 read 7.6044e-4 against the port's 7.5913e-4 (1.14 times
the bound); off, 7.5916e-4.

**The tier-1 twin of ``tools/trained_step_compare.py``'s shell modes**
(``test_trained_shell_*``): ``synth-scene --shell`` at 16x16 (two training
views, one test view), the port's f32 steps 2,998-3,000 from the setup's
parameters on its rays (``TRAINED``) taken as trained weights and written
as a checkpoint with Adam's state and as the parameters-only gzip'd copy
that the legs' ``--keep`` writes.  The tool's f64 comparison at 3,001 (the
kept copy read with the full checkpoint's moments, the same rays in both
packages, the f64 JAX step shared with the schedule's cases): terms within
``RTOL64_TERM_TRAINED`` 1e-12 of max(|term|, 1), gradients within
``RTOL64_GRAD_TRAINED`` 1e-9 and updates within ``RTOL64_UPDATE_TRAINED``
1e-8 of scale (measured 2.8e-17, 2.8e-13, 6.3e-13), the freeze flags and
inner inv_s equal.  The test view rendered through ``test_outputs`` in f32
in both, the TIR mask applied as ``eval-images`` applies it: the same
mask, pixels within ``RENDER_TOL`` (measured 3.6e-7); the tool's region
masks partition the view, and the regions' SSIM deficits add up to the
view's.
"""

import importlib.util
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from nunerf_tpu.models.stage2_shell import Stage2ShellRenderer as JShellRenderer
from nunerf_tpu.tracing.scene import Scene as JScene
from nunerf_tpu.train.loss import compute_losses as j_compute_losses
from nunerf_tpu.train.lr import warm_up_cos_schedule as j_schedule
from nunerf_tpu_torch.convert import flat_leaves, load_jax_params, to_jax_tree
from nunerf_tpu_torch.models.stage1 import PARAM_KEYS as STAGE1_KEYS
from nunerf_tpu_torch.models.stage1 import ShapeRenderer
from nunerf_tpu_torch.models.stage2 import tree_keys
from nunerf_tpu_torch.models.stage2_shell import Stage2ShellRenderer
from nunerf_tpu_torch.tracing.scene import Scene
from nunerf_tpu_torch.train.lr import warm_up_cos_host
from nunerf_tpu_torch.train.trainer import TrainStep
from port_helpers import assert_close_calibrated, jitter_tree
from test_torch_port_shell import _batch, _mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool():
    spec = importlib.util.spec_from_file_location(
        "trained_step_compare", os.path.join(ROOT, "tools", "trained_step_compare.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


tsc = _tool()
S2_PATH = "configs/stage2/nerf/nested_shell.yaml"
S2_B_PATH = "configs/stage2/nerf/nested_shell_b.yaml"
STEPS = [999, 1000, 1499, 1500, 2999, 3000, 7999, 8000, 9999, 10000, 27999, 28000, 29999]
# the inner inv_s of each case: the jittered init's (about 20) at every step,
# and at 3,000 also 80 and 120, each side of freeze_thickness_inv_s
INV_S = (80.0, 120.0)
CASES = [(s, None) for s in STEPS] + [(3000, v) for v in INV_S]
# shell_stage2b's absorption gate: each side of its step and of its inv_s
INV_S_B = (180.0, 220.0)
CASES_B = [(s, v) for s in (2999, 3000) for v in (None,) + INV_S_B]
PARAMS = ([pytest.param(S2_PATH, s, v, id=f"{s}-{v}") for s, v in CASES]
          + [pytest.param(S2_B_PATH, s, v, id=f"b-{s}-{v}") for s, v in CASES_B])
S1_CUT = dict(sdf_n_layers=4, n_samples=8, n_importance=8, up_sample_steps=2,
              n_bg_samples=4, n_front_samples=2, n_back_samples=2)
S2_CUT = dict(sdf_n_layers=4, n_samples_outer=8, n_samples_inner=4, inner_up_rounds=1,
              inner_up_each=4, n_bg_inverse=8)
# keys that name files of a run: the test hands both packages the scene,
# the stage-1 parameters and the stage-1 config instead
FILE_KEYS = ("stage1_mesh_dir", "stage1_ckpt_dir", "stage1_cfg_dir")
RTOL_LOSS, RTOL_GRAD, K_COND = 1e-5, 1e-4, 10.0
RTOL64_LOSS, RTOL64_GRAD = 1e-12, 1e-10
BF16_RTOL_LOSS, BF16_RTOL_GRAD, K_BF16 = 1e-3, 1e-2, 2.0
VAR = "train/var_inner/variance"
# the trained weights of the tool's tier-1 twin: the port's steps from the
# setup's parameters on the tiny scene's rays, then one more compared
TRAINED = [2998, 2999, 3000]
RTOL64_TERM_TRAINED, RTOL64_GRAD_TRAINED, RTOL64_UPDATE_TRAINED = 1e-12, 1e-9, 1e-8
RENDER_TOL = 1e-5  # the largest pixel gap of the f32 render, on [0, 1] (3.6e-7)
BATCH_KEYS = ("rays_o", "rays_d", "rgbs", "masks")
# at least these shares of the trainable parameters are held to JAX's update
# (measured 0.062 in f32, 0.0155 in bf16 at the fewest)
ADAM_HELD_F32, ADAM_HELD_BF16 = 0.05, 0.01
# JAX's bf16 step compiled as the JAX code reads: XLA's CPU fusions otherwise
# keep some bf16 elementwise chains in f32 (``test_torch_port_bf16_rounding.py``)
OPTIONS = {"bf16": {"xla_allow_excess_precision": False}}
PHYSICAL = {"ior_frozen": "train/ior/", "thickness_frozen": "train/thickness/"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _read(rel):
    with open(os.path.join(ROOT, rel)) as f:
        return yaml.safe_load(f)


def _cfg(bf16, path=S2_PATH):
    """The leg's stage-2 config with depth and samples cut, its stage-1
    config inlined; in f32 both configs' bf16 switches off."""
    s2 = _read(path)
    s1 = dict(_read(os.path.normpath(s2["stage1_cfg_dir"])), **S1_CUT)
    cfg = {k: v for k, v in s2.items() if k not in FILE_KEYS}
    cfg.update(S2_CUT, stage1_cfg=s1)
    if not bf16:
        cfg.update(mixed_precision=False, sdf_mixed_precision=False)
        s1.update(mixed_precision=False, sdf_mixed_precision=False)
    return cfg


def _lr_args():
    lr = _read(S2_PATH)["lr_cfg"]
    return dict(lr=lr.get("lr", 5e-4), end_warm=lr["end_warm"], end_iter=lr["end_iter"])


def _variance(inv_s):
    """The ``var_inner`` parameter of an inner inv_s (``exp(10 v)``)."""
    return np.float32(np.log(inv_s) / 10.0)


def test_config_holds_the_gates_the_cases_straddle():
    cfg = _read(S2_PATH)
    assert cfg["lr_type"] == "warm_up_cos" and cfg["lr_cfg"]["end_warm"] == 1000
    assert cfg["lr_cfg"]["end_iter"] == cfg["total_step"] == 30000
    assert cfg["freeze_inv_s_step"] == 1500 and cfg["anneal_end"] == 8000
    assert cfg["freeze_ior_step"] == cfg["freeze_thickness_step"] == 3000
    assert cfg["freeze_thickness_inv_s"] == 100 < max(INV_S) and min(INV_S) < 100
    assert (cfg["inv_s_floor_start"], cfg["inv_s_floor_end"]) == (10000, 28000)
    assert (cfg["inv_s_floor_base"], cfg["inv_s_floor_max"]) == (32.0, 300.0)
    assert cfg["inner_diffuse_only"] and cfg["learn_absorption"]
    assert cfg["sdf_mixed_precision"] and "mixed_precision" not in cfg
    assert not cfg["zero_thickness"]
    for gate in (1000, 1500, 3000, 8000, 10000, 28000):
        assert gate - 1 in STEPS and gate in STEPS


def test_gated_config_is_the_shell_config_with_its_absorption_gate():
    base, gated = _read(S2_PATH), _read(S2_B_PATH)
    assert gated["freeze_absorption_step"] == 3000
    assert gated["freeze_absorption_inv_s"] == 200.0
    assert gated["name"] == base["name"] + "b"
    rest = {k: v for k, v in gated.items()
            if k not in ("name", "freeze_absorption_step", "freeze_absorption_inv_s")}
    assert rest == {k: v for k, v in base.items() if k != "name"}
    # the cases straddle the gate's step and its inv_s, above the thickness
    # gate's inv_s, so that at 3,000 only the absorption's gate differs
    steps = {s for s, _ in CASES_B}
    assert steps == {gated["freeze_absorption_step"] - 1, gated["freeze_absorption_step"]}
    assert min(INV_S_B) < gated["freeze_absorption_inv_s"] < max(INV_S_B)
    assert min(INV_S_B) > gated["freeze_thickness_inv_s"]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(mesh, parameters, JAX's sides, the tiny scene's root): the
    parameters are the port's init jittered off it, in the JAX layout
    (JAX's own init takes 20 s eagerly); JAX's side of each kind is
    ``tools/trained_step_compare.py``'s ``ShellJaxSide``, and ``render``
    JAX's ``test_outputs`` on the tiny scene's test view, each traced here
    and compiled on a thread of its own while the cases run (XLA's compile
    leaves the interpreter free)."""
    mesh = _mesh()
    cfg = _cfg(False)
    s1_tree = to_jax_tree(ShapeRenderer(cfg["stage1_cfg"], device="cpu", seed=7), STAGE1_KEYS)
    s1_params = jitter_tree(s1_tree, 1, 0.05)
    renderer = Stage2ShellRenderer(cfg, Scene(mesh, tile=512, device="cpu"), s1_params,
                                   device="cpu")
    params = {"train": jitter_tree(to_jax_tree(renderer, tree_keys())["train"], 2, 0.05),
              "frozen": s1_params}
    root = _tiny_scene(tmp_path_factory)
    view = _view_batch(root)
    jr = JShellRenderer(cfg, scene=JScene(mesh, tile=512), stage1_params=s1_params)
    render = jax.jit(lambda p, b, step: jr.test_outputs(p, b, jax.random.PRNGKey(0), step))
    sides = {"render": _Compiled(render.lower(params, _four(view), TRAINED[-1] + 1))}
    for kind in ("f32", "f64", "bf16"):
        side = tsc.ShellJaxSide(JShellRenderer(_cfg(kind == "bf16"), scene=JScene(mesh, tile=512),
                                               stage1_params=s1_params), kind == "f64")
        side.load(params, _fresh_adam(params))
        side.compiling = _Compiled(side.lower(_batch(), STEPS[0]), OPTIONS.get(kind))
        sides[kind] = side
    for kind in ("f32", "f64", "bf16"):
        side = tsc.ShellJaxSide(JShellRenderer(_cfg(kind == "bf16", S2_B_PATH),
                                               scene=JScene(mesh, tile=512),
                                               stage1_params=s1_params), kind == "f64")
        side.load(params, _fresh_adam(params))
        side.compiling = _Compiled(side.lower(_batch(), CASES_B[0][0]), OPTIONS.get(kind))
        sides[S2_B_PATH, kind] = side
    yield mesh, params, sides, root
    for side in sides.values():
        getattr(side, "compiling", side).join()


class _Compiled(threading.Thread):
    """A lowered JAX step compiled on a thread of its own; ``get`` waits."""

    def __init__(self, lowered, options=None):
        super().__init__(daemon=True)
        self.lowered, self.options, self.fn, self.error = lowered, options, None, None
        self.start()

    def run(self):
        try:
            self.fn = self.lowered.compile(compiler_options=self.options)
        except BaseException as e:  # raised again in the case that waits
            self.error = e

    def get(self):
        self.join()
        if self.error is not None:
            raise self.error
        return self.fn


def _fresh_adam(params):
    zero = jax.tree_util.tree_map(np.zeros_like, params["train"])
    return {"count": 0, "exp_avg": {"train": zero}, "exp_avg_sq": {"train": zero}}


def _with_inv_s(params, inv_s):
    if inv_s is None:
        return params
    var = dict(params["train"]["var_inner"])
    var["params"] = dict(var["params"], variance=_variance(inv_s))
    return dict(params, train=dict(params["train"], var_inner=var))


def _train_only(grads):
    """The gradients of the trainable subtree; the frozen one's checked zero."""
    for k, v in grads.items():
        if k.startswith("frozen/"):
            assert not v.any(), k
    return {k: v for k, v in grads.items() if not k.startswith("frozen/")}


def _jax_step(setup, kind, step, inv_s, params=None, batch=None, path=S2_PATH):
    """(terms, outputs, trainable gradients) of JAX's step under the config
    at ``path``, float64 numpy, from ``params`` (the setup's, with
    ``inv_s``) and a fresh Adam."""
    side = setup[2][kind if path == S2_PATH else (path, kind)]
    side.compiled = side.compiling.get()
    params = _with_inv_s(setup[1] if params is None else params, inv_s)
    side.load(params, _fresh_adam(params))
    terms, grads, _ = side.step(_batch() if batch is None else batch, step)
    out = {k: np.asarray(v, np.float64) for k, v in side.outputs.items()}
    return terms, out, _train_only({k: np.asarray(v, np.float64) for k, v in grads.items()})


def _port_step(setup, cfg, step, inv_s, dtype):
    """One port step through ``TrainStep`` at the schedule's lr: (terms,
    outputs, trainable gradients, parameters before and after, lr)."""
    mesh, params = setup[:2]
    params = _with_inv_s(params, inv_s)
    fdt = torch.float64 if dtype == torch.float64 else torch.float32
    prev = torch.get_default_dtype()
    torch.set_default_dtype(fdt)
    try:
        scene = Scene(mesh, tile=512, device="cpu")
        for name in ("v0", "e1", "e2", "verts", "vertex_normals", "vertex_curvature"):
            setattr(scene, name, getattr(scene, name).to(fdt))
        renderer = Stage2ShellRenderer(cfg, scene, params["frozen"], device="cpu")
        load_jax_params(renderer, params, tree_keys())
        if dtype == torch.float64:
            renderer.to(dtype)
        train = TrainStep(renderer, warm_up_cos_host(**_lr_args()))
        train.n_updates = step  # the schedule's lr at this step
        forward, outputs = renderer.train_outputs, {}

        def keep(batch, step, generator=None):  # the step's own forward
            outputs.update(forward(batch, step, generator))
            return outputs

        renderer.train_outputs = keep
        batch = {k: torch.as_tensor(v).to(fdt) for k, v in _batch().items()}
        terms = train.compute_grads(batch, step)
        grads = tsc.port_leaves(renderer, tree_keys(), "grad")
        before = tsc.port_leaves(renderer, tree_keys())
        train.apply()
        after = tsc.port_leaves(renderer, tree_keys())
        lr = train.optimizer.param_groups[0]["lr"]
    finally:
        torch.set_default_dtype(prev)
    terms = {k: float(v.detach()) if torch.is_tensor(v) else float(v)
             for k, v in terms.items()}
    out = {k: v.detach().to(torch.float64).numpy() for k, v in outputs.items()}
    grads = _train_only({k: v.astype(np.float64) for k, v in grads.items()})
    for k in before:
        if k.startswith("frozen/"):
            np.testing.assert_array_equal(after[k], before[k], err_msg=k)
    return terms, out, grads, before, after, lr


def _gate_inv_s(cfg, inv_s, step):
    """(the inner inv_s the thickness gate reads: the parameter's, floored;
    the floor, 0 before its start)."""
    floor = 0.0
    if step >= cfg["inv_s_floor_start"]:
        t = min((step - cfg["inv_s_floor_start"])
                / (cfg["inv_s_floor_end"] - cfg["inv_s_floor_start"]), 1.0)
        floor = cfg["inv_s_floor_base"] * (cfg["inv_s_floor_max"]
                                           / cfg["inv_s_floor_base"]) ** t
    return max(inv_s, floor), floor


def _check_gates(cfg, step, inv_s, terms, grads):
    """The schedule's gates in one package's step at the inner inv_s
    ``inv_s`` of its parameters."""
    seen, floor = _gate_inv_s(cfg, inv_s, step)
    var = float(np.abs(grads[VAR]).sum())
    assert (var > 0) == (step >= cfg["freeze_inv_s_step"] and inv_s > floor), \
        (step, inv_s, var)
    frozen = {"ior_frozen": step < cfg["freeze_ior_step"],
              "thickness_frozen": (step < cfg["freeze_thickness_step"]
                                   or seen < cfg["freeze_thickness_inv_s"])}
    for flag, head in PHYSICAL.items():
        assert terms[flag] == float(frozen[flag]), (step, inv_s, flag, terms[flag])
        total = sum(float(np.abs(v).sum()) for k, v in grads.items() if k.startswith(head))
        assert (total == 0) == frozen[flag], (step, inv_s, head, total)
    # the absorption's gate, where the config has one (the reference's none)
    thr = cfg.get("freeze_absorption_inv_s")
    held = step < cfg.get("freeze_absorption_step", 0) or (thr is not None and seen < thr)
    total = sum(float(np.abs(v).sum()) for k, v in grads.items()
                if k.startswith("train/absorption"))
    assert (total == 0) == held, (step, inv_s, "absorption", total)


def _adam_held(step, grads, jgrads, before, after, lr, noise):
    """The port's update is optax.adam's at the schedule's lr on its own
    gradients; where JAX's gradient is clear of ``noise``, JAX's.  Returns
    the share of the trainable parameters so held."""
    assert lr == pytest.approx(float(j_schedule(**_lr_args())(step)), rel=1e-6)
    before = {k: before[k] for k in grads}
    opt = optax.adam(lr)
    upd, _ = opt.update({k: v.astype(np.float32) for k, v in grads.items()},
                        opt.init(before), before)
    jupd, _ = opt.update({k: v.astype(np.float32) for k, v in jgrads.items()},
                         opt.init(before), before)
    held = total = 0
    for k in grads:
        np.testing.assert_allclose(after[k], before[k] + np.asarray(upd[k]),
                                   rtol=1e-6, atol=1e-5 * lr, err_msg=k)
        total += before[k].size
        jafter = before[k] + np.asarray(jupd[k])
        clear = np.abs(jgrads[k]) > noise[k] + 1e-6
        diff = np.abs(after[k] - jafter)
        assert (diff[clear] <= 1e-6 + 1e-6 * np.abs(jafter[clear])).all(), k
        held += int(clear.sum())
    return held / total


def _param_inv_s(setup, inv_s):
    if inv_s is not None:
        return inv_s
    return float(np.exp(10.0 * np.float64(flat_leaves(setup[1])[VAR])))


@pytest.mark.parametrize("path,step,inv_s", PARAMS)
def test_shell_step_matches_jax_f32(setup, path, step, inv_s):
    cfg = _cfg(False, path)
    t32, o32, g32, before, after, lr = _port_step(setup, cfg, step, inv_s, torch.float32)
    t64, o64, g64, _, _, _ = _port_step(setup, cfg, step, inv_s, torch.float64)
    jterms, jout, jgrads = _jax_step(setup, "f32", step, inv_s, path=path)
    j64, jout64, jg64 = _jax_step(setup, "f64", step, inv_s, path=path)
    seen = _param_inv_s(setup, inv_s)
    _check_gates(cfg, step, seen, jterms, jgrads)
    _check_gates(cfg, step, seen, t32, g32)
    _check_gates(cfg, step, seen, j64, jg64)
    _check_gates(cfg, step, seen, t64, g64)

    # in float64 the two packages compute the same step, with no
    # conditioning term
    for k, v in j64.items():
        assert abs(t64[k] - v) <= RTOL64_LOSS * max(abs(v), 1.0), (k, t64[k], v)
    for k, v in jout64.items():
        err = np.abs(o64[k] - v).max()
        assert err <= RTOL64_LOSS * max(np.abs(v).max(), 1.0), (k, err)
    for k, v in jg64.items():
        err = np.abs(g64[k] - v).max()
        assert err <= RTOL64_GRAD * np.abs(v).max() + 1e-300, (k, err, np.abs(v).max())

    assert sorted(t32) == sorted(jterms)
    for k, v in jterms.items():
        assert_close_calibrated(np.float64(t32[k]), np.float64(v), np.float64(t64[k]),
                                RTOL_LOSS, K_COND, what=k, expected64=np.float64(j64[k]))
    assert sorted(o32) == sorted(jout)
    for k, v in jout.items():
        assert_close_calibrated(o32[k], v, o64[k], RTOL_LOSS, K_COND, what=k,
                                expected64=jout64[k])
    assert sorted(g32) == sorted(jgrads)
    noise = {}
    for k, v in jgrads.items():
        assert_close_calibrated(g32[k], v, g64[k], RTOL_GRAD, K_COND, what=k,
                                expected64=jg64[k])
        noise[k] = RTOL_GRAD * np.abs(g64[k]).max() + K_COND * (
            np.abs(g32[k] - g64[k]).max() + np.abs(v - jg64[k]).max())
    assert _adam_held(step, g32, jgrads, before, after, lr, noise) >= ADAM_HELD_F32


def _held_bf16(got, want, want32, rtol, what):
    """``got`` (the port in bf16) against ``want`` (JAX in bf16) within
    ``rtol * scale + K_BF16 * |want - want32|``: the scale is JAX's f32
    value's, the second term JAX's own bf16 rounding.  Returns the bound."""
    got, want, want32 = (np.asarray(x, np.float64) for x in (got, want, want32))
    scale, gap = np.abs(want32).max(), np.abs(want - want32).max()
    err, bound = np.abs(got - want).max(), rtol * scale + K_BF16 * gap
    assert err <= bound, f"{what}: max err {err:.3e} > {bound:.3e} (JAX's own {gap:.3e})"
    return bound


@pytest.mark.parametrize("path,step,inv_s", PARAMS)
def test_shell_step_matches_jax_bf16(setup, path, step, inv_s):
    cfg = _cfg(True, path)
    assert cfg["sdf_mixed_precision"] and cfg.get("mixed_precision", True)
    terms, out, grads, before, after, lr = _port_step(setup, cfg, step, inv_s, torch.bfloat16)
    jterms, jout, jgrads = _jax_step(setup, "bf16", step, inv_s, path=path)
    j32, jout32, jg32 = _jax_step(setup, "f32", step, inv_s, path=path)
    seen = _param_inv_s(setup, inv_s)
    _check_gates(cfg, step, seen, jterms, jgrads)
    _check_gates(cfg, step, seen, terms, grads)

    assert sorted(terms) == sorted(jterms)
    for k, v in jterms.items():
        _held_bf16(terms[k], v, j32[k], BF16_RTOL_LOSS, k)
    assert sorted(out) == sorted(jout)
    for k, v in jout.items():
        _held_bf16(out[k], v, jout32[k], BF16_RTOL_LOSS, k)
    assert sorted(grads) == sorted(jgrads)
    noise = {k: _held_bf16(grads[k], v, jg32[k], BF16_RTOL_GRAD, k)
             for k, v in jgrads.items()}
    assert _adam_held(step, grads, jgrads, before, after, lr, noise) >= ADAM_HELD_BF16


# ---------------------------------------------------------------------------
# the tier-1 twin of ``tools/trained_step_compare.py``'s shell modes
# ---------------------------------------------------------------------------

def _tiny_scene(tmp_path_factory):
    """``synth-scene --shell`` at 16x16, two training views and one test
    view: the hollow glass ball of radius 0.5 that the marched mesh
    approximates."""
    from nunerf_tpu_torch.tools.synth_nested import make_nested_scene

    root = str(tmp_path_factory.mktemp("shell_scene") / "nested_shell")
    make_nested_scene(root, n_train=2, n_test=1, h=16, w=16, shell=True)
    return root


def _rays(root):
    """Every ray of the tiny scene's views (training views first), as
    ``construct_nerf_ray_batch`` gives them, with its view's size."""
    from nunerf_tpu_torch.data.database import NeRFSyntheticDatabase
    from nunerf_tpu_torch.data.ray_store import build_imgs_info, construct_nerf_ray_batch

    db = NeRFSyntheticDatabase("nerf/nested_shell", os.path.dirname(root), testskip=1)
    train, test = db.train_test_split()
    batch, h, w = construct_nerf_ray_batch(build_imgs_info(db, list(train) + list(test),
                                                           with_mask=True))
    return batch, h, w


def _four(batch):
    return {k: np.asarray(batch[k], np.float32) for k in BATCH_KEYS}


def _view_batch(root):
    """The test view's rays (the last h x w of the scene's)."""
    batch, h, w = _rays(root)
    return {k: v[-h * w:] for k, v in _four(batch).items()}


def _train_batch(root, step):
    """A step's rays: ``RN`` indices into the training views drawn from
    ``RandomState(step)``, the one draw of a stage-2 step."""
    batch, h, w = _rays(root)
    n_train = batch["rays_o"].shape[0] - h * w
    idx = tsc.shell_indices(len(_batch()["rays_o"]), n_train, step)
    return {k: v[idx] for k, v in _four(batch).items()}


@pytest.fixture(scope="module")
def trained(setup, tmp_path_factory):
    """The port's f32 steps ``TRAINED`` from the setup's parameters on the
    tiny scene, written as a checkpoint with Adam's state and as a
    parameters-only gzip'd copy (the leg's ``--keep``); returns (scene
    root, full checkpoint, kept copy)."""
    from nunerf_tpu_torch.convert import named_to_jax_tree
    from nunerf_tpu_torch.train.trainer import save_checkpoint

    mesh, params, _, root = setup
    renderer = Stage2ShellRenderer(_cfg(False), Scene(mesh, tile=512, device="cpu"),
                                   params["frozen"], device="cpu")
    load_jax_params(renderer, params, tree_keys())
    train = TrainStep(renderer, warm_up_cos_host(**_lr_args()))
    train.n_updates = TRAINED[0]
    for step in TRAINED:
        train.compute_grads({k: torch.as_tensor(v) for k, v in
                             _train_batch(root, step).items()}, step)
        train.apply()
    names = {p: n for n, p in renderer.named_parameters()}
    state = train.optimizer.state
    opt = {"count": train.n_updates}
    for key in ("exp_avg", "exp_avg_sq"):
        opt[key] = named_to_jax_tree({names[p]: state[p][key].numpy() for p in train.params},
                                     tree_keys())
    out = tmp_path_factory.mktemp("trained")
    full, kept = str(out / "model.ckpt"), str(out / f"model_{TRAINED[-1] + 1}.ckpt.gz")
    tree = to_jax_tree(renderer, tree_keys())
    save_checkpoint(full, TRAINED[-1] + 1, tree, opt, 0.0)
    save_checkpoint(kept, TRAINED[-1] + 1, tree, None, 0.0)
    return root, full, kept


def _schedule64(count):
    with jax.enable_x64(True):
        return float(j_schedule(**_lr_args())(count))


def test_trained_shell_step_matches_jax_in_float64(setup, trained):
    """The tool's f64 comparison on the trained weights: the kept copy
    read with the full checkpoint's moments, one more step in both
    packages with the same rays; every term, gradient and Adam update, and
    the freeze flags and inner inv_s the tool reports."""
    root, full, kept = trained
    step, params, opt = tsc.read_checkpoint(kept, full)
    assert step == opt["count"] == TRAINED[-1] + 1
    assert tsc.read_checkpoint(full)[2]["count"] == step
    batch = _train_batch(root, step)
    side = setup[2]["f64"]
    side.compiled = side.compiling.get()
    side.load(params, opt)
    jres = side.step(batch, step)

    mesh = setup[0]
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        scene = Scene(mesh, tile=512, device="cpu")
        renderer = Stage2ShellRenderer(_cfg(False), scene, params["frozen"], device="cpu")
        port = tsc.PortSide(renderer, TrainStep(renderer, _schedule64), True, tree_keys())
        for name in tsc.SCENE_ARRAYS:
            setattr(scene, name, getattr(scene, name).to(torch.float64))
        port.load(params, opt)
        pres = port.step(batch, [], step)
    finally:
        torch.set_default_dtype(prev)
    rec = tsc.compare_step(pres, (*jres, [], None))
    assert rec["terms_ok"] and rec["grads_ok"]
    for k, r in rec["terms"].items():
        assert r["err"] <= RTOL64_TERM_TRAINED * max(abs(r["jax"]), 1.0), (k, r)
    for k, r in rec["grads"].items():
        assert r["err"] <= RTOL64_GRAD_TRAINED * r["scale"] + 1e-300, (k, r)
    assert rec["worst_update"][0][0] <= RTOL64_UPDATE_TRAINED, rec["worst_update"]
    heads = tsc.by_head(rec)
    assert {"train/sdf_inner", "train/ior", "train/thickness"} <= set(heads)
    flat = side.flat_params()
    flags = [tsc.shell_flags(t, flat, side.cfg, step) for t in (pres[0], jres[0])]
    for k in ("ior_frozen", "thickness_frozen", "absorption_gated", "inv_s", "inv_s_gate"):
        assert flags[0][k] == flags[1][k], k
    # at 3,001 the IoR field is released, the thickness held by its inv_s gate
    assert flags[0]["ior_frozen"] == 0.0 and flags[0]["thickness_frozen"] == 1.0
    assert flags[0]["inv_s_gate"] < side.cfg["freeze_thickness_inv_s"]


def test_trained_shell_render_matches_jax_and_its_regions_partition_the_view(setup, trained):
    """The tool's render comparison on the trained weights: the test view
    through ``test_outputs`` in f32 in both packages, the TIR mask applied
    as ``eval-images`` applies it; then the region split of the view."""
    root, full, _ = trained
    step, params, _ = tsc.read_checkpoint(full)
    view = _view_batch(root)
    jout = setup[2]["render"].get()(params, view, step)
    renderer = Stage2ShellRenderer(_cfg(False), Scene(setup[0], tile=512, device="cpu"),
                                   params["frozen"], device="cpu")
    load_jax_params(renderer, params, tree_keys())
    with torch.no_grad():
        pout = renderer.test_outputs({k: torch.as_tensor(v) for k, v in view.items()}, step)
    pout = {k: v.numpy() for k, v in pout.items()}
    jout = {k: np.asarray(v) for k, v in jout.items()}
    np.testing.assert_array_equal(pout["tir_mask"], jout["tir_mask"])
    tm = pout["tir_mask"].reshape(-1, 1)
    gap = np.abs(pout["ray_rgb"] * tm - jout["ray_rgb"] * tm).max()
    assert gap <= RENDER_TOL, gap

    labels = tsc.shell_regions(renderer.scene, view["rays_o"], view["rays_d"], tm, 1.5)
    assert labels.shape == (256,) and set(np.unique(labels)) <= set(range(len(tsc.REGIONS)))
    # the view holds every region (159 / 6 / 61 / 25 / 5 pixels)
    assert sorted(np.unique(labels)) == list(range(len(tsc.REGIONS)))
    gt = view["rgbs"] * tm
    for out in (pout, jout):
        rec = tsc.region_scores(gt, out["ray_rgb"] * tm, labels, 16, 16)
        regions = rec["regions"]
        assert sum(r["pixels"] for r in regions.values()) == 256
        assert sum(r["ssim_deficit"] for r in regions.values()) == pytest.approx(
            1.0 - rec["ssim"], abs=1e-12)
