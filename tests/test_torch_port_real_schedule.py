"""The port's steps against JAX's under the real-capture legs' own configs,
at their schedule gates (CPU): the stage-1 step of ``real_boot``
(``configs/shape/real/nested_real_boot.yaml``) and of ``real_front``
(``nested_real.yaml``, which differs by the mask term, the database's
``rawmask`` suffix, the split and the schedule's length), and the shell
stage-2 step of ``real_stage2`` (``configs/stage2/real/nested_real.yaml``,
its frozen nets the boot config's).

The configs are read as they are; only depth, samples and rays are cut
(``S1_CUT``, ``S2_CUT``).  Their keys stay: NeRO camera rays (``is_nerf``
false), ``sphere_direction`` with ``light_exp_max`` 5.0, the ``normal_ori``
term, ``use_mask_loss`` at 0.5 on the SDF branch's opacity (boot), the
init-SDF regulariser to 1,000, ``anneal_end`` 7,000, ``occ_loss_step``
8,000, ``freeze_inv_s_step`` and ``outer_reg_step`` 10,000 and the warm-up
cosine to 20,000 or 32,000; in stage 2 ``get_mask`` (the batch's masks),
``inner_diffuse_only``, ``learn_absorption``, ``sdf_bias`` 0.45,
``freeze_inv_s_step`` 2,000, ``freeze_ior_step`` and
``freeze_thickness_step`` 4,000 with ``freeze_ior_inv_s`` and
``freeze_thickness_inv_s`` 100, ``anneal_end`` 10,000, the inv_s floor
from 32 at 10,000 to 300 at 28,000, and the warm-up cosine (1,000 /
30,000).  One whole step (``train_outputs``, ``compute_losses``, one Adam
update at the schedule's lr through ``TrainStep``) is held on both sides of
each gate of the boot config and at three of the front's (``S1_CASES_OF``,
``S2_CASES``); in stage 1 at 999 and 1,000
also with the SDF raised by ``REG_SHIFT`` (and ``CENTRAL`` rays through the
centre), where the init-SDF regulariser has points to push; in stage 2 at
3,999 and 4,000 also with the inner inv_s at 90 and 110, each side of both
inv_s gates.

Draws: ``perturb`` is 0 in stage 1 and the occlusion subset's priorities
are injected into both packages (``test_torch_port_leg_schedule.py``'s
way; the subset's size is cut to ``OCC_MAX_PN``, under every step's
candidate count, which the test checks); stage 2 draws nothing but its
rays, the batch handed to both.  JAX's steps run in spawned processes
(``tests/real_schedule_jax.py``), one a config and kind, while this process
steps the port; JAX's float64 steps trace with its float32 pins lifted.

Checks, with the tolerances of ``test_torch_port_shell_schedule.py``: in
float64 the two packages' terms within ``RTOL64_LOSS`` of max(|term|, 1)
and gradients within ``RTOL64_GRAD`` of scale, with no conditioning term;
in f32 (both configs' bf16 switches off) every term within ``RTOL_LOSS`` and
every gradient within ``RTOL_GRAD`` of its scale, each plus ten times both
packages' own f32 error against their float64 step; in bf16 (the configs'
precision; JAX's step compiled with XLA's excess precision off) within
``BF16_RTOL_* * scale + K_BF16 * |jax_bf16 - jax_f32|``, JAX's own bf16
rounding and none of the port's.  In stage 1 the occlusion head's gradient
is left out in bf16 before ``occ_loss_step`` only, where JAX's own bf16
gradient of it is noise (as in the leg schedule test; from it the head is
held at the bound, which holds JAX's own bf16 gap), and the two
packages' bf16 may decide ``MAX_OCC_FLIPS`` candidates differently.  The
gates, in both packages: the init-SDF terms live before 1,000 (raised SDF)
and zero from it,
the inv_s gradient zero before ``freeze_inv_s_step``, ``outer_reg`` and the
occlusion term from their steps, the mask term in the boot config alone,
the normal-orientation term in both; in stage 2 the inner inv_s gradient,
``ior_frozen`` / ``thickness_frozen`` and their heads' gradients zero
exactly where frozen, the absorption live.  The Adam update: the port's is
optax.adam's at the schedule's lr on its own gradients, and JAX's where
JAX's gradient is clear of the bound.

Measured: in float64 the stage-1 terms within 4.8e-14 of max(|term|, 1)
and gradients within 4.3e-11 of scale, the stage-2 ones within 3.3e-16
and 7.4e-12; in bf16 at most 0.55 of the bound in stage 1 and 0.88 in
stage 2 (the inner shader's albedo head at 10,000).  80 s alone on 8 CPU
cores.
"""

import contextlib
import multiprocessing as mp
import os

import numpy as np
import optax
import pytest
import torch
import yaml

import real_schedule_jax
from nunerf_tpu_torch.convert import flat_leaves, load_jax_params, to_jax_tree
from nunerf_tpu_torch.models.stage1 import PARAM_KEYS, ShapeRenderer
from nunerf_tpu_torch.models.stage2 import tree_keys
from nunerf_tpu_torch.models.stage2_shell import Stage2ShellRenderer
from nunerf_tpu_torch.tracing.scene import Scene
from nunerf_tpu_torch.train.lr import warm_up_cos_host
from nunerf_tpu_torch.train.trainer import TrainStep
from port_helpers import assert_close_calibrated, jitter_tree
from test_torch_port_shell import _batch as _shell_batch
from test_torch_port_shell import _mesh

tsc = real_schedule_jax.stage2_schedule_jax._tool()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S1 = {"boot": "configs/shape/real/nested_real_boot.yaml",
      "real": "configs/shape/real/nested_real.yaml"}
S2_PATH = "configs/stage2/real/nested_real.yaml"
S1_GATES = (1000, 1500, 7000, 8000, 10000)
S1_END = {"boot": 31999, "real": 19999}  # the cosine's last step
# a case: (step, params): the jittered init, or ``"reg"``, the same with
# the SDF raised by ``REG_SHIFT``, so that the init-SDF regulariser has
# points to push (none of the init's samples violates its bounds)
S1_CASES_OF = {"boot": [(s, None) for s in sorted({g - 1 for g in S1_GATES} | set(S1_GATES)
                                                  | {S1_END["boot"]})]
               + [(999, "reg"), (1000, "reg")],
               # the front's config differs by the mask term and the cosine's
               # length: the regulariser's end, the occlusion's start, its end
               "real": [(999, "reg"), (8000, None), (S1_END["real"], None)]}
REG_SHIFT = 0.3
S2_GATES = (1000, 2000, 4000, 10000, 28000)
S2_STEPS = sorted({g - 1 for g in S2_GATES} | set(S2_GATES) | {19000, 29999})
INV_S = (90.0, 110.0)  # each side of freeze_ior_inv_s and freeze_thickness_inv_s
S2_CASES = [(s, None) for s in S2_STEPS] + [(s, v) for s in (3999, 4000) for v in INV_S]
RN, S2_RN = 32, 16
S1_CUT = dict(sdf_n_layers=4, n_samples=8, n_importance=8, up_sample_steps=2,
              n_bg_samples=4, n_front_samples=2, n_back_samples=2)
S1_STEP_CUT = dict(S1_CUT, perturb=0.0, train_ray_num=RN)
S2_CUT = dict(sdf_n_layers=4, n_samples_outer=8, n_samples_inner=4, inner_up_rounds=1,
              inner_up_each=4, n_bg_inverse=8)
OCC_MAX_PN = 8
CENTRAL = 8  # rays of the stage-1 batch aimed within 0.03 x 0.3 of the centre
FILE_KEYS = ("stage1_mesh_dir", "stage1_ckpt_dir", "stage1_cfg_dir")
RTOL_LOSS, RTOL_GRAD, K_COND = 1e-5, 1e-4, 10.0
RTOL64_LOSS, RTOL64_GRAD = 1e-12, 1e-10
BF16_RTOL_LOSS, BF16_RTOL_GRAD, K_BF16 = 1e-3, 1e-2, 2.0
OCC_HEAD = "shade/inner_weight/"  # the shader head of the occlusion probability
OWN_GAP = 0.5      # JAX's bf16 gradient of a leaf is noise where it is this far off its f32
MAX_OCC_FLIPS = 1  # occlusion candidates the two packages' bf16 may decide differently
VAR = "train/var_inner/variance"
PHYSICAL = {"ior_frozen": "train/ior/", "thickness_frozen": "train/thickness/"}
# at least these shares of the parameters are held to JAX's update
ADAM_HELD_F32, ADAM_HELD_BF16 = 0.05, 0.01
OPTIONS = {"bf16": {"xla_allow_excess_precision": False}}
KINDS = ("f32", "f64", "bf16")
JAX_LIMIT = 600.0  # seconds the spawned JAX sides may take
WORKERS = 5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _read(rel):
    with open(os.path.join(ROOT, rel)) as f:
        return yaml.safe_load(f)


def _s1_cfg(name, kind):
    cfg = dict(_read(S1[name]), **S1_STEP_CUT, occ_loss_max_pn=OCC_MAX_PN)
    if kind != "bf16":
        cfg.update(mixed_precision=False, sdf_mixed_precision=False)
    return cfg


def _s2_cfg(kind):
    """The stage-2 config with depth and samples cut, its stage-1 config
    (the boot's) inlined; outside bf16 both configs' bf16 switches off."""
    s2 = _read(S2_PATH)
    s1 = dict(_read(os.path.normpath(s2["stage1_cfg_dir"])), **S1_CUT)
    cfg = {k: v for k, v in s2.items() if k not in FILE_KEYS}
    cfg.update(S2_CUT, stage1_cfg=s1)
    if kind != "bf16":
        cfg.update(mixed_precision=False, sdf_mixed_precision=False)
        s1.update(mixed_precision=False, sdf_mixed_precision=False)
    return cfg


PRIORITY_SEED = 5


def _priorities(n):
    return np.random.RandomState(PRIORITY_SEED).rand(n).astype(np.float32)


def _s1_batch():
    """``RN`` NeRO rays of a camera at (0, 0, -2.5) looking at the origin:
    origins, directions, near / far, colours, the boot's silhouette masks
    and the camera's pose (``human_poses``)."""
    rs = np.random.RandomState(0)
    origins = np.tile(np.array([[0.0, 0.0, -2.5]], np.float32), (RN, 1))
    targets = rs.randn(RN, 3).astype(np.float32) * 0.3
    targets[:CENTRAL] *= 0.03  # through the centre, where the init-SDF term looks
    dirs = targets - origins
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    pose = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 2.5]], np.float32)
    return {"rays_o": origins, "rays_d": dirs.astype(np.float32),
            "near": np.full((RN, 1), 0.8, np.float32),
            "far": np.full((RN, 1), 4.5, np.float32),
            "rgbs": rs.rand(RN, 3).astype(np.float32),
            "masks": (rs.rand(RN) < 0.7).astype(np.float32),
            "human_poses": np.tile(pose[None], (RN, 1, 1))}


def _s2_batch():
    """The shell test's rays on the marched sphere, with their masks."""
    batch = _shell_batch()
    assert len(batch["rays_o"]) == S2_RN and "masks" in batch
    return batch


def _variance(inv_s):
    return np.float32(np.log(inv_s) / 10.0)


def _with_inv_s(params, inv_s):
    if inv_s is None:
        return params
    var = dict(params["train"]["var_inner"])
    var["params"] = dict(var["params"], variance=_variance(inv_s))
    return dict(params, train=dict(params["train"], var_inner=var))


def _gate_inv_s(cfg, inv_s, step):
    """(the inner inv_s the gates read: the parameter's, floored; the
    floor, 0 before its start)."""
    floor = 0.0
    if step >= cfg["inv_s_floor_start"]:
        t = min((step - cfg["inv_s_floor_start"])
                / (cfg["inv_s_floor_end"] - cfg["inv_s_floor_start"]), 1.0)
        floor = cfg["inv_s_floor_base"] * (cfg["inv_s_floor_max"]
                                           / cfg["inv_s_floor_base"]) ** t
    return max(inv_s, floor), floor


@contextlib.contextmanager
def _default_dtype(dtype):
    prev = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        yield
    finally:
        torch.set_default_dtype(prev)


def test_configs_hold_the_gates_the_cases_straddle():
    boot, real, s2 = _read(S1["boot"]), _read(S1["real"]), _read(S2_PATH)
    assert {k for k in set(boot) | set(real) if boot.get(k) != real.get(k)} == {
        "name", "database_name", "use_mask_loss", "mask_loss_weight", "split_type", "loss",
        "lr_cfg", "total_step"}
    assert boot["database_name"] == real["database_name"] + "/rawmask"
    assert boot["use_mask_loss"] and boot["mask_loss_weight"] == 0.5
    assert [x for x in boot["loss"] if x not in real["loss"]] == ["mask"]
    for cfg, name in ((boot, "boot"), (real, "real")):
        assert not cfg["is_nerf"] and not cfg["zero_thickness"] and "normal_ori" in cfg["loss"]
        assert cfg["shader_config"] == {"sphere_direction": True, "human_light": False,
                                        "light_exp_max": 5.0}
        assert (cfg["anneal_end"], cfg["occ_loss_step"]) == (7000, 8000)
        assert cfg["freeze_inv_s_step"] == cfg["outer_reg_step"] == 10000
        assert cfg["lr_cfg"]["end_warm"] == 1500
        assert cfg["lr_cfg"]["end_iter"] == cfg["total_step"] == S1_END[name] + 1
        assert cfg["mixed_precision"] and cfg["sdf_mixed_precision"]
    assert not s2["is_nerf"] and not s2["zero_thickness"] and s2["get_mask"]
    assert s2["stage1_cfg_dir"] == "./" + S1["boot"]
    assert (s2["freeze_inv_s_step"], s2["freeze_ior_step"]) == (2000, 4000)
    assert s2["freeze_thickness_step"] == 4000
    assert s2["freeze_ior_inv_s"] == s2["freeze_thickness_inv_s"] == 100
    assert min(INV_S) < 100 < max(INV_S)
    assert (s2["inv_s_floor_start"], s2["inv_s_floor_end"]) == (10000, 28000)
    assert (s2["inv_s_floor_base"], s2["inv_s_floor_max"]) == (32.0, 300.0)
    assert s2["anneal_end"] == 10000 and s2["sdf_bias"] == 0.45
    assert s2["inner_diffuse_only"] and s2["learn_absorption"]
    assert s2["lr_cfg"] == {"end_warm": 1000, "end_iter": 30000} and s2["total_step"] == 30000
    for gate in S2_GATES:
        assert gate - 1 in S2_STEPS and gate in S2_STEPS
    assert _gate_inv_s(s2, 0.0, 19000)[1] < 100 < _gate_inv_s(s2, 0.0, 28000)[1]


# ---------------------------------------------------------------------------
# the port's sides
# ---------------------------------------------------------------------------

def _s1_port_step(cfg, kind):
    """A function of (parameters, step): one port stage-1 step of ``kind``:
    (terms, gradients, parameters before and after, lr, (candidate mask,
    subset size) of each occlusion draw)."""
    fdt = torch.float64 if kind == "f64" else torch.float32
    draws = []
    with _default_dtype(fdt):
        renderer = ShapeRenderer(cfg, device="cpu")
        if kind == "f64":
            renderer.to(fdt)
    select = renderer._occ_select

    def occ_select(mask, generator):
        idx = select(mask, generator)
        draws.append((mask.numpy().copy(), int(idx.numel())))
        return idx

    renderer._occ_select = occ_select
    real_rand = torch.rand

    def rand(*shape, **kw):
        size = tuple(shape[0]) if len(shape) == 1 and not isinstance(shape[0], int) else shape
        if len(size) == 1:
            return torch.as_tensor(_priorities(size[0]), device=kw.get("device"))
        return real_rand(*shape, **kw)

    def step_fn(params, step):
        draws.clear()
        with _default_dtype(fdt):
            load_jax_params(renderer, params, PARAM_KEYS)
            renderer.zero_grad(set_to_none=True)
            lr = cfg["lr_cfg"]
            train = TrainStep(renderer, warm_up_cos_host(
                lr=lr.get("lr", 5e-4), end_warm=lr["end_warm"], end_iter=lr["end_iter"]))
            train.n_updates = step  # the schedule's lr at this step
            batch = {k: torch.as_tensor(v).to(fdt) for k, v in _s1_batch().items()}
            torch.rand = rand
            try:
                terms = train.compute_grads(batch, step)
            finally:
                torch.rand = real_rand
            grads = {k: v.astype(np.float64)
                     for k, v in tsc.port_leaves(renderer, PARAM_KEYS, "grad").items()}
            before = tsc.port_leaves(renderer, PARAM_KEYS)
            train.apply()
            after = tsc.port_leaves(renderer, PARAM_KEYS)
            used = train.optimizer.param_groups[0]["lr"]
        terms = {k: float(v.detach()) for k, v in terms.items()}
        return terms, grads, before, after, used, list(draws)

    return step_fn


class _ShellPort:
    """The port's shell renderer of one kind, built once; ``step`` loads a
    case's parameters and takes one step through a fresh ``TrainStep``."""

    def __init__(self, mesh, params, kind):
        self.fdt = torch.float64 if kind == "f64" else torch.float32
        with _default_dtype(self.fdt):
            scene = Scene(mesh, tile=512, device="cpu")
            for name in tsc.SCENE_ARRAYS:
                setattr(scene, name, getattr(scene, name).to(self.fdt))
            self.renderer = Stage2ShellRenderer(_s2_cfg(kind), scene, params["frozen"],
                                                device="cpu")
            if kind == "f64":
                self.renderer.to(self.fdt)
        forward, self.outputs = self.renderer.train_outputs, {}

        def keep(batch, step, generator=None):
            self.outputs.update(forward(batch, step, generator))
            return self.outputs

        self.renderer.train_outputs = keep

    def step(self, params, batch, step):
        lr = _read(S2_PATH)["lr_cfg"]
        with _default_dtype(self.fdt):
            load_jax_params(self.renderer, params, tree_keys())
            self.renderer.zero_grad(set_to_none=True)
            self.outputs.clear()
            train = TrainStep(self.renderer, warm_up_cos_host(
                lr=lr.get("lr", 5e-4), end_warm=lr["end_warm"], end_iter=lr["end_iter"]))
            train.n_updates = step
            terms = train.compute_grads({k: torch.as_tensor(v).to(self.fdt)
                                         for k, v in batch.items()}, step)
            grads = tsc.port_leaves(self.renderer, tree_keys(), "grad")
            before = tsc.port_leaves(self.renderer, tree_keys())
            train.apply()
            after = tsc.port_leaves(self.renderer, tree_keys())
            used = train.optimizer.param_groups[0]["lr"]
        terms = {k: float(v.detach()) if torch.is_tensor(v) else float(v)
                 for k, v in terms.items()}
        out = {k: v.detach().to(torch.float64).numpy() for k, v in self.outputs.items()}
        grads = _train_only({k: v.astype(np.float64) for k, v in grads.items()})
        for k in before:
            if k.startswith("frozen/"):
                np.testing.assert_array_equal(after[k], before[k], err_msg=k)
        return terms, out, grads, before, after, used


def _train_only(grads):
    for k, v in grads.items():
        if k.startswith("frozen/"):
            assert not v.any(), k
    return {k: v for k, v in grads.items() if not k.startswith("frozen/")}


@pytest.fixture(scope="module")
def steps():
    """Every case's step in each package, config and kind: {(package,
    config, kind, case): result}.  The stage-1 parameters are the port's
    init jittered off it (one tree for both stage-1 configs, whose
    renderers are equal), in the JAX layout; the stage-2 parameters the
    shell renderer's, its frozen nets those stage-1 parameters cut to the
    stage-2 config's depth.  JAX's sides run in spawned processes while
    this one steps the port."""
    pool = mp.get_context("spawn").Pool(WORKERS, real_schedule_jax.warm)
    try:
        s1_params = jitter_tree(to_jax_tree(ShapeRenderer(_s1_cfg("boot", "f32"), device="cpu",
                                                          seed=3), PARAM_KEYS), 1, 0.05)
        mesh = _mesh()
        cfg2 = _s2_cfg("f32")
        s2_frozen = jitter_tree(to_jax_tree(ShapeRenderer(cfg2["stage1_cfg"], device="cpu",
                                                          seed=7), PARAM_KEYS), 1, 0.05)
        renderer = Stage2ShellRenderer(cfg2, Scene(mesh, tile=512, device="cpu"), s2_frozen,
                                       device="cpu")
        s2_params = {"train": jitter_tree(to_jax_tree(renderer, tree_keys())["train"], 2,
                                          0.05), "frozen": s2_frozen}
        s1_sets = {None: s1_params, "reg": _raised(s1_params)}
        batch1, batch2 = _s1_batch(), _s2_batch()
        jobs = {}
        for kind in KINDS:
            jobs["s2", kind] = pool.apply_async(real_schedule_jax.shell, (
                kind, _s2_cfg(kind), mesh, s2_frozen,
                [(_with_inv_s(s2_params, v), batch2, s) for s, v in S2_CASES],
                OPTIONS.get(kind)))
            for name in S1:
                jobs[name, kind] = pool.apply_async(real_schedule_jax.stage1, (
                    kind, _s1_cfg(name, kind), batch1,
                    [(s1_sets[v], s) for s, v in S1_CASES_OF[name]],
                    PRIORITY_SEED, OCC_MAX_PN, OPTIONS.get(kind)))
        out = {"s1_params": s1_params, "s2_params": s2_params}
        for kind in KINDS:
            for name in S1:
                port = _s1_port_step(_s1_cfg(name, kind), kind)
                for case in S1_CASES_OF[name]:
                    out["port", name, kind, case] = port(s1_sets[case[1]], case[0])
            shell = _ShellPort(mesh, s2_params, kind)
            for case in S2_CASES:
                out["port", "s2", kind, case] = shell.step(_with_inv_s(s2_params, case[1]),
                                                           batch2, case[0])
        for (name, kind), job in jobs.items():
            res = job.get(timeout=JAX_LIMIT)
            cases = S2_CASES if name == "s2" else S1_CASES_OF[name]
            for case, r in zip(cases, res):
                out["jax", name, kind, case] = r
    finally:
        pool.terminate()
        pool.join()
    return out


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------

def _same_in_f64(terms, grads, jterms, jgrads, outputs=None, jout=None):
    for k, v in jterms.items():
        assert abs(terms[k] - v) <= RTOL64_LOSS * max(abs(v), 1.0), (k, terms[k], v)
    for k, v in (jout or {}).items():
        err = np.abs(outputs[k] - v).max()
        assert err <= RTOL64_LOSS * max(np.abs(v).max(), 1.0), (k, err)
    for k, v in jgrads.items():
        err = np.abs(grads[k] - v).max()
        assert err <= RTOL64_GRAD * np.abs(v).max() + 1e-300, (k, err, np.abs(v).max())


def _held_bf16(got, want, want32, rtol, what):
    """``got`` (the port in bf16) against ``want`` (JAX in bf16) within
    ``rtol * scale + K_BF16 * |want - want32|``; returns the bound."""
    got, want, want32 = (np.asarray(x, np.float64) for x in (got, want, want32))
    scale, gap = np.abs(want32).max(), np.abs(want - want32).max()
    err, bound = np.abs(got - want).max(), rtol * scale + K_BF16 * gap
    assert err <= bound, f"{what}: max err {err:.3e} > {bound:.3e} (JAX's own {gap:.3e})"
    return bound


def _adam_held(lr_cfg, step, grads, jgrads, before, after, lr, noise):
    """The port's update is optax.adam's at the schedule's lr on its own
    gradients; where JAX's gradient is clear of ``noise``, JAX's.  Returns
    the share of the parameters so held."""
    from nunerf_tpu.train.lr import warm_up_cos_schedule

    want = float(warm_up_cos_schedule(lr=lr_cfg.get("lr", 5e-4), end_warm=lr_cfg["end_warm"],
                                      end_iter=lr_cfg["end_iter"])(step))
    assert lr == pytest.approx(want, rel=1e-6)
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
        if k not in noise:
            continue
        jafter = before[k] + np.asarray(jupd[k])
        clear = np.abs(jgrads[k]) > noise[k] + 1e-6
        diff = np.abs(after[k] - jafter)
        assert (diff[clear] <= 1e-6 + 1e-6 * np.abs(jafter[clear])).all(), k
        held += int(clear.sum())
    return held / total


def _raised(params):
    """``params`` with the SDF's output raised by ``REG_SHIFT``."""
    import copy

    out = copy.deepcopy(params)
    last = max((k for k in out["sdf"]["params"] if k.startswith("lin")), key=lambda k: int(k[3:]))
    out["sdf"]["params"][last]["b"][0] += np.float32(REG_SHIFT)
    return out


def _s1_gates(name, cfg, case, terms, grads, masks):
    step, which = case
    inv_s = sum(float(np.abs(v).sum()) for k, v in grads.items() if k.startswith("var"))
    assert (inv_s > 0) == (step >= cfg["freeze_inv_s_step"]), (step, inv_s)
    assert (terms["loss_outer_reg"] > 0) == (step >= cfg["outer_reg_step"]), step
    init_reg = terms["loss_sdf_small"] + terms["loss_sdf_large"]
    if which == "reg" or step >= 1000:
        assert (init_reg > 0) == (step < 1000), (case, init_reg)
    if step >= cfg["occ_loss_step"]:
        assert len(masks) == 1 and masks[0].sum() > OCC_MAX_PN, [m.sum() for m in masks]
        assert terms["loss_occ"] > 0
    else:
        assert masks == [] and terms["loss_occ"] == 0
    assert ("loss_mask" in terms) == (name == "boot")
    if name == "boot":
        assert terms["loss_mask"] > 0
    assert terms["loss_normal"] >= 0 and "loss_normal" in terms


def _port_masks(draws):
    assert all(n == OCC_MAX_PN for _, n in draws), draws
    return [m for m, _ in draws]


def _same_masks(a, b):
    return len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))


S1_CASES = [(name, step, which) for name in sorted(S1) for step, which in S1_CASES_OF[name]]


@pytest.mark.parametrize("name,step,which", S1_CASES)
def test_stage1_step_matches_jax_f32(steps, name, step, which):
    cfg, case = _s1_cfg(name, "f32"), (step, which)
    t32, g32, before, after, lr, draws = steps["port", name, "f32", case]
    t64, g64, _, _, _, draws64 = steps["port", name, "f64", case]
    jterms, jgrads, jmasks = steps["jax", name, "f32", case]
    j64, jg64, jmasks64 = steps["jax", name, "f64", case]
    masks = _port_masks(draws)
    for other in (_port_masks(draws64), jmasks, jmasks64):
        assert _same_masks(masks, other)
    for terms, grads, m in ((jterms, jgrads, jmasks), (t32, g32, masks), (j64, jg64, jmasks64),
                            (t64, g64, masks)):
        _s1_gates(name, cfg, case, terms, grads, m)
    _same_in_f64(t64, g64, j64, jg64)
    assert sorted(t32) == sorted(jterms)
    for k, v in jterms.items():
        assert_close_calibrated(np.float64(t32[k]), np.float64(v), np.float64(t64[k]),
                                RTOL_LOSS, K_COND, what=k, expected64=np.float64(j64[k]))
    assert sorted(g32) == sorted(jgrads)
    noise = {}
    for k, v in jgrads.items():
        assert_close_calibrated(g32[k], v, g64[k], RTOL_GRAD, K_COND, what=k,
                                expected64=jg64[k])
        noise[k] = RTOL_GRAD * np.abs(g64[k]).max() + K_COND * (
            np.abs(g32[k] - g64[k]).max() + np.abs(v - jg64[k]).max())
    held = _adam_held(cfg["lr_cfg"], step, g32, jgrads, before, after, lr, noise)
    assert held >= ADAM_HELD_F32, held


@pytest.mark.parametrize("name,step,which", S1_CASES)
def test_stage1_step_matches_jax_bf16(steps, name, step, which):
    cfg, case = _s1_cfg(name, "bf16"), (step, which)
    assert cfg["mixed_precision"] and cfg["sdf_mixed_precision"]
    terms, grads, before, after, lr, draws = steps["port", name, "bf16", case]
    jterms, jgrads, jmasks = steps["jax", name, "bf16", case]
    j32, jg32, _ = steps["jax", name, "f32", case]
    masks = _port_masks(draws)
    _s1_gates(name, cfg, case, jterms, jgrads, jmasks)
    _s1_gates(name, cfg, case, terms, grads, masks)
    assert len(masks) == len(jmasks)
    flips = sum(int((m != j).sum()) for m, j in zip(masks, jmasks))
    assert flips <= MAX_OCC_FLIPS, flips
    assert sorted(terms) == sorted(jterms)
    for k, v in jterms.items():
        _held_bf16(terms[k], v, j32[k], BF16_RTOL_LOSS, k)
    assert sorted(grads) == sorted(jgrads)
    noise, left = {}, {}
    for k, v in jgrads.items():
        scale, gap = np.abs(jg32[k]).max(), np.abs(v - jg32[k]).max()
        if k.startswith(OCC_HEAD) and step < cfg["occ_loss_step"] and gap >= OWN_GAP * scale:
            left[k] = gap / max(scale, 1e-30)
            continue
        noise[k] = _held_bf16(grads[k], v, jg32[k], BF16_RTOL_GRAD, k)
    held = _adam_held(cfg["lr_cfg"], step, grads, jgrads, before, after, lr, noise)
    assert held >= ADAM_HELD_BF16, held


def _param_inv_s(params, inv_s):
    if inv_s is not None:
        return inv_s
    return float(np.exp(10.0 * np.float64(flat_leaves(params)[VAR])))


def _s2_gates(cfg, step, inv_s, terms, grads):
    seen, floor = _gate_inv_s(cfg, inv_s, step)
    var = float(np.abs(grads[VAR]).sum())
    assert (var > 0) == (step >= cfg["freeze_inv_s_step"] and inv_s > floor), \
        (step, inv_s, var)
    frozen = {"ior_frozen": step < cfg["freeze_ior_step"] or seen < cfg["freeze_ior_inv_s"],
              "thickness_frozen": (step < cfg["freeze_thickness_step"]
                                   or seen < cfg["freeze_thickness_inv_s"])}
    for flag, head in PHYSICAL.items():
        assert terms[flag] == float(frozen[flag]), (step, inv_s, flag, terms[flag])
        total = sum(float(np.abs(v).sum()) for k, v in grads.items() if k.startswith(head))
        assert (total == 0) == frozen[flag], (step, inv_s, head, total)
    assert sum(float(np.abs(v).sum()) for k, v in grads.items()
               if k.startswith("train/absorption")) > 0


@pytest.mark.parametrize("step,inv_s", S2_CASES)
def test_shell_step_matches_jax_f32(steps, step, inv_s):
    cfg, case = _s2_cfg("f32"), (step, inv_s)
    t32, o32, g32, before, after, lr = steps["port", "s2", "f32", case]
    t64, o64, g64 = steps["port", "s2", "f64", case][:3]
    jterms, jout, jgrads, jlr = steps["jax", "s2", "f32", case]
    j64, jout64, jg64, _ = steps["jax", "s2", "f64", case]
    jout, jout64 = ({k: np.asarray(v, np.float64) for k, v in o.items()} for o in (jout, jout64))
    seen = _param_inv_s(steps["s2_params"], inv_s)
    for terms, grads in ((jterms, jgrads), (t32, g32), (j64, jg64), (t64, g64)):
        _s2_gates(cfg, step, seen, terms, grads)
    _same_in_f64(t64, g64, j64, jg64, o64, jout64)
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
    assert lr == pytest.approx(jlr, rel=1e-6)
    held = _adam_held(cfg["lr_cfg"], step, g32, jgrads, before, after, lr, noise)
    assert held >= ADAM_HELD_F32, held


@pytest.mark.parametrize("step,inv_s", S2_CASES)
def test_shell_step_matches_jax_bf16(steps, step, inv_s):
    cfg, case = _s2_cfg("bf16"), (step, inv_s)
    assert cfg["sdf_mixed_precision"] and cfg.get("mixed_precision", True)
    terms, out, grads, before, after, lr = steps["port", "s2", "bf16", case]
    jterms, jout, jgrads, _ = steps["jax", "s2", "bf16", case]
    j32, jout32, jg32, _ = steps["jax", "s2", "f32", case]
    seen = _param_inv_s(steps["s2_params"], inv_s)
    _s2_gates(cfg, step, seen, jterms, jgrads)
    _s2_gates(cfg, step, seen, terms, grads)
    assert sorted(terms) == sorted(jterms)
    for k, v in jterms.items():
        _held_bf16(terms[k], v, j32[k], BF16_RTOL_LOSS, k)
    assert sorted(out) == sorted(jout)
    for k, v in jout.items():
        _held_bf16(out[k], v, jout32[k], BF16_RTOL_LOSS, k)
    assert sorted(grads) == sorted(jgrads)
    noise = {k: _held_bf16(grads[k], v, jg32[k], BF16_RTOL_GRAD, k) for k, v in jgrads.items()}
    held = _adam_held(cfg["lr_cfg"], step, grads, jgrads, before, after, lr, noise)
    assert held >= ADAM_HELD_BF16, held
