"""The port's zero-thickness stage-2 step against the JAX step under the
nested ``stage2`` leg's own config, at its schedule gates (CPU).

``configs/stage2/nerf/nested.yaml`` and the stage-1 config it names
(``configs/shape/nerf/nested.yaml``, the frozen nets') are read as they
are; only depth and sample counts are cut (``S2_CUT``, ``S1_CUT``: 4-layer
SDFs, 8 clipped outer and 4 + 1x4 inner samples, 16 rays on the marched
sphere of ``test_torch_port_shell.py``).  Every other key stays:
``zero_thickness`` with ``sphere_clip_outer``, ``freeze_inv_s_step`` 2,500,
``freeze_ior_step`` 5,000 with ``freeze_ior_inv_s`` 150, ``anneal_end``
15,000, ``apply_occ_loss`` / ``occ_loss_step`` 20,000 beside a loss list
without ``occ`` (no occlusion term at any step), the inv_s floor from 32 at 25,000 to 400 at 55,000,
``sdf_bias`` 0.4, ``inner_diffuse_only``, the warm-up cosine lr of
``lr_cfg`` (1,000 / 60,000), ``sdf_mixed_precision`` and the frozen nets'
``mixed_precision`` (stage 2's, on by default).  One whole step
(``train_outputs``, ``compute_losses``, one Adam update at the schedule's
lr through ``TrainStep``) is held at the steps on both sides of each gate
and at the floor's middle (``STEPS``); at 5,000 also with the inner inv_s
on each side of ``freeze_ior_inv_s`` (``INV_S``: 100 and 200), so that
both branches of the IoR gate are seen.  Stage 2 draws no random numbers;
its one draw, the rays, is the batch handed to both packages.

The JAX step (``tools/trained_step_compare.py``'s ``ShellJaxSide``, which
steps any stage-2 renderer) is traced once a kind, f32, float64 and bf16,
each in a spawned process of its own (``tests/stage2_schedule_jax.py``)
while this process steps the port: three traces of about 11 s of Python
each run side by side.  The float64 step runs with JAX's float32 pins
lifted (``jax_layers_in_f64``) and an int64 step.

The rays all enter the unit sphere, as every pixel's ray of the leg's
scene does (``synth-scene``: cameras at 2.2, ``camera_angle_x`` 0.65).  On
a ray that misses it JAX's IoR gradient is NaN once the IoR is live:
``sphere_clip_outer``'s exit segment takes ``sqrt(max(disc, 0))``
(``nunerf_tpu/models/stage2.py:393``), whose derivative at 0 is infinite,
and JAX's ``max`` multiplies it by 0 where ``torch.clamp`` masks it, so the
port's gradient is the finite one.  ``test_jax_ior_gradient_is_nan_on_a_ray
_missing_the_unit_sphere`` holds that case (ROADMAP §3.4).

Checks, with the tolerances of ``test_torch_port_shell_schedule.py``.  In
f32 (``mixed_precision`` and ``sdf_mixed_precision`` off in both configs):
every loss term and output within ``RTOL_LOSS`` of its scale and every
gradient within ``RTOL_GRAD`` of its scale, each plus ten times both
packages' own f32 error against their float64 step
(``port_helpers.assert_close_calibrated``); in float64 the terms and
gradients of the two packages within ``RTOL64_LOSS`` / ``RTOL64_GRAD`` of
scale, with no conditioning term.  The gates, in both packages: the inner
inv_s gradient zero before 2,500 and where the floor lifts inv_s above its
value, live otherwise; ``ior_frozen`` before 5,000 and while the floored
inv_s is under 150, and the IoR field's gradient zero exactly there; the
lr the schedule's.  In bf16 (the config's precision) each quantity of the
port is held to JAX's within ``BF16_RTOL_* * scale + K_BF16 * |jax_bf16 -
jax_f32|``: JAX's own bf16 rounding, measured against its f32 step, and
none of the port's; JAX's bf16 step is compiled with XLA's excess
precision off (``test_torch_port_bf16_rounding.py``).  The Adam update:
the port's equals optax.adam's at the schedule's lr on the port's own
gradients, and where JAX's gradient is clear of the bound above, JAX's.

Measured: in float64 the terms within 2.2e-16 of max(|term|, 1), the
outputs within 7.8e-16 and the gradients within 1.5e-11 of scale; in bf16
at most 0.35 of the bound (the inner shader's light head at 999).  About
60 s alone by pytest's count with an empty JAX compile cache, 43 s with a
warm one (8 CPU cores).
"""

import contextlib
import multiprocessing as mp
import os

import numpy as np
import pytest
import torch
import yaml

import stage2_schedule_jax
from nunerf_tpu_torch.convert import flat_leaves, load_jax_params, to_jax_tree
from nunerf_tpu_torch.models.stage1 import PARAM_KEYS as STAGE1_KEYS
from nunerf_tpu_torch.models.stage1 import ShapeRenderer
from nunerf_tpu_torch.models.stage2 import Stage2Renderer, tree_keys
from nunerf_tpu_torch.tracing.mesh_ops import extract_geometry, vertex_normals_curvature
from nunerf_tpu_torch.tracing.scene import Scene
from nunerf_tpu_torch.train.lr import warm_up_cos_host
from nunerf_tpu_torch.train.trainer import TrainStep
from port_helpers import assert_close_calibrated, jitter_tree

tsc = stage2_schedule_jax._tool()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S2_PATH = "configs/stage2/nerf/nested.yaml"
GATES = (1000, 2500, 5000, 15000, 25000, 55000, 60000)
STEPS = sorted({g - 1 for g in GATES} | set(GATES) | {40000})
# the inner inv_s of each case: the jittered init's (about 20) at every step,
# and at 5,000 also 100 and 200, each side of freeze_ior_inv_s
INV_S = (100.0, 200.0)
CASES = [(s, None) for s in STEPS] + [(5000, v) for v in INV_S]
# the rays that miss the unit sphere: the IoR frozen, then live (float64)
ESCAPING = [(4999, 200.0), (5000, 200.0)]
RN = 16
S1_CUT = dict(sdf_n_layers=4, n_samples=8, n_importance=8, up_sample_steps=2,
              n_bg_samples=4, n_front_samples=2, n_back_samples=2)
S2_CUT = dict(sdf_n_layers=4, n_samples_outer=8, n_samples_inner=4, inner_up_rounds=1,
              inner_up_each=4)
# keys that name files of a run: the test hands both packages the scene,
# the stage-1 parameters and the stage-1 config instead
FILE_KEYS = ("stage1_mesh_dir", "stage1_ckpt_dir", "stage1_cfg_dir")
RTOL_LOSS, RTOL_GRAD, K_COND = 1e-5, 1e-4, 10.0
RTOL64_LOSS, RTOL64_GRAD = 1e-12, 1e-10
BF16_RTOL_LOSS, BF16_RTOL_GRAD, K_BF16 = 1e-3, 1e-2, 2.0
VAR = "train/var_inner/variance"
IOR = "train/ior/"
# at least these shares of the trainable parameters are held to JAX's update
ADAM_HELD_F32, ADAM_HELD_BF16 = 0.05, 0.01
# JAX's bf16 step compiled as the JAX code reads: XLA's CPU fusions otherwise
# keep some bf16 elementwise chains in f32
OPTIONS = {"bf16": {"xla_allow_excess_precision": False}}
JAX_LIMIT = 600.0  # seconds the spawned JAX sides may take
KINDS = ("f32", "f64", "bf16")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _read(rel):
    with open(os.path.join(ROOT, rel)) as f:
        return yaml.safe_load(f)


def _cfg(bf16):
    """The leg's stage-2 config with depth and samples cut, its stage-1
    config inlined; in f32 both configs' bf16 switches off."""
    s2 = _read(S2_PATH)
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


def _gate_inv_s(cfg, inv_s, step):
    """(the inner inv_s the IoR gate reads: the parameter's, floored; the
    floor, 0 before its start)."""
    floor = 0.0
    if step >= cfg["inv_s_floor_start"]:
        t = min((step - cfg["inv_s_floor_start"])
                / (cfg["inv_s_floor_end"] - cfg["inv_s_floor_start"]), 1.0)
        floor = cfg["inv_s_floor_base"] * (cfg["inv_s_floor_max"]
                                           / cfg["inv_s_floor_base"]) ** t
    return max(inv_s, floor), floor


def test_config_holds_the_gates_the_cases_straddle():
    cfg = _read(S2_PATH)
    assert cfg["zero_thickness"] and cfg["sphere_clip_outer"]
    assert cfg["n_samples_outer"] == 176 and cfg["sdf_bias"] == 0.4
    assert cfg["lr_type"] == "warm_up_cos" and cfg["lr_cfg"]["end_warm"] == 1000
    assert cfg["lr_cfg"]["end_iter"] == cfg["total_step"] == 60000
    assert cfg["freeze_inv_s_step"] == 2500 and cfg["anneal_end"] == 15000
    assert cfg["freeze_ior_step"] == 5000
    assert min(INV_S) < cfg["freeze_ior_inv_s"] == 150 < max(INV_S)
    assert (cfg["inv_s_floor_start"], cfg["inv_s_floor_end"]) == (25000, 55000)
    assert (cfg["inv_s_floor_base"], cfg["inv_s_floor_max"]) == (32.0, 400.0)
    assert cfg["apply_occ_loss"] and cfg["occ_loss_step"] == 20000 < max(STEPS)
    assert "occ" not in cfg["loss"]
    assert cfg["inner_diffuse_only"] and cfg["sdf_mixed_precision"]
    assert "mixed_precision" not in cfg and cfg["downsample_ratio"] == 1.0
    for gate in GATES:
        assert gate - 1 in STEPS and gate in STEPS
    # the floor's middle lies under freeze_ior_inv_s, its end above it
    assert _gate_inv_s(cfg, 0.0, 40000)[1] < 150 < _gate_inv_s(cfg, 0.0, 55000)[1]


def _mesh():
    """The marched sphere of radius 0.5 of ``test_torch_port_shell.py``."""
    return extract_geometry(lambda p: np.linalg.norm(p, axis=-1) - 0.5, resolution=12)


def _batch(escaping=0):
    """``RN`` rays from (0, 0, -2.5): half aimed into triangles next to
    vertices of negative curvature on the side facing the camera, half at
    random points of the disc of radius 0.9 through the origin, so that
    every ray enters the unit sphere (half-angle 23.6 degrees from there)
    and some miss the mesh; the first ``escaping`` of those aimed at radius
    1.5 instead, outside the unit sphere."""
    rs = np.random.RandomState(0)
    origin = np.array([0.0, 0.0, -2.5], np.float32)
    origins = np.tile(origin[None], (RN, 1))
    verts, tris = _mesh()
    _, curv = vertex_normals_curvature(verts, tris)
    front = (curv[tris[:, 0]] < -1.0) & (verts[tris[:, 0], 2] < -0.25)
    pick = tris[np.flatnonzero(front)[:RN // 2]]
    on_mesh = 0.8 * verts[pick[:, 0]] + 0.1 * verts[pick[:, 1]] + 0.1 * verts[pick[:, 2]]
    n_rand = RN - len(on_mesh)
    angle = rs.uniform(0.0, 2.0 * np.pi, n_rand)
    radius = 0.9 * np.sqrt(rs.uniform(0.0, 1.0, n_rand))
    radius[:escaping] = 1.5
    disc = np.stack([radius * np.cos(angle), radius * np.sin(angle), np.zeros(n_rand)], -1)
    dirs = np.concatenate([disc.astype(np.float32), on_mesh]) - origins
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return {"rays_o": origins, "rays_d": dirs.astype(np.float32),
            "rgbs": rs.rand(RN, 3).astype(np.float32)}


def _enters_unit_sphere(batch):
    o, d = batch["rays_o"].astype(np.float64), batch["rays_d"].astype(np.float64)
    ob = np.sum(o * d, -1)
    return ob * ob - (np.sum(o * o, -1) - 1.0) > 0


def _f64(arrays):
    return {k: np.asarray(v, np.float64) for k, v in arrays.items()}


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


@contextlib.contextmanager
def _default_dtype(dtype):
    prev = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        yield
    finally:
        torch.set_default_dtype(prev)


class _PortSide:
    """The port's renderer of one kind, built once; ``step`` loads a case's
    parameters and takes one step through a fresh ``TrainStep`` at the
    schedule's lr: (terms, outputs, trainable gradients, parameters before
    and after, lr)."""

    def __init__(self, mesh, params, kind):
        self.fdt = torch.float64 if kind == "f64" else torch.float32
        with _default_dtype(self.fdt):
            scene = Scene(mesh, tile=512, device="cpu")
            for name in tsc.SCENE_ARRAYS:
                setattr(scene, name, getattr(scene, name).to(self.fdt))
            self.renderer = Stage2Renderer(_cfg(kind == "bf16"), scene, params["frozen"],
                                           device="cpu")
            if kind == "f64":
                self.renderer.to(self.fdt)
        forward, self.outputs = self.renderer.train_outputs, {}

        def keep(batch, step, generator=None):  # the step's own forward
            self.outputs.update(forward(batch, step, generator))
            return self.outputs

        self.renderer.train_outputs = keep

    def step(self, params, batch, step):
        with _default_dtype(self.fdt):
            load_jax_params(self.renderer, params, tree_keys())
            self.renderer.zero_grad(set_to_none=True)
            self.outputs.clear()
            train = TrainStep(self.renderer, warm_up_cos_host(**_lr_args()))
            train.n_updates = step  # the schedule's lr at this step
            terms = train.compute_grads({k: torch.as_tensor(v).to(self.fdt)
                                         for k, v in batch.items()}, step)
            grads = tsc.port_leaves(self.renderer, tree_keys(), "grad")
            before = tsc.port_leaves(self.renderer, tree_keys())
            train.apply()
            after = tsc.port_leaves(self.renderer, tree_keys())
            lr = train.optimizer.param_groups[0]["lr"]
        terms = {k: float(v.detach()) if torch.is_tensor(v) else float(v)
                 for k, v in terms.items()}
        out = {k: v.detach().to(torch.float64).numpy() for k, v in self.outputs.items()}
        grads = _train_only({k: v.astype(np.float64) for k, v in grads.items()})
        for k in before:
            if k.startswith("frozen/"):
                np.testing.assert_array_equal(after[k], before[k], err_msg=k)
        return terms, out, grads, before, after, lr


@pytest.fixture(scope="module")
def steps():
    """Every case's step in each package and kind: {(package, kind, case):
    result}, a case ``(step, inv_s)``, or ``("escaping", step, inv_s)`` on
    the batch with rays that miss the unit sphere (float64 only).  The
    parameters are the port's init jittered off it, in the JAX layout; the
    JAX sides run in three spawned processes while this one steps the
    port."""
    pool = mp.get_context("spawn").Pool(len(KINDS), stage2_schedule_jax.warm)
    try:
        mesh = _mesh()
        cfg = _cfg(False)
        s1_tree = to_jax_tree(ShapeRenderer(cfg["stage1_cfg"], device="cpu", seed=7),
                              STAGE1_KEYS)
        s1_params = jitter_tree(s1_tree, 1, 0.05)
        renderer = Stage2Renderer(cfg, Scene(mesh, tile=512, device="cpu"), s1_params,
                                  device="cpu")
        params = {"train": jitter_tree(to_jax_tree(renderer, tree_keys())["train"], 2, 0.05),
                  "frozen": s1_params}
        batch, escaping = _batch(), _batch(escaping=2)
        assert _enters_unit_sphere(batch).all()
        assert (~_enters_unit_sphere(escaping)).sum() == 2
        runs = {kind: [(c, _with_inv_s(params, c[1]), batch, c[0]) for c in CASES]
                for kind in KINDS}
        runs["f64"] += [(("escaping",) + c, _with_inv_s(params, c[1]), escaping, c[0])
                        for c in ESCAPING]
        jax_runs = {kind: pool.apply_async(stage2_schedule_jax.steps, (
            kind, _cfg(kind == "bf16"), mesh, s1_params, [r[1:] for r in rs],
            OPTIONS.get(kind))) for kind, rs in runs.items()}
        out = {"params": params}
        for kind, rs in runs.items():
            port = _PortSide(mesh, params, kind)
            for case, p, b, step in rs:
                out["port", kind, case] = port.step(p, b, step)
        for kind, rs in runs.items():
            for (case, *_), res in zip(rs, jax_runs[kind].get(timeout=JAX_LIMIT)):
                out["jax", kind, case] = (res[0], _f64(res[1]), _f64(res[2]))
                out["jax_lr", case] = res[3]
    finally:
        pool.terminate()
        pool.join()
    return out


def _check_gates(cfg, step, inv_s, terms, grads):
    """The schedule's gates in one package's step at the inner inv_s
    ``inv_s`` of its parameters."""
    seen, floor = _gate_inv_s(cfg, inv_s, step)
    var = float(np.abs(grads[VAR]).sum())
    assert (var > 0) == (step >= cfg["freeze_inv_s_step"] and inv_s > floor), \
        (step, inv_s, var)
    frozen = step < cfg["freeze_ior_step"] or seen < cfg["freeze_ior_inv_s"]
    assert terms["ior_frozen"] == float(frozen), (step, inv_s, terms["ior_frozen"])
    ior = sum(float(np.abs(v).sum()) for k, v in grads.items() if k.startswith(IOR))
    assert (ior == 0) == frozen, (step, inv_s, ior)
    for head in ("train/sdf_inner/", "train/shade_inner/"):
        assert sum(float(np.abs(v).sum()) for k, v in grads.items() if k.startswith(head)) > 0
    # no occlusion term: the loss list has none, whatever apply_occ_loss says
    assert not any("occ" in k for k in terms)


def _adam(grads, lr):
    """optax.adam's first update from a fresh state at ``lr``: ``-lr * g /
    (|g| + 1e-8)`` in f32 (both moments' bias corrections divide out)."""
    g = {k: v.astype(np.float32) for k, v in grads.items()}
    return {k: -np.float32(lr) * v / (np.sqrt(v * v) + np.float32(1e-8)) for k, v in g.items()}


def _adam_held(step, jlr, grads, jgrads, before, after, lr, noise):
    """The port's update is Adam's first at the schedule's lr (JAX's
    ``warm_up_cos_schedule`` at ``step``, ``jlr``) on its own gradients;
    where JAX's gradient is clear of ``noise``, JAX's.  Returns the share of
    the trainable parameters so held."""
    assert lr == pytest.approx(jlr, rel=1e-6)
    upd, jupd = _adam(grads, lr), _adam(jgrads, lr)
    held = total = 0
    for k in grads:
        np.testing.assert_allclose(after[k], before[k] + upd[k], rtol=1e-6, atol=1e-5 * lr,
                                   err_msg=k)
        total += before[k].size
        jafter = before[k] + jupd[k]
        clear = np.abs(jgrads[k]) > noise[k] + 1e-6
        diff = np.abs(after[k] - jafter)
        assert (diff[clear] <= 1e-6 + 1e-6 * np.abs(jafter[clear])).all(), k
        held += int(clear.sum())
    return held / total


def _param_inv_s(params, inv_s):
    if inv_s is not None:
        return inv_s
    return float(np.exp(10.0 * np.float64(flat_leaves(params)[VAR])))


def _same_in_f64(port, jax_):
    """The two packages' float64 steps, with no conditioning term."""
    (t64, o64, g64), (j64, jout64, jg64) = port[:3], jax_
    for k, v in j64.items():
        assert abs(t64[k] - v) <= RTOL64_LOSS * max(abs(v), 1.0), (k, t64[k], v)
    for k, v in jout64.items():
        err = np.abs(o64[k] - v).max()
        assert err <= RTOL64_LOSS * max(np.abs(v).max(), 1.0), (k, err)
    for k, v in jg64.items():
        err = np.abs(g64[k] - v).max()
        assert err <= RTOL64_GRAD * np.abs(v).max() + 1e-300, (k, err, np.abs(v).max())


@pytest.mark.parametrize("step,inv_s", CASES)
def test_stage2_step_matches_jax_f32(steps, step, inv_s):
    cfg, case = _cfg(False), (step, inv_s)
    t32, o32, g32, before, after, lr = steps["port", "f32", case]
    t64, o64, g64 = steps["port", "f64", case][:3]
    jterms, jout, jgrads = steps["jax", "f32", case]
    j64, jout64, jg64 = steps["jax", "f64", case]
    seen = _param_inv_s(steps["params"], inv_s)
    for terms, grads in ((jterms, jgrads), (t32, g32), (j64, jg64), (t64, g64)):
        _check_gates(cfg, step, seen, terms, grads)
    _same_in_f64(steps["port", "f64", case], steps["jax", "f64", case])

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
    jlr = steps["jax_lr", case]
    assert _adam_held(step, jlr, g32, jgrads, before, after, lr, noise) >= ADAM_HELD_F32


def _held_bf16(got, want, want32, rtol, what):
    """``got`` (the port in bf16) against ``want`` (JAX in bf16) within
    ``rtol * scale + K_BF16 * |want - want32|``: the scale is JAX's f32
    value's, the second term JAX's own bf16 rounding.  Returns the bound."""
    got, want, want32 = (np.asarray(x, np.float64) for x in (got, want, want32))
    scale, gap = np.abs(want32).max(), np.abs(want - want32).max()
    err, bound = np.abs(got - want).max(), rtol * scale + K_BF16 * gap
    assert err <= bound, f"{what}: max err {err:.3e} > {bound:.3e} (JAX's own {gap:.3e})"
    return bound


@pytest.mark.parametrize("step,inv_s", CASES)
def test_stage2_step_matches_jax_bf16(steps, step, inv_s):
    cfg, case = _cfg(True), (step, inv_s)
    assert cfg["sdf_mixed_precision"] and cfg.get("mixed_precision", True)
    terms, out, grads, before, after, lr = steps["port", "bf16", case]
    jterms, jout, jgrads = steps["jax", "bf16", case]
    j32, jout32, jg32 = steps["jax", "f32", case]
    seen = _param_inv_s(steps["params"], inv_s)
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
    jlr = steps["jax_lr", case]
    assert _adam_held(step, jlr, grads, jgrads, before, after, lr, noise) >= ADAM_HELD_BF16


@pytest.mark.parametrize("step,inv_s", ESCAPING)
def test_jax_ior_gradient_is_nan_on_a_ray_missing_the_unit_sphere(steps, step, inv_s):
    """Two rays of the batch miss the unit sphere.  With the IoR frozen the
    two packages' float64 steps are the same step; with it live JAX's IoR
    gradient has NaNs in every leaf (the infinite derivative of its
    ``sqrt(max(disc, 0))`` at 0 times ``max``'s 0) and the port's is
    finite, every other term and gradient the same."""
    cfg, case = _cfg(False), ("escaping", step, inv_s)
    port, jax_ = steps["port", "f64", case], steps["jax", "f64", case]
    live = not (step < cfg["freeze_ior_step"])
    ior = [k for k in jax_[2] if k.startswith(IOR)]
    assert ior and all(np.isfinite(port[2][k]).all() for k in ior)
    assert sum(float(np.abs(port[2][k]).sum()) for k in ior) > 0 if live else True
    assert all(np.isnan(jax_[2][k]).any() for k in ior) == live
    if live:
        jax_ = (jax_[0], jax_[1], {k: v for k, v in jax_[2].items() if k not in ior})
        port = (port[0], port[1], {k: v for k, v in port[2].items() if k not in ior})
    _same_in_f64(port, jax_)
