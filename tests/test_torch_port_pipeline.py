"""The port's leg runner (``nunerf_tpu_torch.pipeline``) and its
``eval_shell`` (``nunerf_tpu_torch.tools.eval_shell``) on the CPU.

* ``eval_shell`` against ``tools/eval_shell.py`` on one JAX checkpoint of a
  shell stage-2 tree with ``learn_absorption``, for the meta of a Blender
  and of a capture-layout shell scene: every number to rtol 1e-5 (f32 MLPs
  on both sides); and the same numbers from a port checkpoint of the same
  parameters.
* ``shell_front`` then ``shell_stage2`` through ``run_leg`` on a tiny
  scene, tiny configs and 16^3 extractions, in a working directory of their
  own: the mesh paths chained from the checkpoints' steps, the configs
  written under the working directory, the record printed and written;
  then ``shell_stage2b`` (``nested_shell_b.yaml``, the absorption gated) on a
  copy of that directory: its own run, meshes and scores, the absorption
  still at its init after its steps.  Every leg of ``pipeline.LEGS`` runs
  end to end in some test (``test_every_leg_runs_end_to_end_in_a_test``).
* ``tools.leg_geometry``'s copies of each checkpoint the front leg's
  trainer writes, its refusal to start a seed run where the leg would
  resume, and the seed run's overrides (``--train-f32``: both bf16
  switches off).
* The guards: a stage-2 leg without its stage-1 mesh stops with a message;
  a budgeted child that outlives its budget is a pause, after which the leg
  goes on from the last checkpoint (the child's command is injected, so no
  race with the wall clock decides); a failed child stops the leg; the
  repository's root is refused as a working directory.
"""

import importlib.util
import json
import os
import re
import sys

import numpy as np
import pytest
import torch

from leg_script import assert_runs_script
from nunerf_tpu_torch import pipeline as pl
from nunerf_tpu_torch.tools import eval_shell as port_eval_shell
from nunerf_tpu_torch.tools import leg_geometry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


S1_TINY = dict(n_samples=8, n_importance=8, up_sample_steps=2, n_bg_samples=4,
               n_front_samples=2, n_back_samples=2, sdf_n_layers=4, train_ray_num=32,
               test_ray_num=64, mixed_precision=False, sdf_mixed_precision=False,
               total_step=4, train_log_step=2, val_interval=4, save_interval=2)
S2_TINY = dict(sdf_n_layers=4, n_samples_outer=8, n_samples_inner=4, inner_up_rounds=1,
               inner_up_each=4, curv_smooth_iters=5, mixed_precision=False,
               sdf_mixed_precision=False, train_ray_num=16, test_ray_num=64, total_step=2,
               train_log_step=1, save_interval=2, val_interval=2,
               stage1_mesh_dir="./data/meshes/nested_shell-4_simplified_outer.ply")
TINY = dict(device="cpu", cfg_overrides={pl.S1_SHELL: S1_TINY, pl.S2_SHELL: S2_TINY,
                                         pl.S2_SHELL_B: S2_TINY},
            extra_args={"synth-scene": ["--n-train", "4", "--n-test", "2", "--size", "16"],
                        "extract-mesh-stage1": ["--resolution", "16"],
                        "extract-mesh-stage2": ["--resolution", "16"],
                        "postprocess-outer": ["--views", "4"],
                        "eval-geometry": ["--n-samples", "2000"]})


# ---------------------------------------------------------------------------
# eval_shell against the JAX tool
# ---------------------------------------------------------------------------

def _jax_tool():
    spec = importlib.util.spec_from_file_location("jax_eval_shell",
                                                  os.path.join(ROOT, "tools", "eval_shell.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _shell_tree():
    """A shell stage-2 tree in the JAX layout with ``learn_absorption``: the
    port's tiny renderer's leaves, with IoR and thickness fields drawn by the
    JAX networks' init and moved off it, and an absorption of three
    distinct channels.  Returns (tree, tiny renderer)."""
    import jax

    from nunerf_tpu.fields.aux import IoRNetwork, ThicknessNetwork
    from nunerf_tpu_torch.convert import load_jax_params, to_jax_tree
    from nunerf_tpu_torch.models.stage1 import PARAM_KEYS as STAGE1_KEYS
    from nunerf_tpu_torch.models.stage1 import ShapeRenderer
    from nunerf_tpu_torch.models.stage2 import tree_keys
    from nunerf_tpu_torch.models.stage2_shell import Stage2ShellRenderer
    from nunerf_tpu_torch.tracing.mesh_ops import extract_geometry
    from nunerf_tpu_torch.tracing.scene import Scene
    from port_helpers import jitter_tree

    s1_cfg = {"is_nerf": True, "n_samples": 8, "n_importance": 8, "n_bg_samples": 4,
              "up_sample_steps": 2, "sdf_n_layers": 4}
    cfg = {"is_nerf": True, "zero_thickness": False, "stage1_cfg": s1_cfg,
           "sdf_n_layers": 4, "n_samples_outer": 8, "n_samples_inner": 4,
           "mixed_precision": False, "learn_absorption": True}
    s1 = to_jax_tree(ShapeRenderer(s1_cfg, device="cpu", seed=7), STAGE1_KEYS)
    mesh = extract_geometry(lambda p: np.linalg.norm(p, axis=-1) - 0.5, resolution=12)
    renderer = Stage2ShellRenderer(cfg, Scene(mesh, device="cpu"), s1, device="cpu", seed=3)
    tree = to_jax_tree(renderer, tree_keys())
    pts = np.zeros((1, 3), np.float32)
    for i, (key, net) in enumerate((("ior", IoRNetwork()), ("thickness", ThicknessNetwork()))):
        init = net.init(jax.random.PRNGKey(20 + i), pts)
        tree["train"][key] = jitter_tree(jax.device_get(init), 30 + i, 0.3)
    tree["train"]["absorption"] = np.array([-1.0, 0.3, 1.2], np.float32)
    load_jax_params(renderer, tree, tree_keys())
    return tree, renderer


def _scene_meta(tmp_path, kind):
    from nunerf_tpu_torch.tools.synth_nested import make_nested_scene

    root = make_nested_scene(str(tmp_path / "scene"), n_train=1, n_test=1, h=8, w=8,
                             shell=True)
    with open(os.path.join(root, "meta.json")) as f:
        meta = json.load(f)
    if kind == "capture":  # the capture layout's normalised frame
        s = 1.6
        meta = dict(meta, r_outer=meta["r_outer"] * s, tau=meta["tau"] * s, norm_scale=s)
    path = str(tmp_path / f"meta_{kind}.json")
    with open(path, "w") as f:
        json.dump(meta, f)
    return path


def _assert_same_numbers(got, want, rtol):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if w is None:
            assert g is None, k
        else:
            np.testing.assert_allclose(np.asarray(g, np.float64), np.asarray(w, np.float64),
                                       rtol=rtol, err_msg=k)


@pytest.mark.parametrize("kind", ["blender", "capture"])
def test_eval_shell_matches_the_jax_tool(tmp_path, monkeypatch, capsys, kind):
    from nunerf_tpu.train.trainer import save_checkpoint as jax_save_checkpoint
    from nunerf_tpu_torch.convert import to_jax_tree
    from nunerf_tpu_torch.models.stage2 import tree_keys
    from nunerf_tpu_torch.train.trainer import save_checkpoint

    monkeypatch.chdir(tmp_path)
    meta = _scene_meta(tmp_path, kind)
    with open("shell.yaml", "w") as f:
        f.write("name: tiny_shell_s2\nior_offset: 0.6\nthickness_scale: 0.01\n")
    tree, renderer = _shell_tree()
    jax_save_checkpoint("jax/model.ckpt", 1200, tree, {"count": np.int32(1200)}, 21.5)

    monkeypatch.setattr(sys, "argv", ["eval_shell.py", "--cfg", "shell.yaml", "--meta", meta,
                                      "--ckpt", "jax/model.ckpt"])
    _jax_tool().main()
    with open("runs/eval_shell_tiny_shell_s2.json") as f:
        want = json.load(f)
    os.remove("runs/eval_shell_tiny_shell_s2.json")
    capsys.readouterr()

    got = port_eval_shell.main(["--cfg", "shell.yaml", "--meta", meta, "--ckpt",
                                "jax/model.ckpt", "--device", "cpu"])
    printed = capsys.readouterr().out.splitlines()
    assert json.loads(printed[0]) == got
    assert printed[1] == "wrote runs/eval_shell_tiny_shell_s2.json"
    with open("runs/eval_shell_tiny_shell_s2.json") as f:
        assert json.load(f) == got
    _assert_same_numbers(got, want, 1e-5)
    assert len(got["learned_kappa"]) == 3 and len(got["gt_kappa_normalized"]) == 3
    assert 0.0 < got["ior_field_std"] and 0.0 < got["thickness_field_std"]

    # the port's own checkpoint of the same parameters gives the same numbers
    save_checkpoint("port/model.ckpt", 1200, to_jax_tree(renderer, tree_keys()),
                    {"count": 1200}, 21.5)
    again = port_eval_shell.main(["--cfg", "shell.yaml", "--meta", meta, "--ckpt",
                                  "port/model.ckpt", "--device", "cpu"])
    _assert_same_numbers(again, got, 0.0)

    # the default checkpoint is data/model/<name>/model.ckpt
    save_checkpoint("data/model/tiny_shell_s2/model.ckpt", 1200,
                    to_jax_tree(renderer, tree_keys()), {"count": 1200}, 21.5)
    default = port_eval_shell.main(["--cfg", "shell.yaml", "--meta", meta, "--device", "cpu"])
    _assert_same_numbers(default, got, 0.0)


# ---------------------------------------------------------------------------
# the shell legs end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def shell_legs(tmp_path_factory):
    """``shell_front`` then ``shell_stage2`` (a 600 s budget, never reached)
    in one working directory, the front leg's checkpoints copied at every
    2 steps by ``leg_geometry.kept_checkpoints``; returns (workdir, front
    record, stage-2 record, printed lines, {step: copy})."""
    import contextlib
    import io

    home = tmp_path_factory.mktemp("legs")
    work = str(home / "work")
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(buf):
        mp.chdir(home)
        mp.setenv("OMP_NUM_THREADS", "1")  # the budgeted child
        with leg_geometry.kept_checkpoints(str(home / "snap"), 2) as kept:
            front = pl.run_leg("shell_front", work, **TINY)
        stage2 = pl.run_leg("shell_stage2", work, budget=600, **TINY)
    return work, front, stage2, buf.getvalue().splitlines(), kept


@pytest.fixture(scope="module")
def shell_stage2b(shell_legs, tmp_path_factory):
    """``shell_stage2b`` (a 600 s budget, never reached) in a copy of the
    shell legs' working directory: (workdir, record)."""
    import contextlib
    import io
    import shutil

    home = tmp_path_factory.mktemp("legs_b")
    work = str(home / "work")
    shutil.copytree(shell_legs[0], work)
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(io.StringIO()):
        mp.chdir(home)
        mp.setenv("OMP_NUM_THREADS", "1")  # the budgeted child
        rec = pl.run_leg("shell_stage2b", work, budget=600, **TINY)
    return work, rec


def _argv(record, command):
    return [c["argv"] for c in record["commands"] if c["command"] == command]


def test_front_leg_chains_the_mesh_named_from_its_checkpoint(shell_legs):
    work, front, _, _, _ = shell_legs
    # the repository's config trains 30,000 steps; the tiny one 4: every later
    # subcommand reads the mesh named from the checkpoint's step
    assert front["steps"] == {"nested_shell": {"from": 0, "to": 4, "total_step": 4,
                                               "paused": False}}
    assert front["checkpoints"]["extract-mesh-stage1"] == 4
    simplified = "data/meshes/nested_shell-4_simplified.ply"
    outer = "data/meshes/nested_shell-4_simplified_outer.ply"
    assert front["meshes"] == {"stage1": simplified, "outer": outer}
    assert [c["command"] for c in front["commands"]] == [
        "synth-scene", "train", "extract-mesh-stage1", "postprocess-outer", "eval-geometry",
        "eval-images"]
    # the leg's own resolution, then the test's, which argparse keeps
    assert _argv(front, "extract-mesh-stage1")[0][3:] == ["--resolution", "512",
                                                          "--resolution", "16"]
    assert _argv(front, "postprocess-outer")[0][:3] == ["postprocess-outer", "--input",
                                                        simplified]
    assert _argv(front, "eval-geometry")[0][:5] == [
        "eval-geometry", "--mesh", outer, "--gt", "datasets/nested_shell/gt_outer.npy"]
    assert _argv(front, "synth-scene")[0][:4] == ["synth-scene", "--output",
                                                  "./datasets/nested_shell", "--shell"]
    for rel in ("data/model/nested_shell/model.ckpt", simplified, outer,
                "data/eval/nested_shell/eval_test.json", "runs/leg_shell_front.json"):
        assert os.path.exists(os.path.join(work, rel)), rel
    assert np.isfinite(front["chamfer"]["outer"]["chamfer"])
    ev = front["eval_images"]["nested_shell"]
    assert ev["views"] == 2 and ev["step"] == 4 and np.isfinite(ev["mean_psnr"])
    assert all(c["s"] >= 0 for c in front["commands"])


def test_legs_write_their_configs_and_records_in_the_workdir(shell_legs):
    import yaml

    work, front, stage2, printed, _ = shell_legs
    with open(os.path.join(work, pl.S1_SHELL)) as f:
        s1 = yaml.safe_load(f)
    with open(os.path.join(ROOT, pl.S1_SHELL)) as f:
        repo_s1 = yaml.safe_load(f)
    assert s1 == dict(repo_s1, **S1_TINY)
    with open(os.path.join(work, pl.S2_SHELL)) as f:
        s2 = yaml.safe_load(f)
    # the stage-2 config's relative paths resolve in the workdir, where the
    # derived stage-1 config is
    assert s2["stage1_cfg_dir"] == "./configs/shape/nerf/nested_shell.yaml"
    assert s2["stage1_ckpt_dir"] == "./data/model/nested_shell/model_best.ckpt"
    for rec in (front, stage2):
        assert rec["workdir"] == work
        with open(os.path.join(work, "runs", f"leg_{rec['leg']}.json")) as f:
            assert json.load(f) == json.loads(json.dumps(rec))
    # each leg's last printed line is its record, after every subcommand's
    # lines and seconds
    lines = [json.loads(x) for x in printed if x.startswith('{"leg"')]
    assert [r["leg"] for r in lines] == ["shell_front", "shell_stage2"]
    assert printed[-1].startswith('{"leg": "shell_stage2"')
    assert sum(1 for x in printed if re.match(r"\[pipeline\] [\w-]+: [0-9.]+ s$", x)) == \
        len(front["commands"]) + len(stage2["commands"])


def test_stage2_leg_chains_its_inner_mesh_and_scores_the_shell(shell_legs):
    work, _, stage2, _, _ = shell_legs
    assert stage2["steps"] == {"nested_shell_s2": {"from": 0, "to": 2, "total_step": 2,
                                                   "paused": False}}
    assert [c["command"] for c in stage2["commands"]] == [
        "train", "eval_shell", "extract-mesh-stage2", "postprocess-stage2", "eval-geometry",
        "eval-images"]
    inner = "data/meshes/nested_shell_s2-2-inner.ply"
    assert stage2["meshes"] == {"inner": inner,
                                "inner_post": "data/meshes/nested_shell_s2-2-inner_post.ply"}
    assert _argv(stage2, "postprocess-stage2")[0] == [
        "postprocess-stage2", "--input", inner, "--outer",
        "./data/meshes/nested_shell-4_simplified_outer.ply"]
    assert _argv(stage2, "eval-geometry")[0][:5] == [
        "eval-geometry", "--mesh", "data/meshes/nested_shell_s2-2-inner_post.ply", "--gt",
        "datasets/nested_shell/gt_inner.npy"]
    train = stage2["commands"][0]
    assert train["budget_s"] == 600 and not train["paused"]
    # eval_shell: the JAX tool's keys, from the leg's checkpoint
    es = stage2["eval_shell"]
    assert sorted(es) == sorted([
        "learned_ior", "gt_ior", "ior_abs_err", "learned_thickness", "gt_thickness",
        "thickness_abs_err", "ior_field_std", "thickness_field_std", "learned_kappa",
        "gt_kappa_normalized"])
    assert es["gt_ior"] == 1.5 and es["gt_thickness"] == 0.008
    assert all(np.isfinite(es[k]) for k in ("learned_ior", "learned_thickness"))
    with open(os.path.join(work, "runs/eval_shell_nested_shell_s2.json")) as f:
        assert json.load(f) == es
    ev = stage2["eval_images"]["nested_shell_s2"]
    assert ev["step"] == 2 and ev["views"] == 2


@pytest.mark.parametrize("which", ["shell_front", "shell_stage2"])
def test_shell_legs_run_the_subcommands_of_their_script_bodies(shell_legs, which):
    assert_runs_script(shell_legs[{"shell_front": 1, "shell_stage2": 2}[which]])


def test_gated_shell_stage2b_runs_its_own_config_on_the_shell_front(shell_stage2b):
    import yaml

    work, rec = shell_stage2b
    assert_runs_script(rec)
    with open(os.path.join(work, pl.S2_SHELL_B)) as f:
        s2 = yaml.safe_load(f)
    with open(os.path.join(ROOT, pl.S2_SHELL_B)) as f:
        assert s2 == dict(yaml.safe_load(f), **S2_TINY)
    assert (s2["freeze_absorption_step"], s2["freeze_absorption_inv_s"]) == (3000, 200.0)
    # the shell front's outer mesh and best checkpoint, as shell_stage2's
    assert s2["stage1_ckpt_dir"] == "./data/model/nested_shell/model_best.ckpt"
    assert rec["stage1"]["mesh"] == S2_TINY["stage1_mesh_dir"]
    assert rec["steps"] == {"nested_shell_s2b": {"from": 0, "to": 2, "total_step": 2,
                                                 "paused": False}}
    inner = "data/meshes/nested_shell_s2b-2-inner.ply"
    assert rec["meshes"] == {"inner": inner, "inner_post": inner[:-4] + "_post.ply"}
    assert _argv(rec, "postprocess-stage2")[0] == [
        "postprocess-stage2", "--input", inner, "--outer", S2_TINY["stage1_mesh_dir"]]
    assert _argv(rec, "eval-geometry")[0][:5] == [
        "eval-geometry", "--mesh", inner[:-4] + "_post.ply", "--gt",
        "datasets/nested_shell/gt_inner.npy"]
    for rel in ("data/model/nested_shell_s2b/model.ckpt",
                "data/model/nested_shell_s2b/model_best.ckpt",
                "data/eval/nested_shell_s2b/eval_test.json", "runs/leg_shell_stage2b.json",
                "runs/eval_shell_nested_shell_s2b.json", *rec["meshes"].values()):
        assert os.path.exists(os.path.join(work, rel)), rel
    train = rec["commands"][0]
    assert train["budget_s"] == 600 and not train["paused"]
    ev = rec["eval_images"]["nested_shell_s2b"]
    assert ev["step"] == 2 and ev["views"] == 2 and np.isfinite(ev["mean_psnr"])
    assert np.isfinite(rec["eval_shell"]["learned_ior"])


def test_gated_shell_stage2b_holds_the_absorption_that_shell_stage2_trains(
        shell_legs, shell_stage2b):
    """Two steps are before ``freeze_absorption_step``: the gated leg's
    absorption is its init to the bit, while ``shell_stage2``'s (no gate)
    has moved; ``eval_shell`` reports each."""
    from nunerf_tpu_torch.train.trainer import load_checkpoint

    raw = {}
    for name, work in (("nested_shell_s2", shell_legs[0]), ("nested_shell_s2b",
                                                           shell_stage2b[0])):
        _, params, opt, _ = load_checkpoint(os.path.join(work, "data/model", name,
                                                         "model.ckpt"))
        assert opt["count"] == 2
        raw[name] = np.asarray(params["train"]["absorption"])
    np.testing.assert_array_equal(raw["nested_shell_s2b"], np.full(3, -2.0, np.float32))
    assert (raw["nested_shell_s2"] != -2.0).all()
    init = float(torch.nn.functional.softplus(torch.tensor(-2.0)))
    assert shell_stage2b[1]["eval_shell"]["learned_kappa"] == pytest.approx([init] * 3,
                                                                           rel=1e-6)


def test_every_leg_runs_end_to_end_in_a_test():
    """Each leg of ``pipeline.LEGS`` is run through ``run_leg`` by some test
    file of the port: a leg added without such a run fails here."""
    import glob

    ran = set()
    for path in glob.glob(os.path.join(ROOT, "tests", "test_torch_port_*.py")):
        with open(path) as f:
            ran |= set(re.findall(r"""run_leg\(\s*["'](\w+)["']""", f.read()))
    assert sorted(set(pl.LEGS) - ran) == []


def test_leg_geometry_keeps_each_checkpoint_the_trainer_writes(shell_legs):
    from nunerf_tpu_torch.train.trainer import Trainer, load_checkpoint

    work, _, _, _, kept = shell_legs
    assert sorted(kept) == [2, 4]
    assert [load_checkpoint(kept[s])[0] for s in (2, 4)] == [2, 4]
    with open(kept[4], "rb") as a, open(
            os.path.join(work, "data/model/nested_shell/model.ckpt"), "rb") as b:
        assert a.read() == b.read()
    assert Trainer.save.__name__ == "save"  # put back on leaving


def test_leg_geometry_reports_the_loop_from_the_train_log(shell_legs, tmp_path):
    """The trainer logs its wall ms a step beside rays/s; the report takes
    its medians, or, from a log without them, rays/s and the rays a step
    the renderer resolves."""
    import yaml

    work, _, _, _, _ = shell_legs
    with open(os.path.join(work, pl.S1_SHELL)) as f:
        cfg = yaml.safe_load(f)
    log = os.path.join(work, "data/model/nested_shell/train_log.jsonl")
    rep = leg_geometry.loop_report(cfg, log, "cpu")
    with open(log) as f:
        recs = [json.loads(line) for line in f]
    timed = [r for r in recs if r["prefix"] == "train" and r["rays_per_sec"] > 0]
    assert [r["step"] for r in timed] == [4] and rep["rays"] == 32
    assert timed[0]["step_ms"] * timed[0]["rays_per_sec"] / 1e3 == pytest.approx(32)
    assert rep["step_ms_median"] == {"1-1000": timed[0]["step_ms"]}
    assert rep["rays_per_sec_median"] == timed[0]["rays_per_sec"]
    assert list(rep["val"]) == [4] and np.isfinite(rep["val"][4]).all()
    old = tmp_path / "train_log.jsonl"
    old.write_text("".join(json.dumps({k: v for k, v in r.items() if k != "step_ms"}) + "\n"
                           for r in recs))
    again = leg_geometry.loop_report(cfg, str(old), "cpu")
    assert again["step_ms_median"]["1-1000"] == pytest.approx(timed[0]["step_ms"], rel=1e-9)


def test_leg_geometry_reports_the_shell_surface_and_its_curvature_sign(shell_legs, tmp_path):
    """``--leg shell_front``: the leg's outer mesh against the scene's outer
    sphere (the leg's own ``eval-geometry`` chamfer at the same samples),
    and the curvature sign the shell's stage 2 reads on the mesh its config
    traces: negative vertices after the config's smoothing, and the first
    trace's hits on the ``K < 0`` branch.  The curvature is the angle
    defect, which no winding signs: with the winding reversed the vertices'
    signs stay, and every hit, whose normal no longer opposes its ray,
    takes the other branch."""
    from nunerf_tpu_torch.tracing.mesh_ops import load_ply, save_ply
    from nunerf_tpu_torch.tracing.scene import Scene

    work, front, _, _, _ = shell_legs
    outer = front["meshes"]["outer"]
    out = leg_geometry.main([work, "--leg", "shell_front", "--mesh", outer, "--device", "cpu",
                             "--n-samples", "2000"])
    rep = out["meshes"][0]
    assert rep["mesh"] == outer
    assert rep["chamfer"] == pytest.approx(front["chamfer"]["outer"]["chamfer"], rel=1e-6)
    with open(os.path.join(work, "datasets/nested_shell/meta.json")) as f:
        assert rep["r_outer"] == json.load(f)["r_outer"]
    assert rep["pred_radius_pct"][1] <= rep["pred_radius_pct"][50] <= rep["pred_radius_pct"][99]
    cur = out["curvature"]
    # the tiny stage-2 config's mesh and smoothing; 2 test views of 16x16
    assert cur["mesh"] == S2_TINY["stage1_mesh_dir"] and cur["smooth_rings"] == 5
    assert cur["rays"] == 2 * 16 * 16 and cur["test_views"] == 2
    path = os.path.join(work, outer)
    scene = Scene(path, curv_smooth_iters=5, device="cpu")
    assert cur["vertices"] == scene.vertex_curvature.numel()
    assert cur["negative_vertices"] == int((scene.vertex_curvature < 0).sum())
    assert 0 < cur["hits"] <= cur["rays"] and 0 <= cur["negative_hits"] <= cur["hits"]
    assert cur["negative_hit_share"] == pytest.approx(cur["negative_hits"] / cur["hits"])

    verts, tris = load_ply(path)
    flipped = str(tmp_path / "flipped.ply")
    save_ply(flipped, verts, np.ascontiguousarray(tris[:, ::-1]))
    cfg = {"database_name": "nerf/nested_shell",
           "dataset_dir": os.path.join(work, "datasets")}
    again = leg_geometry.curvature_report(path, cfg, 5, "cpu")
    back = leg_geometry.curvature_report(flipped, cfg, 5, "cpu")
    assert {k: again[k] for k in again if k != "mesh"} == \
        {k: cur[k] for k in cur if k != "mesh"}
    assert back["negative_vertices"] == again["negative_vertices"]
    assert back["hits"] == again["hits"]
    assert back["negative_hits"] + again["negative_hits"] == again["hits"]


def test_a_child_is_stopped_right_after_a_save_when_the_next_is_past_its_budget(
        shell_legs, tmp_path, monkeypatch, capsys):
    """The injected child writes the stage-2 checkpoint anew after 0.3 s and
    2 s more, as the trainer does (``.tmp`` and ``os.replace``), and never
    ends; the next save, 2 s on, would land past the 4-s budget, so the leg
    stops the child right after the second save, before the budget, and
    goes on from that checkpoint."""
    from nunerf_tpu_torch.train.trainer import load_checkpoint

    work, _, _, _, _ = shell_legs
    rel = "data/model/nested_shell_s2/model.ckpt"
    step = load_checkpoint(os.path.join(work, rel))[0]
    monkeypatch.setattr(pl, "train_command", lambda cfg, device: [
        sys.executable, "-c",
        "import os, time\n"
        f"p = {rel!r}\n"
        "blob = open(p, 'rb').read()\n"
        "for wait in (0.3, 2.0):\n"
        "    time.sleep(wait)\n"
        "    open(p + '.tmp', 'wb').write(blob)\n"
        "    os.replace(p + '.tmp', p)\n"
        "time.sleep(600)\n"])
    monkeypatch.chdir(tmp_path)
    rec = pl.run_leg("shell_stage2", work, budget=4.0, **TINY)
    out = capsys.readouterr().out
    assert "stopped right after a save" in out and "paused at the budget" in out
    assert rec["commands"][0]["paused"] and rec["commands"][0]["s"] < 4.0
    assert rec["steps"]["nested_shell_s2"]["to"] == step
    assert rec["checkpoints"]["extract-mesh-stage2"] == step


def _log_without_clock(path):
    """A train log's records without the wall-clock fields."""
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    return [{k: v for k, v in r.items() if k not in ("rays_per_sec", "step_ms")}
            for r in recs]


def test_a_budgeted_leg_keeps_parameters_at_the_asked_steps_and_trains_the_same(
        shell_legs, tmp_path, monkeypatch):
    """``shell_stage2`` with ``keep`` in a copy of the legs' working
    directory without its stage-2 run: its ``train`` child writes the
    parameters alone, gzip'd, at steps 1 and 2, and its train log and final
    parameters equal those of the run without ``keep``."""
    import shutil

    from nunerf_tpu_torch.train.trainer import load_checkpoint

    work, _, _, _, _ = shell_legs
    copy = str(tmp_path / "work")
    shutil.copytree(work, copy, ignore=shutil.ignore_patterns("nested_shell_s2*"))
    assert not os.path.exists(os.path.join(copy, "data/model/nested_shell_s2"))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    rec = pl.run_leg("shell_stage2", copy, budget=600, keep=(1, 2), **TINY)
    run = os.path.join(copy, "data/model/nested_shell_s2")
    assert rec["kept"] == [os.path.join("data/model/nested_shell_s2", f"model_{s}.ckpt.gz")
                           for s in (1, 2)]
    assert "--keep" in rec["commands"][0]["argv"]
    ref = os.path.join(work, "data/model/nested_shell_s2")
    assert _log_without_clock(os.path.join(run, "train_log.jsonl")) == \
        _log_without_clock(os.path.join(ref, "train_log.jsonl"))
    step, params, opt, _ = load_checkpoint(os.path.join(run, "model_2.ckpt.gz"))
    assert step == 2 and opt is None
    _, want, _, _ = load_checkpoint(os.path.join(ref, "model.ckpt"))
    got, want = _flat(params), _flat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert load_checkpoint(os.path.join(run, "model_1.ckpt.gz"))[0] == 1


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_leg_geometry_seed_run_refuses_a_trained_workdir(tmp_path):
    ckpt = tmp_path / "data" / "model" / "nested" / "model.ckpt"
    ckpt.parent.mkdir(parents=True)
    ckpt.write_bytes(b"")
    with pytest.raises(ValueError, match="would resume it"):
        leg_geometry.seed_run(str(tmp_path), 7, 5000, "cpu")
    assert sorted(os.listdir(tmp_path)) == ["data"]


@pytest.mark.parametrize("f32", [False, True])
def test_leg_geometry_seed_run_trains_the_front_leg_in_the_precision_asked(tmp_path,
                                                                        monkeypatch, f32):
    """The seed run's overrides: the seed and a checkpoint every 1,000 steps,
    and with ``f32`` both bf16 switches off; nothing else of the config."""
    seen = {}

    def run_leg(leg, workdir, device, cfg_overrides):
        seen.update(leg=leg, workdir=workdir, device=device, over=cfg_overrides)
        return {"steps": {"nested": {"from": 0, "to": 30000}}}

    monkeypatch.setattr(pl, "run_leg", run_leg)
    rec, kept = leg_geometry.seed_run(str(tmp_path), 7, 5000, "cpu", f32=f32)
    assert rec["steps"]["nested"]["from"] == 0 and kept == {}
    assert seen["leg"] == "front" and seen["workdir"] == str(tmp_path)
    want = dict(random_seed=7, save_interval=1000)
    if f32:
        want.update(mixed_precision=False, sdf_mixed_precision=False)
    assert seen["over"] == {pl.S1_NESTED: want}
    for flags in (["--train-f32"], ["--keep", "20500"], ["--stop-step", "22000"],
                  ["--set", "outer_reg_loss_weight=0"], ["--resume", "model.ckpt"]):
        with pytest.raises(SystemExit):
            leg_geometry.main([str(tmp_path), *flags, "--device", "cpu"])


def test_leg_geometry_seed_run_keeps_stops_resumes_and_sets(tmp_path, monkeypatch):
    """A seed run that keeps checkpoints off the 1,000s checkpoints every
    500 steps, ends at ``stop`` (``total_step``), goes on from a checkpoint
    copied into its working directory, and sets the config keys given; the
    copies are made at ``every``'s multiples and at ``keep``'s steps."""
    from nunerf_tpu_torch.train.trainer import Trainer, load_checkpoint, save_checkpoint

    src = str(tmp_path / "model_20000.ckpt")
    save_checkpoint(src, 20000, {"a": np.zeros(2, np.float32)}, None, 0.0)
    work = tmp_path / "w"
    seen = {}

    def run_leg(leg, workdir, device, cfg_overrides):
        seen.update(over=cfg_overrides,
                    start=load_checkpoint(os.path.join(workdir,
                                                       "data/model/nested/model.ckpt"))[0])
        # the trainer's saves, as the kept-checkpoint hook sees them
        class Rank0(Trainer):
            writes = True

        tr = Rank0.__new__(Rank0)
        tr.ckpt_path = os.path.join(workdir, "data/model/nested/model.ckpt")
        tr.params_tree = lambda: {"a": np.zeros(2, np.float32)}
        tr.opt_state_tree = lambda: None
        tr.rng_state = lambda: None
        for step in (20500, 21000, 21500, 22000):
            tr.save(tr.ckpt_path, step, 0.0)
        return {"steps": {"nested": {"from": 20000, "to": 22000}}}

    monkeypatch.setattr(pl, "run_leg", run_leg)
    rec, kept = leg_geometry.seed_run(str(work), 6033, 2000, "cpu", f32=True,
                                      keep=(20500, 21000), stop=22000, resume=src,
                                      extra={"outer_reg_loss_weight": 0})
    assert seen["start"] == 20000
    assert seen["over"] == {pl.S1_NESTED: dict(
        random_seed=6033, save_interval=500, total_step=22000, mixed_precision=False,
        sdf_mixed_precision=False, outer_reg_loss_weight=0)}
    assert sorted(kept) == [20500, 21000, 22000]
    assert [load_checkpoint(kept[s])[0] for s in sorted(kept)] == [20500, 21000, 22000]
    with pytest.raises(ValueError, match="would resume it"):
        leg_geometry.seed_run(str(work), 6033, 2000, "cpu", resume=src)


def test_a_child_past_its_budget_is_a_pause(shell_legs, tmp_path, monkeypatch, capsys):
    """The injected child outlives any budget; the leg goes on from the
    checkpoint that is there (moved to step 3 here), so its inner mesh is
    named from step 3."""
    from nunerf_tpu_torch.train.trainer import load_checkpoint, save_checkpoint

    work, _, _, _, _ = shell_legs
    ckpt = os.path.join(work, "data/model/nested_shell_s2/model.ckpt")
    _, params, opt_state, best = load_checkpoint(ckpt)
    save_checkpoint(ckpt, 3, params, opt_state, best)
    monkeypatch.setattr(pl, "train_command", lambda cfg, device: [
        sys.executable, "-c", "import time; time.sleep(600)"])
    monkeypatch.chdir(tmp_path)
    rec = pl.run_leg("shell_stage2", work, budget=0.5, **TINY)
    assert rec["steps"]["nested_shell_s2"] == {"from": 3, "to": 3, "total_step": 2,
                                               "paused": True}
    assert rec["commands"][0]["paused"] and rec["commands"][0]["s"] < 60
    assert rec["meshes"]["inner"] == "data/meshes/nested_shell_s2-3-inner.ply"
    assert rec["checkpoints"]["extract-mesh-stage2"] == 3
    assert "paused at the budget" in capsys.readouterr().out


def test_a_failed_child_stops_the_leg(shell_legs, tmp_path, monkeypatch):
    work, _, _, _, _ = shell_legs
    monkeypatch.setattr(pl, "train_command", lambda cfg, device: [
        sys.executable, "-c", "raise SystemExit(3)"])
    monkeypatch.chdir(tmp_path)
    with pytest.raises(pl.LegError, match="exited with 3"):
        pl.run_leg("shell_stage2", work, budget=600, **TINY)


def test_stage2_leg_stops_without_its_stage1_mesh(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    work = tmp_path / "work"
    (work / "data" / "meshes").mkdir(parents=True)
    (work / "data" / "meshes" / "nested-20000_simplified.ply").write_text("")
    with pytest.raises(pl.LegError) as e:
        pl.run_leg("stage2", str(work), budget=10, device="cpu")
    msg = str(e.value)
    assert "stage1_mesh_dir ./data/meshes/nested-30000_simplified.ply does not exist" in msg
    assert "data/meshes/nested-20000_simplified.ply" in msg
    # nothing was trained, renamed or made in its place
    assert sorted(os.listdir(work / "data" / "meshes")) == ["nested-20000_simplified.ply"]
    assert not (work / "data" / "model").exists()


def test_stage2_leg_stops_without_its_stage1_checkpoint(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    work = tmp_path / "work"
    mesh = work / "data" / "meshes" / "nested_shell-30000_simplified_outer.ply"
    mesh.parent.mkdir(parents=True)
    mesh.write_text("")
    with pytest.raises(pl.LegError,
                       match="stage1_ckpt_dir ./data/model/nested_shell/model_best.ckpt"):
        pl.run_leg("shell_stage2", str(work), budget=10, device="cpu")


def test_runner_refuses_the_repo_root_and_bad_arguments(tmp_path):
    with pytest.raises(ValueError, match="root"):
        pl.run_leg("front", ROOT, device="cpu")
    with pytest.raises(ValueError, match="budget"):
        pl.run_leg("stage2", str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="unknown leg"):
        pl.run_leg("back", str(tmp_path), device="cpu")
    with pytest.raises(SystemExit):
        pl.main(["shell_stage2", "--workdir", str(tmp_path), "--device", "cpu"])
    assert not os.listdir(tmp_path)


def test_runner_offers_every_leg_of_the_script():
    with open(os.path.join(ROOT, "tools", "run_nested_pipeline.sh")) as f:
        script = f.read()
    bodies = dict(re.findall(r"^(\w+)\(\) \{\n(.*?)^\}", script, flags=re.M | re.S))
    assert sorted(pl.LEGS) == sorted(bodies)
    # a leg takes a budget where its body reads one, or hands its own on
    budgeted = {name for name, body in bodies.items() if "${1:?" in body or '"$1"' in body}
    assert sorted(pl.BUDGET_LEGS) == sorted(budgeted)
    assert pl.DEFAULT_WORKDIR != ROOT
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert "/" + os.path.basename(pl.DEFAULT_WORKDIR) + "/" in f.read().split()
