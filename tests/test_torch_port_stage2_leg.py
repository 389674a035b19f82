"""The zero-thickness nested ``stage2`` leg of the port's leg runner
(``nunerf_tpu_torch.pipeline``) end to end on the CPU, after the ``front``
leg, in one working directory; and the ``res1024`` leg on a copy of the
``front`` leg's directory.

``front`` trains ``configs/shape/nerf/nested.yaml`` cut to 4 steps (so its
mesh is ``nested-4_simplified.ply``, not the config's ``-30000``), then
``stage2`` reads that mesh through ``cfg_overrides`` (as ``chip_smoke.py``'s
``phase_pipeline_stage2`` does on the card) and trains
``configs/stage2/nerf/nested.yaml`` cut to 2 steps in a budgeted child that
never reaches its 600-s budget, then extracts, post-processes and scores
its inner mesh and renders the test split.  Depth, widths, samples, rays
and the scene are tiny (``S1_TINY``, ``S2_TINY``: 16x16 views); every other
key of both configs is the repository's.  One run of both legs is shared
by the cases (``legs``); the budget pause runs its own injected child on
the leg's zero-thickness checkpoint.

``res1024`` runs the reference's extraction contract: ``extract-mesh-stage1
--resolution 1024 --tag r1024`` of the ``front`` leg's last checkpoint (the
test's later ``--resolution 16`` wins, as the other legs' 512 does), then
``render-mask`` on the raw mesh, not the remeshed one.  Its masks go to the
scene's ``mask/``, which the databases read, so it runs on a copy of the
directory that ``stage2`` trains in.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from leg_script import assert_runs_script
from nunerf_tpu_torch import pipeline as pl

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S1_TINY = dict(n_samples=8, n_importance=8, up_sample_steps=2, n_bg_samples=4,
               n_front_samples=2, n_back_samples=2, sdf_n_layers=4, train_ray_num=32,
               test_ray_num=64, mixed_precision=False, sdf_mixed_precision=False,
               total_step=4, train_log_step=2, val_interval=4, save_interval=2)
MESH = "./data/meshes/nested-4_simplified.ply"
S2_TINY = dict(sdf_n_layers=4, n_samples_outer=8, n_samples_inner=4, inner_up_rounds=1,
               inner_up_each=4, mixed_precision=False, sdf_mixed_precision=False,
               train_ray_num=16, test_ray_num=64, total_step=2, train_log_step=1,
               save_interval=2, val_interval=2, stage1_mesh_dir=MESH)
TINY = dict(device="cpu", cfg_overrides={pl.S1_NESTED: S1_TINY, pl.S2_NESTED: S2_TINY},
            extra_args={"synth-scene": ["--n-train", "4", "--n-test", "2", "--size", "16"],
                        "extract-mesh-stage1": ["--resolution", "16"],
                        "extract-mesh-stage2": ["--resolution", "16"],
                        "eval-geometry": ["--n-samples", "2000"]})
RUN = "data/model/nested_s2"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def legs(tmp_path_factory):
    """``front`` then ``stage2`` (a 600-s budget, never reached) in one
    working directory; returns (workdir, front record, stage-2 record,
    printed lines)."""
    import contextlib
    import io

    home = tmp_path_factory.mktemp("nested_legs")
    work = str(home / "work")
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(buf):
        mp.chdir(home)
        mp.setenv("OMP_NUM_THREADS", "1")  # the budgeted child
        front = pl.run_leg("front", work, **TINY)
        stage2 = pl.run_leg("stage2", work, budget=600, **TINY)
    return work, front, stage2, buf.getvalue().splitlines()


def _argv(record, command):
    return [c["argv"] for c in record["commands"] if c["command"] == command]


def test_stage2_traces_the_mesh_the_front_leg_named_from_its_checkpoint(legs):
    import yaml

    work, front, stage2, _ = legs
    assert front["steps"] == {"nested": {"from": 0, "to": 4, "total_step": 4,
                                         "paused": False}}
    assert front["meshes"] == {"stage1": MESH[2:]}
    with open(os.path.join(work, pl.S2_NESTED)) as f:
        s2 = yaml.safe_load(f)
    # the leg's stage-1 inputs: the chained mesh, the front leg's best
    # checkpoint and the stage-1 config it trained, all in the workdir
    assert s2["stage1_mesh_dir"] == MESH
    assert s2["stage1_ckpt_dir"] == "./data/model/nested/model_best.ckpt"
    assert s2["stage1_cfg_dir"] == "./configs/shape/nerf/nested.yaml"
    with open(os.path.join(ROOT, pl.S2_NESTED)) as f:
        assert s2 == dict(yaml.safe_load(f), **S2_TINY)
    assert [c["command"] for c in stage2["commands"]] == [
        "train", "extract-mesh-stage2", "postprocess-stage2", "eval-geometry", "eval-images"]
    inner = "data/meshes/nested_s2-2-inner.ply"
    assert stage2["meshes"] == {"inner": inner, "inner_post": inner[:-4] + "_post.ply"}
    assert _argv(stage2, "postprocess-stage2") == [
        ["postprocess-stage2", "--input", inner, "--outer", MESH]]
    assert _argv(stage2, "eval-geometry")[0][:5] == [
        "eval-geometry", "--mesh", inner[:-4] + "_post.ply", "--gt",
        "datasets/nested/gt_inner.npy"]
    assert _argv(stage2, "extract-mesh-stage2")[0][3:5] == ["--resolution", "256"]
    train = stage2["commands"][0]
    assert train["argv"][2:5] == ["--cfg", pl.S2_NESTED, "--device"]
    assert train["budget_s"] == 600 and not train["paused"]
    # the child's own record of what it ran: on the CPU the plain versions,
    # so no kernel launched and no card memory
    child = stage2["train_child"]
    assert child["max_memory_allocated"] is None
    assert sorted(child["launches"]) == ["chain_bwd", "chain_fwd", "chain_jac_bwd",
                                         "chain_jac_fwd", "closest_hit", "cull_bin"]
    assert not any(child["launches"].values())
    assert not [n for n in os.listdir(os.path.join(work, "runs")) if n.startswith("launches")]


def test_stage2_leg_leaves_every_artifact_and_its_record(legs):
    from nunerf_tpu_torch.tracing.mesh_ops import load_ply
    from nunerf_tpu_torch.train.trainer import load_checkpoint

    work, _, stage2, printed = legs
    assert stage2["steps"] == {"nested_s2": {"from": 0, "to": 2, "total_step": 2,
                                             "paused": False}}
    assert stage2["checkpoints"] == {"extract-mesh-stage2": 2}
    for rel in (f"{RUN}/model.ckpt", f"{RUN}/model_best.ckpt", f"{RUN}/train_log.jsonl",
                *stage2["meshes"].values(), "data/eval/nested_s2/eval_test.json",
                "runs/leg_stage2.json"):
        assert os.path.exists(os.path.join(work, rel)), rel
    with open(os.path.join(work, "runs/leg_stage2.json")) as f:
        assert json.load(f) == json.loads(json.dumps(stage2))
    assert printed[-1] == json.dumps(stage2)
    # the zero-thickness tree, JAX's: the inner SDF, its shader and variance,
    # the IoR field and the vestigial fields JAX's tree keeps, no
    # absorption; stage 1 frozen beside it
    step, params, opt, _ = load_checkpoint(os.path.join(work, RUN, "model.ckpt"))
    assert step == 2 and opt["count"] == 2
    assert sorted(params["train"]) == ["ior", "ior_int", "iors_vec", "sdf_inner",
                                       "shade_inner", "thickness", "var_inner"]
    assert sorted(params) == ["frozen", "train"]
    with open(os.path.join(work, RUN, "train_log.jsonl")) as f:
        logs = [json.loads(line) for line in f]
    val = [r for r in logs if r["prefix"] == "val"]
    last = [r for r in logs if r["prefix"] == "train" and r["step"] == 2][0]
    assert [r["step"] for r in val] == [2] and np.isfinite(val[0]["psnr"])
    assert np.isfinite(last["loss_total"]) and last["ior_frozen"] == 1.0
    assert len(load_ply(os.path.join(work, stage2["meshes"]["inner_post"]))[1]) > 0
    geo = stage2["chamfer"]["inner"]
    assert np.isfinite(geo["chamfer"]) and geo["chamfer"] == pytest.approx(
        geo["pred_to_gt"] + geo["gt_to_pred"])
    ev = stage2["eval_images"]["nested_s2"]
    assert ev["step"] == 2 and ev["views"] == 2
    assert np.isfinite(ev["mean_psnr"]) and 0 < ev["mean_ssim"] <= 1


def test_stage2_child_is_stopped_right_after_a_save_of_its_checkpoint(
        legs, tmp_path, monkeypatch, capsys):
    """The injected child writes the leg's zero-thickness checkpoint anew
    (moved to step 3) after 0.3 s and 2 s more, as the trainer does
    (``.tmp`` and ``os.replace``), and never ends; the next save, 2 s on,
    would land past the 4-s budget, so the leg stops the child right after
    the second save, before the budget, and goes on from that checkpoint:
    its inner mesh is named from step 3."""
    from nunerf_tpu_torch.train.trainer import load_checkpoint, save_checkpoint

    work, _, _, _ = legs
    rel = f"{RUN}/model.ckpt"
    blob = os.path.join(str(tmp_path), "model.ckpt")
    _, params, opt_state, best = load_checkpoint(os.path.join(work, rel))
    save_checkpoint(blob, 3, params, opt_state, best)
    monkeypatch.setattr(pl, "train_command", lambda cfg, device: [
        sys.executable, "-c",
        "import os, time\n"
        f"p = {rel!r}\n"
        f"blob = open({blob!r}, 'rb').read()\n"
        "for wait in (0.3, 2.0):\n"
        "    time.sleep(wait)\n"
        "    open(p + '.tmp', 'wb').write(blob)\n"
        "    os.replace(p + '.tmp', p)\n"
        "time.sleep(600)\n"])
    monkeypatch.chdir(tmp_path)
    rec = pl.run_leg("stage2", work, budget=4.0, **TINY)
    out = capsys.readouterr().out
    assert "stopped right after a save" in out and "paused at the budget" in out
    assert rec["commands"][0]["paused"] and rec["commands"][0]["s"] < 4.0
    assert rec["steps"]["nested_s2"] == {"from": 2, "to": 3, "total_step": 2,
                                         "paused": True}
    assert rec["checkpoints"]["extract-mesh-stage2"] == 3
    assert rec["meshes"]["inner"] == "data/meshes/nested_s2-3-inner.ply"
    assert "train_child" not in rec  # a stopped child records nothing
    assert np.isfinite(rec["eval_images"]["nested_s2"]["mean_psnr"])



@pytest.fixture(scope="module")
def res1024(legs, tmp_path_factory):
    """``res1024`` in a copy of the legs' working directory: (workdir,
    record)."""
    import contextlib
    import io
    import shutil

    home = tmp_path_factory.mktemp("res1024")
    work = str(home / "work")
    shutil.copytree(legs[0], work)
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(io.StringIO()):
        mp.chdir(home)
        rec = pl.run_leg("res1024", work, **TINY)
    return work, rec


@pytest.mark.parametrize("which", ["front", "stage2"])
def test_legs_run_the_subcommands_of_their_script_bodies(legs, which):
    assert_runs_script(legs[{"front": 1, "stage2": 2}[which]])


def test_res1024_extracts_the_tagged_mesh_of_the_last_checkpoint(res1024):
    from nunerf_tpu_torch.tracing.mesh_ops import load_ply

    work, rec = res1024
    assert_runs_script(rec)
    raw = "data/meshes/nested-4_r1024.ply"
    # the mesh named from the checkpoint's step (4, not the config's 30,000)
    # with the script's tag, so the front leg's meshes stay as they were
    assert rec["checkpoints"] == {"extract-mesh-stage1": 4}
    assert rec["meshes"] == {"raw": raw, "stage1": raw[:-4] + "_simplified.ply"}
    assert _argv(rec, "extract-mesh-stage1") == [[
        "extract-mesh-stage1", "--cfg", pl.S1_NESTED, "--resolution", "1024", "--tag",
        "r1024", "--resolution", "16"]]
    assert _argv(rec, "render-mask") == [["render-mask", "--cfg", pl.S1_NESTED,
                                          "--mesh_path", raw]]
    v, f = load_ply(os.path.join(work, raw))
    vs, fs = load_ply(os.path.join(work, rec["meshes"]["stage1"]))
    assert rec["mesh_counts"] == {"verts": len(v), "tris": len(f), "tris_simplified": len(fs)}
    assert len(f) > 0 and len(fs) > 0 and set(rec["extract_s1"]) == {
        "grid_s", "sweep_s", "march_s", "dedup_s", "write_s", "remesh_s"}
    for name in ("nested-4.ply", "nested-4_simplified.ply"):
        assert os.path.exists(os.path.join(work, "data/meshes", name)), name
    with open(os.path.join(work, "runs/leg_res1024.json")) as f:
        assert json.load(f) == json.loads(json.dumps(rec))


def test_res1024_masks_are_the_raw_meshs_hits_on_every_train_view(res1024):
    from nunerf_tpu_torch.data import image_io
    from nunerf_tpu_torch.data.database import parse_database_name
    from nunerf_tpu_torch.tools import render_mask as rm
    from nunerf_tpu_torch.tracing.scene import Scene

    work, rec = res1024
    db = parse_database_name("nerf/nested", os.path.join(work, "datasets"))
    ids = db.get_img_ids()
    written = [n for _, _, names in os.walk(os.path.join(db.root, "mask")) for n in names]
    assert len(written) == len(ids) >= 4
    scene = Scene(os.path.join(work, rec["meshes"]["raw"]), device="cpu")
    hits = 0
    for i in ids:
        got = image_io.imread(rm.mask_path(db.root, "mask", db.get_image_name(i)))
        o, d, h, w = rm.view_rays(db, i, True)
        np.testing.assert_array_equal(got, rm.hit_mask(scene, o, d, h, w), err_msg=i)
        hits += int((got == 255).sum())
    assert 0 < hits < len(ids) * 16 * 16
