"""The real-capture legs of the port's leg runner (``nunerf_tpu_torch.pipeline``)
end to end on the CPU, in one working directory: ``real_front``, then
``real_boot`` (twice: cut to 2 steps, then run again to 4, so that its
``train`` child resumes), then ``real_stage2``; then, on a copy of that
directory, ``real_boot_ext`` (the boot run resumed from 4 to 6 steps,
re-extracted and re-scored) and ``real_stage2_fresh`` (``real_stage2`` from
scratch, its run's directory removed first, on the extended boot's mesh).

The three configs are the repository's (``configs/shape/real/
nested_real.yaml``, ``nested_real_boot.yaml``, ``configs/stage2/real/
nested_real.yaml``) with depth, widths, samples, rays and the schedule's
length cut (``S1_TINY``, ``S2_TINY``) and the database's size set to the
tiny capture's 16 pixels (``custom/nested_real/16``, the boot's with its
``rawmask`` suffix); every other key stays.  The scene is ``synth-scene
--colmap --shell`` with 8 views of 16x16, so the test split of
``split_type: test`` holds one view.  ``real_stage2`` traces the mesh that
``real_boot`` wrote (``pipeline.boot_overrides``; the config names the
``-20000`` mesh, and without the override the leg stops at the guard), and
its ``train`` runs in a budgeted child that never reaches its budget.

Checked: every artifact of the three legs and the names handed on; the
prior masks that ``real_boot`` renders from the silhouette hull are the
same bytes on its second run; the resumed boot run is the run never
stopped (parameters, Adam's state and the draws equal to one uninterrupted
``Trainer`` on the same masks: the checkpoint carries the trainer's
draws); a budgeted ``real_boot`` whose child is stopped right after a save
ends the leg there, and a budget is refused where a leg takes none.
"""

import contextlib
import io
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from leg_script import assert_runs_script
from nunerf_tpu_torch import pipeline as pl

S1_TINY = dict(n_samples=8, n_importance=8, up_sample_steps=2, n_bg_samples=4,
               n_front_samples=2, n_back_samples=2, sdf_n_layers=4, train_ray_num=32,
               test_ray_num=64, mixed_precision=False, sdf_mixed_precision=False,
               total_step=4, train_log_step=1, val_interval=4, save_interval=2)
BOOT_MESH = "./data/meshes/nested_real_boot-4_simplified_outer.ply"
S2_TINY = dict(sdf_n_layers=4, n_samples_outer=8, n_samples_inner=4, inner_up_rounds=1,
               inner_up_each=4, curv_smooth_iters=5, mixed_precision=False,
               sdf_mixed_precision=False, train_ray_num=16, test_ray_num=64, total_step=2,
               train_log_step=1, save_interval=2, val_interval=2,
               database_name="custom/nested_real/16")
EXTRA = {"synth-scene": ["--n-train", "8", "--size", "16"],
         "extract-mesh-stage1": ["--resolution", "16"],
         "extract-mesh-stage2": ["--resolution", "16"],
         "postprocess-outer": ["--views", "4"],
         "eval-geometry": ["--n-samples", "2000"]}
BOOT_RUN = "data/model/nested_real_boot"
VIEWS = 8


def _overrides(boot_steps=4, **s2):
    return {pl.S1_REAL: dict(S1_TINY, database_name="custom/nested_real/16"),
            pl.S1_BOOT: dict(S1_TINY, database_name="custom/nested_real/16/rawmask",
                             total_step=boot_steps),
            pl.S2_REAL: dict(S2_TINY, **s2)}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mask_bytes(work, sub):
    root = os.path.join(work, "datasets/nested_real", sub)
    return {n: open(os.path.join(root, n), "rb").read() for n in sorted(os.listdir(root))}


@pytest.fixture(scope="module")
def legs(tmp_path_factory):
    """The three legs in one working directory: (workdir, {leg or
    ``boot_2``: record}, the prior masks each ``real_boot`` trained on,
    the guard's message, printed lines)."""
    home = tmp_path_factory.mktemp("real_legs")
    work = str(home / "work")
    buf, priors, recs = io.StringIO(), [], {}
    real_train = pl._Leg.train

    def train(leg, rel, budget=None):
        if rel == pl.S1_BOOT:  # the masks the boot pass trains on
            priors.append(_mask_bytes(work, "mask"))
        return real_train(leg, rel, budget)

    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(buf):
        mp.chdir(home)
        mp.setenv("OMP_NUM_THREADS", "1")  # the budgeted children
        mp.setattr(pl._Leg, "train", train)
        run = dict(device="cpu", extra_args=EXTRA)
        recs["real_front"] = pl.run_leg("real_front", work, cfg_overrides=_overrides(), **run)
        recs["boot_2"] = pl.run_leg("real_boot", work, budget=600,
                                    cfg_overrides=_overrides(boot_steps=2), **run)
        recs["real_boot"] = pl.run_leg("real_boot", work, budget=600,
                                       cfg_overrides=_overrides(), **run)
        with pytest.raises(pl.LegError) as guard:
            pl.run_leg("real_stage2", work, budget=600, cfg_overrides=_overrides(), **run)
        over = pl.boot_overrides(work)
        recs["real_stage2"] = pl.run_leg("real_stage2", work, budget=600,
                                         cfg_overrides=_overrides(**over[pl.S2_REAL]), **run)
    return work, recs, priors, str(guard.value), buf.getvalue().splitlines()


@pytest.fixture(scope="module")
def ext_legs(legs, tmp_path_factory):
    """``real_boot_ext`` (the boot config cut to 6 steps) then
    ``real_stage2_fresh`` on its mesh, in a copy of the legs' working
    directory: (workdir, {leg: record})."""
    home = tmp_path_factory.mktemp("real_ext")
    work = str(home / "work")
    shutil.copytree(legs[0], work)
    recs = {}
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(io.StringIO()):
        mp.chdir(home)
        mp.setenv("OMP_NUM_THREADS", "1")  # the budgeted child
        run = dict(device="cpu", extra_args=EXTRA)
        recs["real_boot_ext"] = pl.run_leg("real_boot_ext", work, **run,
                                           cfg_overrides=_overrides(boot_steps=6))
        mesh = "./" + recs["real_boot_ext"]["meshes"]["outer"]
        recs["real_stage2_fresh"] = pl.run_leg(
            "real_stage2_fresh", work, budget=600, **run,
            cfg_overrides=_overrides(boot_steps=6, stage1_mesh_dir=mesh))
    return work, recs


def _commands(rec):
    return [c["command"] for c in rec["commands"]]


def _argv(rec, command):
    return [c["argv"] for c in rec["commands"] if c["command"] == command]


def _masks_are_binary(work, sub):
    from nunerf_tpu_torch.data.image_io import imread

    root = os.path.join(work, "datasets/nested_real", sub)
    names = sorted(os.listdir(root))
    assert len(names) == VIEWS, names
    for n in names:
        assert set(np.unique(imread(os.path.join(root, n)))) <= {0, 255}, n


def test_real_front_trains_extracts_and_writes_the_masks(legs):
    work, recs, _, _, _ = legs
    rec = recs["real_front"]
    assert _commands(rec) == ["synth-scene", "train", "extract-mesh-stage1",
                              "postprocess-outer", "eval-geometry", "render-mask",
                              "mask-erosion"]
    assert _argv(rec, "synth-scene")[0][:7] == ["synth-scene", "--output",
                                               "./datasets/nested_real", *pl.REAL_SCENE_ARGS]
    assert rec["steps"] == {"nested_real": {"from": 0, "to": 4, "total_step": 4,
                                            "paused": False}}
    assert rec["meshes"] == {"stage1": "data/meshes/nested_real-4_simplified.ply",
                             "outer": "data/meshes/nested_real-4_simplified_outer.ply"}
    assert _argv(rec, "extract-mesh-stage1")[0][3:5] == ["--resolution", "384"]
    assert _argv(rec, "render-mask")[0][-1] == rec["meshes"]["outer"]
    assert np.isfinite(rec["chamfer"]["outer"]["chamfer"])
    for rel in ("data/model/nested_real/model.ckpt", "runs/leg_real_front.json",
                *rec["meshes"].values()):
        assert os.path.exists(os.path.join(work, rel)), rel
    _masks_are_binary(work, "mask_erosion")


def test_real_boot_renders_the_same_prior_masks_on_each_run(legs):
    work, recs, priors, _, _ = legs
    assert len(priors) == 2 and len(priors[0]) == VIEWS
    assert priors[0] == priors[1]
    for rec in (recs["boot_2"], recs["real_boot"]):
        assert _commands(rec)[:3] == ["silhouette-prior", "render-mask", "train"]
        assert _argv(rec, "render-mask")[0][-1] == "data/meshes/nested_real_silhouette.ply"
    # the boot's own masks replaced the prior ones after its mesh
    assert _mask_bytes(work, "mask") != priors[0]
    _masks_are_binary(work, "mask")
    _masks_are_binary(work, "mask_erosion")


def test_real_boot_resumed_is_the_run_never_stopped(legs, tmp_path, monkeypatch):
    """The second ``real_boot`` resumes its child from the first's step-2
    checkpoint; one ``Trainer`` straight to 4 on the same prior masks ends
    with the same parameters, Adam's state and draws."""
    from nunerf_tpu_torch.config import load_cfg
    from nunerf_tpu_torch.train import trainer as ttrainer

    work, recs, priors, _, _ = legs
    assert recs["boot_2"]["steps"]["nested_real_boot"] == {
        "from": 0, "to": 2, "total_step": 2, "paused": False}
    assert recs["real_boot"]["steps"]["nested_real_boot"] == {
        "from": 2, "to": 4, "total_step": 4, "paused": False}
    data = tmp_path / "datasets"
    shutil.copytree(os.path.join(work, "datasets"), data)
    for name, blob in priors[0].items():
        (data / "nested_real" / "mask" / name).write_bytes(blob)
    cfg = load_cfg(os.path.join(work, pl.S1_BOOT))
    cfg.update(dataset_dir=str(data), model_dir=str(tmp_path / "model"))
    monkeypatch.chdir(tmp_path)  # the validation images
    with contextlib.redirect_stdout(io.StringIO()):
        straight = ttrainer.Trainer(cfg, device="cpu")
        straight.run()
        straight.logger.close()
    step, params, opt, _ = ttrainer.load_checkpoint(os.path.join(work, BOOT_RUN, "model.ckpt"))
    blob = ttrainer._read_blob(os.path.join(work, BOOT_RUN, "model.ckpt"))
    want = ttrainer._read_blob(os.path.join(straight.model_dir, "model.ckpt"))
    assert step == want["step"] == 4
    from nunerf_tpu_torch.convert import flat_leaves

    for key, tree in (("params", params), ("exp_avg", opt["exp_avg"]),
                      ("exp_avg_sq", opt["exp_avg_sq"])):
        other = want["params"] if key == "params" else want["opt_state"][key]
        a, b = flat_leaves(tree), flat_leaves(other)
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{key} {k}")
    for k in ("index", "renderer"):
        np.testing.assert_array_equal(blob["rng"][k], want["rng"][k], err_msg=k)
    with open(os.path.join(work, BOOT_RUN, "train_log.jsonl")) as f:
        logs = [json.loads(x) for x in f]
    train = [r for r in logs if r["prefix"] == "train"]
    assert [r["step"] for r in train] == [1, 2, 3, 4]


def test_real_boot_leaves_its_mesh_masks_and_test_scores(legs):
    work, recs, _, _, _ = legs
    rec = recs["real_boot"]
    assert _commands(rec) == ["silhouette-prior", "render-mask", "train",
                              "extract-mesh-stage1", "postprocess-outer", "eval-geometry",
                              "render-mask", "mask-erosion", "eval-images"]
    assert rec["meshes"] == {"stage1": "data/meshes/nested_real_boot-4_simplified.ply",
                             "outer": BOOT_MESH[2:]}
    assert _argv(rec, "render-mask")[1][2:] == [pl.S1_BOOT, "--mesh_path", BOOT_MESH[2:]]
    assert _argv(rec, "eval-images")[0][-2:] == ["--ckpt", f"{BOOT_RUN}/model.ckpt"]
    ev = rec["eval_images"]["nested_real_boot"]
    assert ev["step"] == 4 and ev["views"] == max(1, VIEWS // 8)
    assert np.isfinite(ev["mean_psnr"]) and 0 < ev["mean_ssim"] <= 1
    assert np.isfinite(rec["chamfer"]["outer"]["chamfer"])
    # the child ran the plain versions: no kernel launched, no card memory
    assert not any(rec["train_child"]["launches"].values())
    assert rec["train_child"]["max_memory_allocated"] is None
    for rel in (BOOT_MESH, "data/meshes/nested_real_silhouette.ply",
                "data/eval/nested_real_boot/eval_test.json", "runs/leg_real_boot.json"):
        assert os.path.exists(os.path.join(work, rel)), rel


def test_real_stage2_stops_at_the_guard_without_the_boot_mesh(legs):
    _, _, _, guard, _ = legs
    assert "stage1_mesh_dir ./data/meshes/nested_real_boot-20000_simplified_outer.ply" in guard
    assert BOOT_MESH[2:] in guard


def test_real_stage2_traces_the_mesh_and_checkpoint_real_boot_wrote(legs):
    import yaml

    work, recs, _, _, printed = legs
    rec = recs["real_stage2"]
    assert pl.boot_overrides(work) == {pl.S2_REAL: {"stage1_mesh_dir": BOOT_MESH}}
    assert rec["stage1"] == {"mesh": BOOT_MESH, "ckpt": f"./{BOOT_RUN}/model.ckpt",
                             "ckpt_step": 4}
    with open(os.path.join(work, pl.S2_REAL)) as f:
        s2 = yaml.safe_load(f)
    assert s2["stage1_cfg_dir"] == "./" + pl.S1_BOOT and s2["get_mask"]
    assert _commands(rec) == ["train", "eval_shell", "extract-mesh-stage2",
                              "postprocess-stage2", "eval-geometry", "eval-images"]
    assert _argv(rec, "postprocess-stage2")[0][-2:] == ["--outer", BOOT_MESH]
    assert rec["steps"]["nested_real_s2"] == {"from": 0, "to": 2, "total_step": 2,
                                              "paused": False}
    shell = rec["eval_shell"]
    for key in ("learned_ior", "learned_thickness"):
        assert np.isfinite(shell[key])
    assert len(shell["learned_kappa"]) == 3
    assert np.isfinite(rec["chamfer"]["inner"]["chamfer"])
    ev = rec["eval_images"]["nested_real_s2"]
    assert ev["step"] == 2 and ev["views"] == 1 and np.isfinite(ev["mean_psnr"])
    assert printed[-1] == json.dumps(rec)


def test_a_paused_real_boot_ends_the_leg_after_its_save(legs, tmp_path, monkeypatch, capsys):
    """An injected child writes the boot checkpoint anew (moved to step 5)
    after 0.3 s and 2 s more and never ends; the next save would land past
    the 4-s budget, so the leg stops it right after the second and ends
    there, with no mesh and no scores."""
    from nunerf_tpu_torch.train.trainer import load_checkpoint, save_checkpoint

    work = str(tmp_path / "work")
    shutil.copytree(legs[0], work)
    rel = f"{BOOT_RUN}/model.ckpt"
    blob = str(tmp_path / "model.ckpt")
    _, params, opt_state, best = load_checkpoint(os.path.join(work, rel))
    save_checkpoint(blob, 5, params, opt_state, best)
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
    rec = pl.run_leg("real_boot", work, budget=4.0, device="cpu", extra_args=EXTRA,
                     cfg_overrides=_overrides(boot_steps=8))
    out = capsys.readouterr().out
    assert "stopped right after a save" in out and "real_boot: paused" in out
    assert rec["steps"]["nested_real_boot"] == {"from": 4, "to": 5, "total_step": 8,
                                                "paused": True}
    assert _commands(rec) == ["silhouette-prior", "render-mask", "train"]
    assert rec["meshes"] == {} and rec["eval_images"] == {}
    with pytest.raises(pl.LegError, match="paused before its mesh"):
        pl.boot_overrides(work)


@pytest.mark.parametrize("leg", ["real_front", "real_boot", "real_stage2"])
def test_real_legs_run_the_subcommands_of_their_script_bodies(legs, leg):
    assert_runs_script(legs[1][leg])


def test_real_boot_ext_resumes_the_boot_run_and_scores_its_new_mesh(ext_legs):
    work, recs = ext_legs
    rec = recs["real_boot_ext"]
    assert_runs_script(rec)
    # the boot run goes on from the real_boot leg's 4 steps to the extended 6
    assert rec["steps"] == {"nested_real_boot": {"from": 4, "to": 6, "total_step": 6,
                                                 "paused": False}}
    outer = "data/meshes/nested_real_boot-6_simplified_outer.ply"
    assert rec["meshes"] == {"stage1": "data/meshes/nested_real_boot-6_simplified.ply",
                             "outer": outer}
    assert rec["checkpoints"] == {"extract-mesh-stage1": 6}
    assert _argv(rec, "postprocess-outer")[0][:3] == [
        "postprocess-outer", "--input", rec["meshes"]["stage1"]]
    assert _argv(rec, "eval-geometry")[0][:5] == [
        "eval-geometry", "--mesh", outer, "--gt", "datasets/nested_real/gt_outer.npy"]
    assert np.isfinite(rec["chamfer"]["outer"]["chamfer"])
    ev = rec["eval_images"]["nested_real_boot"]
    assert ev["step"] == 6 and np.isfinite(ev["mean_psnr"])
    with open(os.path.join(work, BOOT_RUN, "train_log.jsonl")) as f:
        logs = [json.loads(x) for x in f]
    assert [r["step"] for r in logs if r["prefix"] == "train"] == [1, 2, 3, 4, 5, 6]
    # the boot leg's mesh stays beside the extension's
    assert os.path.exists(os.path.join(work, BOOT_MESH))


def test_real_stage2_fresh_trains_from_scratch_on_the_extended_mesh(ext_legs):
    work, recs = ext_legs
    rec = recs["real_stage2_fresh"]
    assert_runs_script(rec)
    outer = "./" + recs["real_boot_ext"]["meshes"]["outer"]
    assert rec["stage1"] == {"mesh": outer, "ckpt": f"./{BOOT_RUN}/model.ckpt",
                             "ckpt_step": 6}
    # real_stage2's run (2 steps) was removed first: from 0 again, one log
    assert rec["steps"]["nested_real_s2"] == {"from": 0, "to": 2, "total_step": 2,
                                              "paused": False}
    with open(os.path.join(work, "data/model/nested_real_s2/train_log.jsonl")) as f:
        logs = [json.loads(x) for x in f]
    assert [r["step"] for r in logs if r["prefix"] == "train"] == [1, 2]
    assert _argv(rec, "postprocess-stage2")[0][-2:] == ["--outer", outer]
    assert rec["meshes"]["inner"] == "data/meshes/nested_real_s2-2-inner.ply"
    assert np.isfinite(rec["eval_shell"]["learned_ior"])
    ev = rec["eval_images"]["nested_real_s2"]
    assert ev["step"] == 2 and np.isfinite(ev["mean_psnr"])


@pytest.mark.parametrize("leg", ["real_front", "front", "shell_front"])
def test_a_budget_is_refused_where_a_leg_takes_none(tmp_path, leg):
    with pytest.raises(ValueError, match="takes no budget"):
        pl.run_leg(leg, str(tmp_path), budget=10, device="cpu")
    assert not os.listdir(tmp_path)
