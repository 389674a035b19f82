"""Where a stage-1 leg's surface lies: its checkpoints' meshes against the
synthetic scene's analytic outer sphere, through the port, on one GPU.

    python -m nunerf_tpu_torch.tools.leg_geometry WORKDIR \\
        --ckpt data/model/nested/model_best.ckpt [--ckpt ...] \\
        [--f32 data/model/nested/model.ckpt] [--test data/model/nested/model.ckpt]
    python -m nunerf_tpu_torch.tools.leg_geometry WORKDIR --seed 7 [--snapshot 5000] \\
        [--keep 20500,21000] [--stop-step 22000] [--train-f32] \\
        [--resume model_20000.ckpt] [--set outer_reg_loss_weight=0]
    python -m nunerf_tpu_torch.tools.leg_geometry WORKDIR --leg shell_front \\
        [--mesh data/meshes/nested_shell-30000_simplified_outer.ply] [--ckpt ...]

``WORKDIR`` is the working directory of a ``python -m nunerf_tpu_torch.pipeline
LEG`` leg, ``--leg`` ``front`` (the default: its derived
``configs/shape/nerf/nested.yaml``, its ``datasets/nested``) or
``shell_front`` (``nested_shell.yaml``, ``datasets/nested_shell``).  For
each ``--ckpt`` the tool runs the leg's ``extract-mesh-stage1`` at
``--resolution`` (512, tagged with the step), and for ``shell_front`` its
``postprocess-outer``, and reports for that mesh, and for each ``--mesh``
as it is, ``eval-geometry``'s chamfer against ``gt_outer.npy``, the medians
and upper percentiles of the nearest distances both ways on 100,000 points
a side (the chamfer's own samples), the share of points farther than 0.05,
and the percentiles of the mesh's radius (the sphere's is ``meta.json``'s
``r_outer``).  ``--f32`` does the same through the plain f32 chain
(``fused_sdf_value`` and ``sdf_mixed_precision`` off): the extraction's
precision set aside.  ``--test`` scores the test split at a checkpoint
(``eval-images``).  For ``shell_front`` the tool also counts the sign of
the curvature that the shell's stage 2 branches on
(``models/stage2_shell.py``, ``ray_trace``), on the outer mesh its config
traces (``stage1_mesh_dir`` of ``configs/stage2/nerf/nested_shell.yaml``
under ``WORKDIR``, else the repository's), after the ``Scene``'s
smoothing (20 rings for a shell): the vertices whose curvature is negative,
and, over every camera ray of the test views, the hits of the first trace
whose curvature, signed as the normal that opposes the ray, is negative
(the ``K < 0`` branch).  Where the working directory holds the leg's
``train_log.jsonl``, the tool also reports its run: every validation's
PSNR and SSIM, and the loop's median ms a step over steps 1-1,000 and each
10,000 after (from the logged ``step_ms``, or, in a log from before the
trainer logged it, from rays/s and the rays a step the renderer resolves),
with the median rays/s.

``--seed`` first runs the leg anew in ``WORKDIR`` with ``random_seed`` set
(other initial weights and ray draws) and checkpoints every 1,000 steps (the
training is the same: a checkpoint only reads the state), keeps a copy of
the checkpoint at every ``--snapshot`` steps and at each step of ``--keep``
as the trainer writes it (checkpointing every 500 steps where ``--keep``
asks for it), and then reports each copy as above: a second sound run's
trajectory.  ``--stop-step`` ends the run after the save at that step
(``total_step`` cut; the lr schedule ends at ``lr_cfg``'s ``end_iter``, so
the steps before it are the full run's).  ``--resume`` goes on from a
checkpoint of such a run (its draws start anew from the seed), and
``--set KEY=VALUE`` sets a key of the leg's config (a control run).  It
refuses a ``WORKDIR`` that holds the leg's checkpoint already, which the
leg would resume instead of training anew.  With ``--train-f32`` that run
trains in f32 (``mixed_precision`` and ``sdf_mixed_precision`` off).  Prints the card's name and power
limit first and one JSON object last, also written to
``WORKDIR/runs/leg_geometry.json``.
"""

import argparse
import contextlib
import json
import math
import os
import shutil
import subprocess
import time

import numpy as np
import torch

from nunerf_tpu_torch import cli
from nunerf_tpu_torch import pipeline as pl
from nunerf_tpu_torch.config import load_cfg
from nunerf_tpu_torch.models.stage2 import curv_smooth_iters
from nunerf_tpu_torch.models.stage2_shell import orient_to_ray
from nunerf_tpu_torch.ops.chamfer import min_sq_dists
from nunerf_tpu_torch.train.trainer import Trainer, load_checkpoint

# leg -> (stage-1 config, scene directory)
LEGS = {"front": (pl.S1_NESTED, "datasets/nested"),
        "shell_front": (pl.S1_SHELL, "datasets/nested_shell")}


def surface_report(mesh, r_outer, device, gt="datasets/nested/gt_outer.npy", n=100000):
    """The chamfer of ``mesh`` against the analytic outer sphere ``gt``, and
    where its points lie (``n`` points a side)."""
    geo = cli.eval_geometry(mesh, gt, n, device=device)
    a = torch.as_tensor(cli.sample_surface(mesh, n), dtype=torch.float32, device=device)
    b = torch.as_tensor(cli.sample_surface(gt, n), dtype=torch.float32, device=device)
    d1 = min_sq_dists(a, b).sqrt().cpu().numpy()
    d2 = min_sq_dists(b, a).sqrt().cpu().numpy()
    r = np.linalg.norm(a.cpu().numpy(), axis=-1)
    q = [50, 90, 99]
    return dict(geo, pred_to_gt_dist_pct=dict(zip(q, np.percentile(d1, q).tolist())),
                gt_to_pred_dist_pct=dict(zip(q, np.percentile(d2, q).tolist())),
                pred_frac_far_0p05=float((d1 > 0.05).mean()),
                gt_frac_far_0p05=float((d2 > 0.05).mean()),
                pred_radius_pct=dict(zip([1, 10, 50, 90, 99],
                                         np.percentile(r, [1, 10, 50, 90, 99]).tolist())),
                r_outer=r_outer)


@torch.no_grad()
def curvature_report(mesh, cfg, smooth, device, chunk=65536):
    """The sign of the smoothed curvature on ``mesh``, as the shell's stage 2
    reads it: negative vertices, and the first trace's hits on the ``K < 0``
    branch over every camera ray of the test views of ``cfg``'s scene."""
    from nunerf_tpu_torch.data.database import NeRFSyntheticDatabase
    from nunerf_tpu_torch.data.ray_store import build_imgs_info, construct_nerf_ray_batch
    from nunerf_tpu_torch.tracing.scene import Scene

    scene = Scene(mesh, curv_smooth_iters=smooth, device=device)
    vk = scene.vertex_curvature
    db = NeRFSyntheticDatabase(cfg["database_name"], cfg.get("dataset_dir", "./datasets"),
                               testskip=1)
    _, test_ids = db.train_test_split()
    batch, _, _ = construct_nerf_ray_batch(build_imgs_info(db, test_ids, with_mask=False))
    o = torch.as_tensor(batch["rays_o"], device=device)
    d = torch.as_tensor(batch["rays_d"], device=device)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    hits = neg = 0
    for i in range(0, o.shape[0], chunk):
        res = scene.dintersect(o[i:i + chunk], d[i:i + chunk])
        k = orient_to_ray(res["normal"], d[i:i + chunk], res["curvature"])[1][:, 0]
        hits += int(res["hit"].sum())
        neg += int((res["hit"] & (k < 0)).sum())
    return dict(mesh=mesh, smooth_rings=smooth, vertices=int(vk.numel()),
                negative_vertices=int((vk < 0).sum()), test_views=len(test_ids),
                rays=int(o.shape[0]), hits=hits, negative_hits=neg,
                negative_hit_share=neg / max(hits, 1))


def loop_report(cfg, log_path, device):
    """The run of ``log_path`` (a ``train_log.jsonl``): its validations and
    the loop's median ms a step by span of steps."""
    from nunerf_tpu_torch.models.stage1 import ShapeRenderer

    with open(log_path) as f:
        recs = [json.loads(line) for line in f]
    rays = ShapeRenderer(cfg, device=device).cfg["train_ray_num"]
    timed = [r for r in recs if r["prefix"] == "train" and r["rays_per_sec"] > 0]

    def ms(r):
        return r["step_ms"] if "step_ms" in r else rays / r["rays_per_sec"] * 1e3

    ends = [0, 1000] + list(range(10000, cfg["total_step"] + 1, 10000))
    spans = {}
    for lo, hi in zip(ends, ends[1:]):
        got = [ms(r) for r in timed if lo < r["step"] <= hi]
        if got:
            spans[f"{lo + 1}-{hi}"] = float(np.median(got))
    return dict(val={r["step"]: [r["psnr"], r["ssim"]] for r in recs if r["prefix"] == "val"},
                rays=rays, step_ms_median=spans,
                rays_per_sec_median=float(np.median([r["rays_per_sec"] for r in timed])))


@contextlib.contextmanager
def kept_checkpoints(snap, every, steps=()):
    """While open, a copy in ``snap`` of each ``model.ckpt`` the trainer
    writes at a step that ``every`` divides or that ``steps`` holds, made
    right after the write: yields {step: copy}."""
    os.makedirs(snap, exist_ok=True)
    kept, save = {}, Trainer.save

    def save_and_keep(self, path, step, best_para):
        save(self, path, step, best_para)
        if self.writes and path == self.ckpt_path and (step % every == 0
                                                            or step in steps):
            kept[step] = shutil.copy(path, os.path.join(snap, f"model_{step}.ckpt"))

    Trainer.save = save_and_keep
    try:
        yield kept
    finally:
        Trainer.save = save


def seed_run(workdir, seed, every, device, f32=False, keep=(), stop=None, resume=None,
             extra=None):
    """The front leg anew with ``random_seed`` ``seed``, in f32 if ``f32``
    else in the config's precision, with the config keys ``extra`` set; the
    checkpoint kept at every ``every`` steps and at each step of ``keep``,
    the run ended after the save at ``stop`` if given.  With ``resume`` (a
    checkpoint of such a run) the leg goes on from it.  Returns (leg record,
    {step: copy})."""
    ckpt = os.path.join(workdir, "data/model/nested/model.ckpt")
    if os.path.exists(ckpt):
        raise ValueError(f"{ckpt} exists: the leg would resume it; a seed run needs a "
                         f"working directory without one")
    start = 0
    if resume is not None:
        start = load_checkpoint(resume)[0]
        os.makedirs(os.path.dirname(ckpt), exist_ok=True)
        shutil.copy(resume, ckpt)
    over = {pl.S1_NESTED: dict(random_seed=seed, save_interval=math.gcd(1000, *keep))}
    if stop is not None:
        over[pl.S1_NESTED]["total_step"] = stop
    if f32:
        over[pl.S1_NESTED].update(mixed_precision=False, sdf_mixed_precision=False)
    over[pl.S1_NESTED].update(extra or {})
    with kept_checkpoints(os.path.join(workdir, "snap"), every, set(keep)) as kept:
        rec = pl.run_leg("front", workdir, device=device, cfg_overrides=over)
    if rec["steps"]["nested"]["from"] != start:
        raise AssertionError(f"the seed run did not train from step {start}: {rec['steps']}")
    return rec, kept


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("workdir")
    ap.add_argument("--leg", choices=sorted(LEGS), default="front")
    ap.add_argument("--ckpt", action="append", default=[])
    ap.add_argument("--mesh", action="append", default=[],
                    help="a mesh to report as it is (relative to WORKDIR)")
    ap.add_argument("--f32", default=None)
    ap.add_argument("--test", default=None)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--snapshot", type=int, default=5000)
    ap.add_argument("--keep", default="",
                    help="with --seed: more steps to keep a checkpoint at, comma-separated")
    ap.add_argument("--stop-step", type=int, default=None,
                    help="with --seed: end the run after the save at this step")
    ap.add_argument("--train-f32", action="store_true",
                    help="with --seed: train in f32, not in the config's bf16")
    ap.add_argument("--resume", default=None,
                    help="with --seed: go on from this checkpoint of such a run")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="with --seed: set a key of the leg's config (VALUE read as YAML)")
    ap.add_argument("--resolution", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-samples", type=int, default=100000)
    args = ap.parse_args(argv)
    if args.device != "cpu":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    workdir = os.path.abspath(args.workdir)
    out = {}
    ckpts = [(c, False) for c in args.ckpt]
    keep = [int(s) for s in args.keep.split(",") if s]
    if (args.train_f32 or keep or args.stop_step or args.resume or args.set) \
            and args.seed is None:
        ap.error("--train-f32, --keep, --stop-step, --resume and --set go with --seed")
    import yaml
    extra = {k: yaml.safe_load(v) for k, v in (kv.split("=", 1) for kv in args.set)}
    if args.seed is not None:
        if args.leg != "front":
            ap.error("--seed runs the front leg")
        out["leg"], kept = seed_run(workdir, args.seed, args.snapshot, args.device,
                                    args.train_f32, keep, args.stop_step,
                                    args.resume and os.path.abspath(args.resume), extra)
        ckpts += [(kept[s], False) for s in sorted(kept)]
    if args.f32:
        ckpts.append((args.f32, True))
    prev = os.getcwd()
    os.chdir(workdir)
    try:
        return _report(args, out, ckpts)
    finally:
        os.chdir(prev)


def _report(args, out, ckpts):
    """The reports of ``main``, in the leg's working directory."""
    rel, scene_dir = LEGS[args.leg]
    cfg = load_cfg(rel)
    gt = os.path.join(scene_dir, "gt_outer.npy")
    with open(os.path.join(scene_dir, "meta.json")) as f:
        r_outer = json.load(f)["r_outer"]
    log = os.path.join("data/model", cfg["name"], "train_log.jsonl")
    if os.path.exists(log):
        out["loop"] = loop_report(cfg, log, args.device)
        print(json.dumps(out["loop"]), flush=True)
    if args.test:
        ev = cli.eval_images(cfg, args.test, "test", device=args.device)
        out["test"] = {k: ev[k] for k in ("step", "mean_psnr", "mean_ssim")}
    out["meshes"] = []
    for path, f32 in ckpts:
        step = load_checkpoint(path)[0]
        c = dict(cfg, fused_sdf_value=False, sdf_mixed_precision=False) if f32 else cfg
        t0 = time.perf_counter()
        m = cli.extract_mesh_stage1(c, path, args.resolution,
                                    tag=f"s{step}" + ("_f32" if f32 else ""), device=args.device)
        mesh = m["simplified"]
        if args.leg == "shell_front":
            mesh, _ = cli.postprocess_outer(mesh, device=args.device)
        rep = dict(surface_report(mesh, r_outer, args.device, gt, args.n_samples), ckpt=path,
                   step=step, f32=f32, tris=m["tris"], extract_s=time.perf_counter() - t0)
        print(json.dumps(rep), flush=True)
        out["meshes"].append(rep)
    for mesh in args.mesh:
        rep = dict(surface_report(mesh, r_outer, args.device, gt, args.n_samples), mesh=mesh)
        print(json.dumps(rep), flush=True)
        out["meshes"].append(rep)
    if args.leg == "shell_front":
        # the stage-2 config the shell leg wrote here, else the repository's
        s2 = load_cfg(pl.S2_SHELL if os.path.exists(pl.S2_SHELL)
                      else os.path.join(pl.REPO, pl.S2_SHELL))
        mesh = s2["stage1_mesh_dir"]
        if not os.path.exists(mesh):
            print(f"no curvature count: {mesh} does not exist", flush=True)
        else:
            out["curvature"] = curvature_report(mesh, cfg, curv_smooth_iters(s2), args.device)
            print(json.dumps(out["curvature"]), flush=True)
    os.makedirs("runs", exist_ok=True)
    with open(os.path.join("runs", "leg_geometry.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items() if k != "leg"}))
    return out


if __name__ == "__main__":
    main()
