"""The real-capture legs (``real_front``, ``real_boot``, ``real_stage2``)
through the port at their configs' own schedules on one card, each leg's
best and last checkpoints scored, and what the next call needs copied out.

    python tools/card_real_legs.py front WORKDIR --out OUT
    python tools/card_real_legs.py boot WORKDIR --out OUT [--budget 2400] [--keep 20000]
        [--stop 20000]
    python tools/card_real_legs.py stage2 WORKDIR --out OUT --budget 3000
    python tools/card_real_legs.py record OUT [OUT ...] --to runs/real_legs_card.json

``front`` runs ``real_front`` (it makes ``datasets/nested_real`` with
``synth-scene --colmap --shell --n-train 56`` where it is missing).
``boot`` runs ``real_boot`` (making the scene first where it is missing: it
does not read ``real_front``'s model), its ``train`` in a child stopped
right after a ``model.ckpt`` save once the next would land past
``--budget`` seconds; a paused leg ends there, and the same command in a
later call, with the copied ``data/model/nested_real_boot/`` back in the
working directory, resumes it exactly (``train_log.jsonl`` goes on).
``--stop STEP`` ends a leg's run at that step of its schedule (its
``total_step`` alone overridden; the cosine stays the config's), with its
tail; the same command without it goes on to the config's end.
``stage2`` runs ``real_stage2`` on the mesh and checkpoint that
``real_boot`` wrote (``pipeline.boot_overrides``: the config names the
``-20000`` mesh, the boot's schedule writes ``-32000``), budgeted the same
way.

Scores, once a leg's ``train`` has reached ``total_step``, of the best
(``model_best.ckpt``) and the last (``model.ckpt``) checkpoint and of each
kept copy: ``eval-images --split test`` (7 of 56 views; under
``nested_real.yaml``'s ``split_type: validation`` those views are trained
on), and for stage 1 the outer chamfer (``extract-mesh-stage1`` at 384,
``postprocess-outer``, ``eval-geometry``), for stage 2 the inner chamfer
(``extract-mesh-stage2`` at 256, ``postprocess-stage2`` against the traced
mesh) and ``eval_shell``'s learned IoR, thickness and absorption.  A
paused leg is scored at its last checkpoint only.  Writes
``OUT/real_<leg>_scores.json``, the leg's record and its train log,
gzip'd, and copies what the next call needs while it fits ``--room`` MiB:
the ``model.ckpt`` of a leg short of its schedule's end (with Adam's
state, to go on from), else, after ``boot``, with its Adam state dropped
(what stage 2 reads); after ``boot`` also ``datasets/nested_real/``,
``configs/`` and the outer mesh the stage 2 traces.

``record`` gathers the OUT directories of such calls, in order, into one
JSON record beside JAX's figures for these legs: each call's steps,
seconds, scores and launch counts, and the train log's median step ms and
rays/s over the spans of ``SPANS``.
"""
import argparse
import gzip
import json
import os
import pickle
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from nunerf_tpu_torch import cli, pipeline as pl  # noqa: E402

LEG = {"front": ("real_front", pl.S1_REAL), "boot": ("real_boot", pl.S1_BOOT),
       "stage2": ("real_stage2", pl.S2_REAL)}
SCENE = "datasets/nested_real"
SPANS = ((1, 1000), (1001, 10000), (10001, 20000), (20001, 32000))
# JAX's records of these legs (its TPU runs), beside which the card's go
JAX = {"real_front": {"validation_20000": [25.975, 0.9491], "outer_chamfer_20000": 0.15193,
                      "source": "runs/chain_r5_real_front.log:28,39"},
       "real_boot": {"outer_chamfer_20000": 2.4473e-4, "schedule": "20,000-step cosine",
                     "source": "runs/chain_r5_main.log:33", "test_best_4000": [15.031, 0.6708],
                     "source_test": "runs/eval_real_boot_s1_test_r5.json"},
       "real_stage2": {"test_best_25000": [19.680, 0.8483],
                       "source": "runs/eval_real_s2_test_r5.json"}}


def card():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def score_stage1(rel, ckpt, device):
    """Test views and outer chamfer of a stage-1 checkpoint."""
    ev = cli.main(["eval-images", "--cfg", rel, "--split", "test", "--ckpt", ckpt,
                   "--device", device])
    rec = cli.main(["extract-mesh-stage1", "--cfg", rel, "--resolution", "384", "--ckpt", ckpt,
                    "--device", device])
    outer, _ = cli.main(["postprocess-outer", "--input", rec["simplified"], "--device", device])
    geo = cli.main(["eval-geometry", "--mesh", outer, "--gt", f"{SCENE}/gt_outer.npy",
                    "--device", device])
    return dict(ckpt=ckpt, step=ev["step"], mean_psnr=ev["mean_psnr"],
                mean_ssim=ev["mean_ssim"], views=len(ev["views"]), outer_mesh=outer,
                outer_chamfer=geo)


def score_stage2(rel, ckpt, device):
    """Test views, inner chamfer and the shell's learned fields of a stage-2
    checkpoint."""
    from nunerf_tpu_torch.config import load_cfg
    from nunerf_tpu_torch.tools import eval_shell

    traced = load_cfg(rel)["stage1_mesh_dir"]
    ev = cli.main(["eval-images", "--cfg", rel, "--split", "test", "--ckpt", ckpt,
                   "--device", device])
    mesh = cli.main(["extract-mesh-stage2", "--cfg", rel, "--resolution", "256", "--ckpt", ckpt,
                     "--device", device])["mesh"]
    post, _ = cli.main(["postprocess-stage2", "--input", mesh, "--outer", traced,
                        "--device", device])
    geo = cli.main(["eval-geometry", "--mesh", post, "--gt", f"{SCENE}/gt_inner.npy",
                    "--device", device])
    shell = eval_shell.main(["--cfg", rel, "--meta", f"{SCENE}/meta.json", "--ckpt", ckpt,
                             "--device", device])
    return dict(ckpt=ckpt, step=ev["step"], mean_psnr=ev["mean_psnr"],
                mean_ssim=ev["mean_ssim"], views=len(ev["views"]), inner_mesh=post,
                inner_chamfer=geo, eval_shell=shell)


def slim(src, dst):
    """``src`` with its Adam state dropped, to ``dst``."""
    with open(src, "rb") as f:
        blob = pickle.load(f)
    blob["opt_state"] = None
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    with open(dst, "wb") as f:
        pickle.dump(blob, f)


def gz(src, dst):
    with open(src, "rb") as a, gzip.open(dst, "wb") as b:
        shutil.copyfileobj(a, b)


def record(outs, to):
    """The OUT directories of ``main``'s calls, gathered into ``to``."""
    import statistics

    rec = {"script": "tools/card_real_legs.py", "jax": JAX, "legs": {}}
    for out in outs:
        (name,) = [n for n in os.listdir(out) if n.endswith("_scores.json")]
        with open(os.path.join(out, name)) as f:
            sc = json.load(f)
        leg = sc["leg"]["leg"]
        with gzip.open(os.path.join(out, f"{leg}_train_log.jsonl.gz"), "rt") as f:
            logs = [json.loads(x) for x in f]
        train = [r for r in logs if r["prefix"] == "train" and r["step_ms"] > 0]
        spans = {f"{a}-{b}": {k: statistics.median(r[k] for r in train if a <= r["step"] <= b)
                              for k in ("step_ms", "rays_per_sec")}
                 for a, b in SPANS if any(a <= r["step"] <= b for r in train)}
        rec["card"] = sc["card"]
        rec["legs"].setdefault(leg, []).append(dict(
            out=os.path.basename(os.path.normpath(out)), steps=sc["leg"]["steps"],
            paused=sc["paused"], short_of_schedule=sc.get("short_of_schedule"),
            commands=[(c["command"], c["s"]) for c in sc["leg"]["commands"]],
            stage1=sc["leg"].get("stage1"), train_child=sc["leg"].get("train_child"),
            medians=spans, validations=[(r["step"], r["psnr"], r["ssim"])
                                        for r in logs if r["prefix"] == "val"],
            **{k: sc.get(k) for k in ("last", "best", "kept")}))
    with open(to, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    if argv is None:
        argv = sys.argv[1:]
    if argv[:1] == ["record"]:
        ap = argparse.ArgumentParser()
        ap.add_argument("outs", nargs="+")
        ap.add_argument("--to", required=True)
        args = ap.parse_args(argv[1:])
        return record(args.outs, args.to)
    ap = argparse.ArgumentParser()
    ap.add_argument("leg", choices=sorted(LEG))
    ap.add_argument("workdir")
    ap.add_argument("--out", required=True)
    ap.add_argument("--budget", type=float, default=None,
                    help="seconds of training (boot, stage2): a pause")
    ap.add_argument("--stop", type=int, default=None,
                    help="end the run at this step of its schedule (then run again without)")
    ap.add_argument("--keep", default="",
                    help="steps at which train also writes the parameters alone")
    ap.add_argument("--room", type=float, default=62.0,
                    help="MiB that the copies into --out may take")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    leg, rel = LEG[args.leg]
    line = card()
    print(line, flush=True)
    work, out = os.path.abspath(args.workdir), os.path.abspath(args.out)
    os.makedirs(out, exist_ok=True)
    keep = [int(k) for k in args.keep.split(",") if k.strip()]
    t0 = time.time()
    over = {rel: {"total_step": args.stop}} if args.stop else {}
    if args.leg == "boot" and not os.path.isdir(os.path.join(work, SCENE)):
        os.makedirs(work, exist_ok=True)
        os.chdir(work)
        cli.main(["synth-scene", "--output", "./" + SCENE, *pl.REAL_SCENE_ARGS,
                  "--device", args.device])
    if args.leg == "stage2":
        over[rel] = dict(over.get(rel, {}), **pl.boot_overrides(work)[rel])
    rec = pl.run_leg(leg, work, budget=args.budget, device=args.device, keep=keep,
                     cfg_overrides=over)
    print("leg s", time.time() - t0, flush=True)
    os.chdir(work)
    from nunerf_tpu_torch.config import load_cfg

    cfg = load_cfg(rel)
    run = os.path.join("data/model", cfg["name"])
    paused = rec["steps"][cfg["name"]]["paused"]
    short = paused or rec["steps"][cfg["name"]]["to"] < load_cfg(os.path.join(
        pl.REPO, rel))["total_step"]
    score = score_stage2 if args.leg == "stage2" else score_stage1
    scores = dict(card=line, leg=rec, paused=paused, short_of_schedule=short, kept={})
    with open(os.path.join(run, "train_log.jsonl")) as f:
        logs = [json.loads(x) for x in f]
    train = [r for r in logs if r["prefix"] == "train"]
    scores["last_logged"] = train[-1]
    scores["last"] = score(rel, os.path.join(run, "model.ckpt"), args.device)
    if not paused and os.path.exists(os.path.join(run, "model_best.ckpt")):
        scores["best"] = score(rel, os.path.join(run, "model_best.ckpt"), args.device)
        for step in keep:
            ck = os.path.join(run, f"model_{step}.ckpt.gz")
            if os.path.exists(ck):
                scores["kept"][step] = score(rel, ck, args.device)
    scores["seconds"] = time.time() - t0
    with open(os.path.join(out, f"real_{args.leg}_scores.json"), "w") as f:
        json.dump(scores, f, indent=1)
    shutil.copy(os.path.join("runs", f"leg_{leg}.json"), out)
    gz(os.path.join(run, "train_log.jsonl"), os.path.join(out, f"{leg}_train_log.jsonl.gz"))

    # what the next call needs, while it fits
    todo = []
    if short:
        todo += [(os.path.join(run, "model.ckpt"), os.path.join(run, "model.ckpt")),
                 (os.path.join(run, "train_log.jsonl"), os.path.join(run, "train_log.jsonl"))]
        if os.path.exists(os.path.join(run, "model_best.ckpt")):
            slim(os.path.join(run, "model_best.ckpt"), "runs/model_best_slim.ckpt")
            todo.append(("runs/model_best_slim.ckpt", os.path.join(run, "model_best.ckpt")))
    elif args.leg == "boot":
        slim(os.path.join(run, "model.ckpt"), "runs/model_slim.ckpt")
        todo += [("runs/model_slim.ckpt", os.path.join(run, "model.ckpt")),
                 (rec["meshes"]["outer"], rec["meshes"]["outer"])]
    if args.leg == "boot":
        todo += [(SCENE, SCENE), ("configs", "configs")]
    todo += [(k, k) for k in rec.get("kept", [])]
    room = args.room * 2 ** 20
    for src, dst in todo:
        size = (sum(os.path.getsize(os.path.join(d, n)) for d, _, ns in os.walk(src) for n in ns)
                if os.path.isdir(src) else os.path.getsize(src))
        if size > room:
            print("left on the card (no room):", src, flush=True)
            continue
        target = os.path.join(out, "carry", dst)
        os.makedirs(os.path.dirname(target), exist_ok=True)
        (shutil.copytree if os.path.isdir(src) else shutil.copy)(src, target)
        room -= size
        print("copied", src, "->", target, flush=True)
    print("total s", time.time() - t0, flush=True)
    return scores


if __name__ == "__main__":
    main()
