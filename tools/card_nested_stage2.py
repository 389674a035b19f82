"""The zero-thickness nested stage2 leg through the port on one card, for as
long as ``--budget`` allows, then both its checkpoints scored; copies into
``--out`` what the next call needs to go on and the records.

The working directory holds the front leg's stage 1
(``tools/card_nested_front.sh``: its ``model_best.ckpt``, the simplified
mesh the config traces, ``datasets/nested/`` and ``configs/``) and, from a
second call on, the stage-2 run's ``model.ckpt`` (with Adam's state) and
``model_best.ckpt``.  The leg's ``train`` child keeps the parameters at
15,000, 30,000 and 45,000 (``--keep``) and is stopped right after a save
once the next save would land past the budget; the leg's tail then
extracts, post-processes and scores the last checkpoint's inner mesh and
renders the test split with the best one.  This script adds the other
half: the test split with the last checkpoint, the inner mesh of the best
one, and the test split of each kept copy.  The learned IoR is the train
log's last ``ior_glass``.

    python tools/card_nested_stage2.py WORKDIR --out OUT [--budget 2700]

Copied into ``--out``, in this order while they fit ``--room`` MiB: the
scores (``stage2_scores.json``), the leg's record, the train log, the
stage-2 ``model.ckpt`` (to resume from), ``model_best.ckpt`` with its Adam
state dropped, and the kept copies.
"""
import argparse
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

KEEP = [15000, 30000, 45000]
RUN = "data/model/nested_s2"


def card():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def score(ckpt, tag, device="cuda"):
    """``eval-images --split test`` and the inner mesh of ``ckpt``
    (``extract-mesh-stage2`` at 256^3, ``postprocess-stage2`` against the
    traced mesh, ``eval-geometry`` against the scene's inner surface)."""
    from nunerf_tpu_torch.config import load_cfg

    outer = load_cfg(pl.S2_NESTED)["stage1_mesh_dir"]
    ev = cli.main(["eval-images", "--cfg", pl.S2_NESTED, "--split", "test", "--ckpt", ckpt,
                   "--device", device])
    mesh = cli.main(["extract-mesh-stage2", "--cfg", pl.S2_NESTED, "--resolution", "256",
                     "--ckpt", ckpt, "--device", device])["mesh"]
    post, _ = cli.main(["postprocess-stage2", "--input", mesh, "--outer", outer,
                        "--device", device])
    geo = cli.main(["eval-geometry", "--mesh", post, "--gt", "datasets/nested/gt_inner.npy",
                    "--device", device])
    rec = dict(ckpt=ckpt, step=ev["step"], mean_psnr=ev["mean_psnr"],
               mean_ssim=ev["mean_ssim"], views=len(ev["views"]), inner_mesh=post,
               inner_chamfer=geo)
    print(f"score {tag}: {json.dumps(rec)}", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("workdir")
    ap.add_argument("--out", required=True)
    ap.add_argument("--budget", type=float, default=2700.0)
    ap.add_argument("--room", type=float, default=62.0,
                    help="MiB that the copies into --out may take")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    line = card()
    print(line, flush=True)
    work, out = os.path.abspath(args.workdir), os.path.abspath(args.out)
    os.makedirs(out, exist_ok=True)
    t0 = time.time()
    rec = pl.run_leg("stage2", work, budget=args.budget, device=args.device, keep=KEEP)
    print("leg s", time.time() - t0, flush=True)
    os.chdir(work)
    with open(os.path.join(RUN, "train_log.jsonl")) as f:
        logs = [json.loads(x) for x in f]
    train = [r for r in logs if r["prefix"] == "train"]
    scores = dict(card=line, leg=rec, learned_ior=train[-1].get("ior_glass"),
                  ior_frozen=train[-1].get("ior_frozen"), last_logged_step=train[-1]["step"],
                  best=score(os.path.join(RUN, "model_best.ckpt"), "best", args.device),
                  last=score(os.path.join(RUN, "model.ckpt"), "last", args.device), kept={})
    for step in KEEP:
        ck = os.path.join(RUN, f"model_{step}.ckpt.gz")
        if os.path.exists(ck):
            scores["kept"][step] = score(ck, f"kept {step}", args.device)
    scores["seconds"] = time.time() - t0
    with open(os.path.join(out, "stage2_scores.json"), "w") as f:
        json.dump(scores, f, indent=1)

    # what the next call needs, while it fits
    best = pickle.load(open(os.path.join(RUN, "model_best.ckpt"), "rb"))
    best["opt_state"] = None
    slim = os.path.join("runs", "model_best_no_adam.ckpt")
    with open(slim, "wb") as f:
        pickle.dump(best, f)
    room = args.room * 2 ** 20 - os.path.getsize(os.path.join(out, "stage2_scores.json"))
    for src, name in (("runs/leg_stage2.json", None), (os.path.join(RUN, "train_log.jsonl"), None),
                      (os.path.join(RUN, "model.ckpt"), None), (slim, "model_best.ckpt"),
                      *[(os.path.join(RUN, f"model_{s}.ckpt.gz"), None) for s in KEEP]):
        if os.path.exists(src) and os.path.getsize(src) <= room:
            shutil.copy(src, os.path.join(out, name or os.path.basename(src)))
            room -= os.path.getsize(src)
            print("copied", src, flush=True)
        elif os.path.exists(src):
            print("left on the card (no room):", src, flush=True)
    print("total s", time.time() - t0, flush=True)


if __name__ == "__main__":
    main()
