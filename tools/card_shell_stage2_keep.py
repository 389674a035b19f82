"""The shell_stage2 leg through the port on one card from step 0 to
``--stop`` (7,500 by default: JAX's best validation), its ``train`` keeping
the parameters at 2,500, 5,000 and 7,500 (``--keep``), then ``eval-images
--split test --ckpt`` at each kept step; copies into ``--out`` the stop's
``model.ckpt`` (with Adam's state, to resume from), the kept copy at
5,000, the train log and the records.  The working directory holds the
shell_front leg's stage 1 (``tools/card_shell_front.sh``).

    python tools/card_shell_stage2_keep.py WORKDIR --out OUT [--stop 7500] [--budget 2700]
"""
import argparse
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from nunerf_tpu_torch import cli, pipeline as pl  # noqa: E402

KEEP = [2500, 5000, 7500]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("workdir")
    ap.add_argument("--out", required=True)
    ap.add_argument("--stop", type=int, default=7500)
    ap.add_argument("--budget", type=float, default=2700.0)
    args = ap.parse_args(argv)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    work, out = os.path.abspath(args.workdir), os.path.abspath(args.out)
    os.makedirs(out, exist_ok=True)
    t0 = time.time()
    pl.run_leg("shell_stage2", work, budget=args.budget, device="cuda",
               cfg_overrides={pl.S2_SHELL: {"total_step": args.stop}}, keep=KEEP)
    print("leg s", time.time() - t0, flush=True)
    shutil.copy(os.path.join(work, "runs/leg_shell_stage2.json"), out)
    run = os.path.join(work, "data/model/nested_shell_s2")
    evals = {}
    os.chdir(work)
    for step in KEEP:
        ck = os.path.join(run, f"model_{step}.ckpt.gz")
        if os.path.exists(ck):
            r = cli.main(["eval-images", "--cfg", pl.S2_SHELL, "--split", "test", "--ckpt", ck,
                          "--device", "cuda"])
            evals[step] = r
            print("eval-images", step, r["mean_psnr"], r["mean_ssim"], flush=True)
    with open(os.path.join(out, "eval_test_kept.json"), "w") as f:
        json.dump(evals, f, indent=1)
    for name in ("train_log.jsonl", "model.ckpt", "model_5000.ckpt.gz"):
        if os.path.exists(os.path.join(run, name)):
            shutil.copy(os.path.join(run, name), out)
    for d in ("data/eval", "runs"):
        if os.path.isdir(d):
            shutil.copytree(d, os.path.join(out, d), dirs_exist_ok=True)
    print("total s", time.time() - t0, flush=True)


if __name__ == "__main__":
    main()
