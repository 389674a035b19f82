"""Two shell_stage2 runs side by side on one card: A trains anew from step
0 to ``--stop-a`` (3,000: where the IoR and thickness gates release) in a
copy of WORKDIR's stage 1; B resumes WORKDIR's stage-2 checkpoint under
``--budget-b`` seconds, saving every 500 steps.  Then ``eval-images --split
test --ckpt`` at B's stop; copies into ``--out`` A's and B's checkpoints
without their frozen stage-1 subtree (equal to the stage-1 model_best's
parameters, which a reader restores), their train logs and records.

    python tools/card_shell_stage2_pair.py WORKDIR --out OUT [--stop-a 3000] [--budget-b 2100]
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
LEG = """
import sys; sys.path.insert(0, {root!r})
from nunerf_tpu_torch import pipeline as pl
pl.run_leg("shell_stage2", {work!r}, budget={budget}, device="cuda", cfg_overrides={over!r})
"""


def strip(src, dst):
    blob = pickle.load(open(src, "rb"))
    blob["params"] = {"train": blob["params"]["train"]}
    pickle.dump(blob, open(dst, "wb"))
    print("stripped", dst, blob["step"], os.path.getsize(dst), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("workdir")
    ap.add_argument("--out", required=True)
    ap.add_argument("--stop-a", type=int, default=3000)
    ap.add_argument("--budget-b", type=float, default=2100.0)
    args = ap.parse_args(argv)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    cfg = "configs/stage2/nerf/nested_shell.yaml"
    b = os.path.abspath(args.workdir)
    a, out = b.rstrip("/") + "_anew", os.path.abspath(args.out)
    os.makedirs(out, exist_ok=True)
    if not os.path.exists(a):
        shutil.copytree(b, a, ignore=shutil.ignore_patterns("nested_shell_s2*", "runs"))
    t0 = time.time()
    procs = {}
    for name, work, budget, over in (("A", a, 2400.0, {cfg: {"total_step": args.stop_a}}),
                                     ("B", b, args.budget_b, {cfg: {"save_interval": 500}})):
        procs[name] = subprocess.Popen(
            [sys.executable, "-c", LEG.format(root=ROOT, work=work, budget=budget, over=over)],
            stdout=open(os.path.join(out, f"leg{name}.log"), "w"), stderr=subprocess.STDOUT)
    for name, p in procs.items():
        print(name, "rc", p.wait(), "at", round(time.time() - t0, 1), "s", flush=True)

    sys.path.insert(0, ROOT)
    from nunerf_tpu_torch import cli

    os.chdir(b)
    r = cli.main(["eval-images", "--cfg", cfg, "--split", "test", "--ckpt",
                  "data/model/nested_shell_s2/model.ckpt", "--device", "cuda"])
    with open(os.path.join(out, "eval_test_stopB.json"), "w") as f:
        json.dump(r, f, indent=1)
    print("eval-images at B's stop", r["step"], r["mean_psnr"], r["mean_ssim"], flush=True)
    for name, work in (("A", a), ("B", b)):
        d = os.path.join(work, "data/model/nested_shell_s2")
        strip(os.path.join(d, "model.ckpt"), os.path.join(out, f"model{name}.ckpt"))
        shutil.copy(os.path.join(d, "train_log.jsonl"), os.path.join(out, f"train_log{name}.jsonl"))
        for f in ("runs/leg_shell_stage2.json", "runs/eval_shell_nested_shell_s2.json",
                  "data/eval/nested_shell_s2/eval_test.json"):
            if os.path.exists(os.path.join(work, f)):
                shutil.copy(os.path.join(work, f),
                            os.path.join(out, f"{name}_" + os.path.basename(f)))
    print("total s", round(time.time() - t0, 1), flush=True)


if __name__ == "__main__":
    main()
