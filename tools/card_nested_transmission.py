"""Where the nested front leg's glass turns opaque, and whether the stage2
leg learns on a stage 1 that still transmits: a diagnostic on one card, not
a record (it cuts the front leg and points stage 2 at an earlier
checkpoint).

1. The ``front`` leg cut to ``--front-steps`` steps of its own schedule
   (``total_step`` alone is overridden, so these are the first steps of the
   30,000-step run), keeping the parameters at ``--keep``.
2. At each kept step and at the end, the frozen shader's transmission
   weight ``T`` (``AppShadingNetwork.transmission_weight``; stage 2 sees
   through the outer interface in proportion to ``(1 - R) T``) at the
   leg's mesh vertices and at 4,096 points of the scene's outer sphere:
   its 1st, 50th and 99th percentiles.
3. The ``stage2`` leg for ``--stage2-budget`` seconds on that mesh, its
   frozen nets read from the latest kept checkpoint whose median ``T`` on
   the mesh is at least ``--min-t`` (else the earliest), validating every
   ``--val-every`` steps: its train log's ``loss_rgb`` and validations.

    python tools/card_nested_transmission.py WORKDIR --out OUT [--front-steps 6000]

Writes ``OUT/transmission.json``.  ``--seed N`` trains the front leg at
``random_seed`` N (the config's 6033 otherwise) and ``--no-stage2`` stops
after step 2: whether the collapse of ``T`` depends on the run.
``--measure`` only prints step 2's
percentiles at the outer sphere of ``WORKDIR``'s scene for stage-1
checkpoints of either package (a JAX trainer's too), read with the config
``--cfg`` (on the CPU with ``--device cpu``), and with ``--mesh`` at that
mesh's vertices too:

    python tools/card_nested_transmission.py WORKDIR --measure CKPT [CKPT ...] --cfg CFG
"""
import argparse
import gzip
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import numpy as np  # noqa: E402
import torch  # noqa: E402

from nunerf_tpu_torch import pipeline as pl  # noqa: E402


@torch.no_grad()
def transmission_at(renderer, points):
    """Percentiles (1, 50, 99) of a stage-1 renderer's shader transmission
    weight at ``points`` (numpy [N, 3])."""
    dev = next(renderer.parameters())
    p = torch.as_tensor(points, device=dev.device).to(dev.dtype)
    feats = renderer.sdf_net(p)[..., 1:].float()
    t = renderer.color_net.transmission_weight(torch.cat([feats, p.float()], -1)).float()
    return [float(x) for x in np.percentile(t.cpu().numpy(), [1, 50, 99])]


def transmission(cfg, ckpt, points, device):
    """(step, ``transmission_at``) for the parameters of ``ckpt``."""
    from nunerf_tpu_torch.convert import load_jax_params
    from nunerf_tpu_torch.models.stage1 import PARAM_KEYS, ShapeRenderer
    from nunerf_tpu_torch.train.trainer import load_checkpoint

    r = ShapeRenderer(cfg, device=device, seed=0)
    step, params, _, _ = load_checkpoint(ckpt)
    load_jax_params(r, params, PARAM_KEYS)
    return int(step), transmission_at(r, points)


def sphere_points(radius, n=4096):
    """``n`` points of the sphere of ``radius``, directions from
    ``RandomState(0)``."""
    dirs = np.random.RandomState(0).randn(n, 3)
    return (radius * dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).astype(np.float32)


def outer_sphere(workdir, n=4096):
    """``n`` points of the scene's outer sphere (``r_outer`` of its meta)."""
    with open(os.path.join(workdir, "datasets/nested/meta.json")) as f:
        return sphere_points(float(json.load(f)["r_outer"]), n)


def measure(args):
    from nunerf_tpu_torch.config import load_cfg

    cfg = load_cfg(args.cfg)
    sphere = outer_sphere(args.workdir)
    out = {}
    for ck in args.measure:
        step, pct = transmission(cfg, ck, sphere, args.device)
        out[ck] = dict(step=step, outer_sphere=pct)
        if args.mesh:
            from nunerf_tpu_torch.tracing.mesh_ops import load_ply

            out[ck]["mesh"] = args.mesh
            out[ck]["mesh_vertices"] = transmission(cfg, ck, load_ply(args.mesh)[0],
                                                    args.device)[1]
        print(json.dumps(dict(ckpt=ck, **out[ck])), flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("workdir")
    ap.add_argument("--out")
    ap.add_argument("--measure", nargs="+", default=None)
    ap.add_argument("--cfg", default=pl.S1_NESTED)
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--front-steps", type=int, default=6000)
    ap.add_argument("--keep", default="500,1000,1500,2000,3000,4000,5000")
    ap.add_argument("--stage2-budget", type=float, default=480.0)
    ap.add_argument("--val-every", type=int, default=500)
    ap.add_argument("--min-t", type=float, default=0.05)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--no-stage2", action="store_true")
    args = ap.parse_args(argv)
    if args.measure:
        return measure(args)
    if not args.out:
        ap.error("--out is required unless --measure is given")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    work, out = os.path.abspath(args.workdir), os.path.abspath(args.out)
    os.makedirs(out, exist_ok=True)
    keep = [int(k) for k in args.keep.split(",")]
    t0 = time.time()
    s1 = {"total_step": args.front_steps}
    if args.seed is not None:
        s1["random_seed"] = args.seed
    front = pl.run_leg("front", work, device=args.device, keep=keep,
                       cfg_overrides={pl.S1_NESTED: s1})
    rec = dict(card=card, front=front, front_s=time.time() - t0, transmission={})
    os.chdir(work)
    from nunerf_tpu_torch.config import load_cfg
    from nunerf_tpu_torch.tracing.mesh_ops import load_ply

    cfg = load_cfg(pl.S1_NESTED)
    mesh = front["meshes"]["stage1"]
    verts = load_ply(mesh)[0]
    sphere = outer_sphere(".")
    run = os.path.join("data/model", cfg["name"])
    ckpts = [os.path.join(run, f"model_{k}.ckpt.gz") for k in keep]
    ckpts = [c for c in ckpts if os.path.exists(c)] + [os.path.join(run, "model.ckpt")]
    for ck in ckpts:
        step, on_mesh = transmission(cfg, ck, verts, args.device)
        _, on_sphere = transmission(cfg, ck, sphere, args.device)
        rec["transmission"][step] = dict(ckpt=ck, mesh_vertices=on_mesh, outer_sphere=on_sphere)
        print(f"T at {step}: mesh {on_mesh}, sphere {on_sphere}", flush=True)
    if args.no_stage2:
        with open(os.path.join(out, "transmission.json"), "w") as f:
            json.dump(rec, f, indent=1)
        return rec
    kept = [(s, t) for s, t in rec["transmission"].items() if s in keep]
    clear = [s for s, t in kept if t["mesh_vertices"][1] >= args.min_t]
    pick = max(clear) if clear else min(s for s, _ in kept)
    stage1 = os.path.join(run, f"model_{pick}.ckpt")
    with gzip.open(stage1 + ".gz", "rb") as src, open(stage1, "wb") as dst:
        shutil.copyfileobj(src, dst)
    rec["stage2_stage1_step"] = pick
    over = {pl.S2_NESTED: dict(stage1_ckpt_dir="./" + stage1, stage1_mesh_dir="./" + mesh,
                               val_interval=args.val_every, save_interval=args.val_every)}
    t1 = time.time()
    rec["stage2"] = pl.run_leg("stage2", work, budget=args.stage2_budget,
                               device=args.device, cfg_overrides=over)
    rec["stage2_s"] = time.time() - t1
    with open(os.path.join("data/model/nested_s2/train_log.jsonl")) as f:
        logs = [json.loads(x) for x in f]
    rec["stage2_log"] = [{k: r[k] for k in ("step", "prefix", "loss_rgb", "psnr", "ssim", "std")
                          if k in r} for r in logs]
    with open(os.path.join(out, "transmission.json"), "w") as f:
        json.dump(rec, f, indent=1)
    print("total s", time.time() - t0, flush=True)


if __name__ == "__main__":
    main()
