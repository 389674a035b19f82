"""The ``res1024`` leg through the port on one card, at the reference's own
extraction contract (1024^3), on a trained nested ``front``; its record.

    python tools/card_res1024.py WORKDIR --out OUT [--device cpu] [--train-log REF]

WORKDIR holds what ``tools/card_nested_front.sh`` copies out after the
``front`` leg: ``data/model/nested/model.ckpt`` (the last checkpoint, which
``extract-mesh-stage1`` reads; its Adam state may be dropped) and
``datasets/nested/``.  The script runs, in WORKDIR:

1. ``python -m nunerf_tpu_torch.pipeline res1024`` as a library call
   (``pipeline.run_leg``): ``extract-mesh-stage1 --resolution 1024 --tag
   r1024`` (K1 over 2^30 grid points), then ``render-mask`` on the raw mesh
   (K3, one launch a view).  Recorded: the seconds of each part of the
   extraction, the raw and remeshed counts, each subcommand's launches, the
   device ms of the SDF sweep (CUDA events around every ``ShapeRenderer.sdf``
   call), the peak device memory and the peak host RSS of the process.
   The masks are kept as ``datasets/nested/mask_r1024/``.
2. K3 on the raw 1024^3 mesh (``chip_smoke.k3_on_raw_mesh``): its ms on
   65,536 rays of the first views beside the bounds of the flat and the
   two-level culled work, and 4,096 rays of one view held bit for bit to the
   brute plain closest hit.
3. ``eval-geometry`` of the remeshed r1024 mesh against
   ``datasets/nested/gt_outer.npy``.
4. The 512^3 extraction of the same checkpoint, as the ``front`` leg runs
   it, its chamfer, ``render-mask`` on its raw mesh and K3 on that mesh as in
   2; then each view's IoU between the raw-1024 and the raw-512 masks.

``--train-log REF`` (a gzip'd ``train_log.jsonl``, such as
``runs/front_card_train_log.jsonl.gz``) also holds WORKDIR's
``data/model/nested/train_log.jsonl`` to it, every logged value but the
clock's (``step_ms``, ``rays_per_sec``): the card's run is deterministic.

Writes ``OUT/res1024_card.json`` (the record), ``OUT/leg_res1024.json``
and prints each step's lines.
"""
import argparse
import gzip
import json
import os
import resource
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from nunerf_tpu_torch import cli, pipeline as pl  # noqa: E402

JAX_R1024_VERTS = 3404407   # runs/chain_r5_main4.log: nested-30000_r1024.ply, another stage 1
GT_OUTER = "datasets/nested/gt_outer.npy"
R512 = 512   # the front leg's own resolution


def sdf_events():
    """Patch ``ShapeRenderer.sdf`` to record a CUDA event pair around each
    call; returns (the pairs, a function that puts the method back)."""
    from nunerf_tpu_torch.models.stage1 import ShapeRenderer

    real, pairs = ShapeRenderer.sdf, []

    def sdf(self, *args, **kwargs):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = real(self, *args, **kwargs)
        e1.record()
        pairs.append((e0, e1))
        return out

    ShapeRenderer.sdf = sdf
    return pairs, lambda: setattr(ShapeRenderer, "sdf", real)


def mask_ious(dir_a, dir_b):
    """{mask file: IoU of the hit pixels} over the PNG masks both hold."""
    from nunerf_tpu_torch.data import image_io

    out = {}
    names = sorted(os.path.relpath(os.path.join(d, n), dir_a)
                   for d, _, ns in os.walk(dir_a) for n in ns)
    for name in names:
        a = image_io.imread(os.path.join(dir_a, name)) > 127
        b = image_io.imread(os.path.join(dir_b, name)) > 127
        union = int((a | b).sum())
        out[name] = int((a & b).sum()) / union if union else 1.0
    return out


def same_log(path, ref):
    """How far the train log at ``path`` equals the gzip'd one at ``ref``:
    rows, values compared (the clock's left out), values equal, the first
    row that differs."""
    clock = ("step_ms", "rays_per_sec")

    def rows(f):
        return [json.loads(line) for line in f if line.strip()]

    with open(path) as f:
        got = rows(f)
    with gzip.open(ref, "rt") as f:
        want = rows(f)
    n = same = 0
    first = None
    for a, b in zip(got, want):
        for k in sorted((set(a) | set(b)) - set(clock)):
            n += 1
            if a.get(k) == b.get(k):
                same += 1
            elif first is None:
                first = {"row": a, "ref": b}
    return dict(rows=len(got), ref_rows=len(want), values=n, equal=same, first_differing=first)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("workdir")
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cuda", help="'cpu' rehearses it at a small size")
    p.add_argument("--train-log", default=None,
                   help="a gzip'd train log the workdir's front run should equal")
    args = p.parse_args(argv)
    work, out_dir = os.path.abspath(args.workdir), os.path.abspath(args.out)
    os.makedirs(out_dir, exist_ok=True)
    dev = torch.device(args.device)
    from nunerf_tpu_torch.data.database import parse_database_name
    from nunerf_tpu_torch.ops import cuda_build
    from nunerf_tpu_torch.ops import fused_mlp as fm
    from nunerf_tpu_torch.ops import ray_intersect as ri

    card = cs.card_line()
    print(card, flush=True)
    rec = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
           "workdir": os.path.relpath(work, ROOT)}
    if args.train_log:
        rec["train_log_vs_ref"] = dict(same_log(
            os.path.join(work, "data/model/nested/train_log.jsonl"), args.train_log),
            ref=args.train_log)
        print(json.dumps(rec["train_log_vs_ref"]), flush=True)
    if dev.type == "cuda":
        t0 = time.perf_counter()
        cuda_build.build_all()
        rec["build_s"] = time.perf_counter() - t0

    # 1. the leg
    torch.cuda.reset_peak_memory_stats()
    fm.reset_launches()
    ri.reset_launches()
    pairs, restore = sdf_events()
    try:
        leg, by_cmd = cs.counted_commands(lambda: pl.run_leg("res1024", work, device=dev))
    finally:
        restore()
    torch.cuda.synchronize()
    sweep_ms = sum(e0.elapsed_time(e1) for e0, e1 in pairs)
    rec.update(leg_s=leg["seconds"], step=leg["checkpoints"]["extract-mesh-stage1"],
               seconds={c["command"]: c["s"] for c in leg["commands"]},
               extract=leg["extract_s1"], counts=dict(leg["mesh_counts"]),
               jax_r1024_verts=JAX_R1024_VERTS, meshes=leg["meshes"],
               launches=dict(fm.launches, **ri.launches), launches_by_command=by_cmd,
               k1_expected=cs.slab_chunks(1024), sdf_calls=len(pairs),
               sweep_device_ms=sweep_ms,
               peak_device_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               peak_host_rss_gib=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20)
    shutil.copy(os.path.join(work, "runs", "leg_res1024.json"), out_dir)
    print(json.dumps({k: rec[k] for k in ("seconds", "extract", "counts", "launches_by_command",
                                          "sweep_device_ms", "peak_device_gib",
                                          "peak_host_rss_gib")}), flush=True)
    masks = os.path.join(work, "datasets/nested/mask")
    shutil.rmtree(masks + "_r1024", ignore_errors=True)
    shutil.copytree(masks, masks + "_r1024")
    db = parse_database_name("nerf/nested", os.path.join(work, "datasets"))
    raw = leg["meshes"]["raw"]

    cwd = os.getcwd()
    os.chdir(work)
    try:
        # 2. K3 on the raw 1024 mesh
        rec["k3_raw_1024"] = cs.k3_on_raw_mesh(dev, raw, db)
        # 3. the remeshed 1024 mesh's outer chamfer
        cfg = pl.S1_NESTED  # written into the workdir by the leg
        rec["chamfer_r1024"] = cli.main(["eval-geometry", "--mesh", leg["meshes"]["stage1"],
                                         "--gt", GT_OUTER, "--device", str(dev)])
        # 4. the 512 extraction of the same checkpoint, its masks, K3 on it
        t0 = time.perf_counter()
        x512 = cli.main(["extract-mesh-stage1", "--cfg", cfg, "--resolution",
                         str(R512), "--device", str(dev)])
        rec["r512"] = dict({k: x512[k] for k in ("mesh", "simplified", "step", "verts", "tris",
                                                 "tris_simplified")},
                           extract={k: v for k, v in x512.items() if k.endswith("_s")},
                           s=time.perf_counter() - t0)
        rec["chamfer_r512"] = cli.main(["eval-geometry", "--mesh", x512["simplified"], "--gt",
                                        GT_OUTER, "--device", str(dev)])
        ri.reset_launches()
        t0 = time.perf_counter()
        cli.main(["render-mask", "--cfg", cfg, "--mesh_path", x512["mesh"],
                  "--device", str(dev)])
        torch.cuda.synchronize()
        rec["r512"]["render_mask_s"] = time.perf_counter() - t0
        rec["r512"]["render_mask_k3"] = ri.launches["closest_hit"]
        rec["k3_raw_512"] = cs.k3_on_raw_mesh(dev, x512["mesh"], db)
    finally:
        os.chdir(cwd)
    ious = mask_ious(masks + "_r1024", masks)
    rec["mask_iou_r1024_vs_r512"] = ious
    vals = np.array(list(ious.values()))
    rec["mask_iou_summary"] = dict(views=len(vals), min=float(vals.min()),
                                   median=float(np.median(vals)), mean=float(vals.mean()))
    with open(os.path.join(out_dir, "res1024_card.json"), "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps({k: rec[k] for k in ("counts", "chamfer_r1024", "chamfer_r512",
                                          "mask_iou_summary")}), flush=True)
    print(f"k3_raw_1024 {json.dumps(rec['k3_raw_1024'])}", flush=True)
    print(f"k3_raw_512 {json.dumps(rec['k3_raw_512'])}", flush=True)


if __name__ == "__main__":
    main()
