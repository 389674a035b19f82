"""Where the time of the port's training steps goes, on one GPU.

    python3 tools/prof_stage1_torch.py [--stage 1|2|both] [--steps 3]
                                       [--out runs/prof_stage1_torch.txt]

Drives the full-width steps of ``chip_smoke.py`` under ``torch.profiler``
after a warm-up: the stage-1 ``BENCH_CFG`` step (1024 rays, 8x256 SDF and
NeRF++, all losses) at step 0 (init-SDF regulariser, K1 + K2) and step 25000
(occlusion loss, K1), and the stage-2 zero-thickness ``STAGE2_CFG`` step
(1024 rays, 3 bounces through the ~117k-triangle mesh, K3).  Prints per
phase: wall ms per step, unprofiled ms per step measured just before, device
busy ms per step (the union of the kernels' intervals), the idle share, the
share of the hand-written kernels (K1/K2: ``chain_*``, K3: ``k3_*``), and the
kernels that take the most device time.  The full tables go to ``--out``.
"""

import argparse
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (BENCH_CFG, MESH_RESOLUTION, STAGE2_CFG, batch_for,  # noqa: E402
                        card_line, lumpy_sphere_mesh, stage2_batch)


def _kernels(events):
    """The device kernels among the profiler's events (not the user
    annotations, such as ``Optimizer.step#Adam.step``, that the profiler also
    places on the device's timeline; kernel names may hold a ``#`` too)."""
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation]


def _busy_us(kernels):
    """Union of the kernels' [start, end) intervals, in us."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def profile_phase(label, run_step, steps, f):
    """Warm up, time ``steps`` unprofiled steps, then profile ``steps`` more."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        run_step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        run_step()
    torch.cuda.synchronize()
    plain_wall = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run_step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / steps * 1e3
    kernels = _kernels(prof.events())
    if not kernels:
        raise RuntimeError("the profiler recorded no device kernels")
    busy = _busy_us(kernels) / steps / 1e3
    kern = {}
    for e in kernels:
        kern[e.name] = kern.get(e.name, 0.0) + e.time_range.elapsed_us()
    total = sum(kern.values())
    chain = sum(v for k, v in kern.items() if k.startswith("chain_"))
    k3 = sum(v for k, v in kern.items() if k.startswith("k3_"))
    print(f"{label}: wall {wall:.1f} ms/step (profiled), {plain_wall:.1f} ms/step "
          f"unprofiled, device busy {busy:.1f} ms/step, idle share "
          f"{1 - busy / wall:.3f} (profiled) / {max(0.0, 1 - busy / plain_wall):.3f} "
          f"(unprofiled), K1/K2 share of kernel time {chain / max(total, 1e-9):.3f}, "
          f"K3 {k3 / steps / 1e3:.3f} ms/step (share {k3 / max(total, 1e-9):.4f}), "
          f"{len(kernels) // steps} kernels/step")
    top = sorted(kern.items(), key=lambda kv: -kv[1])[:12]
    for name, us in top:
        print(f"  {us / steps / 1e3:8.3f} ms/step  {us / total:6.3f}  {name[:90]}")
    print(f"== {label}", file=f)
    print(prof.key_averages().table(sort_by="device_time_total", row_limit=60), file=f)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--stage", choices=("1", "2", "both"), default="both")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default="runs/prof_stage1_torch.txt")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs CUDA", file=sys.stderr)
        return 2

    from nunerf_tpu_torch.models.stage1 import ShapeRenderer
    from nunerf_tpu_torch.models.stage2 import Stage2Renderer
    from nunerf_tpu_torch.tracing.scene import Scene
    from nunerf_tpu_torch.train.trainer import TrainStep

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    print(card)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        print(card, file=f)
        if args.stage in ("1", "both"):
            renderer = ShapeRenderer(BENCH_CFG, device=dev, seed=0)
            train = TrainStep(renderer, 5e-4)
            batch = batch_for(BENCH_CFG, dev)
            for step in (0, 25000):
                profile_phase(f"step {step}", lambda: train(batch, step), args.steps, f)
            del renderer, train
        if args.stage in ("2", "both"):
            verts, tris = lumpy_sphere_mesh(MESH_RESOLUTION)
            scene = Scene((verts, tris), device=dev)
            stage1 = ShapeRenderer(BENCH_CFG, device=dev, seed=0)
            renderer = Stage2Renderer(STAGE2_CFG, scene, stage1, device=dev, seed=1)
            train = TrainStep(renderer, 5e-4)
            batch = stage2_batch(STAGE2_CFG["train_ray_num"], dev)
            profile_phase(f"stage-2 step, {len(tris)} triangles",
                          lambda: train(batch, 1000), args.steps, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
