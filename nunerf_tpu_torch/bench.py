"""Benchmark of the port: stage-1 training throughput (rays/s) on one GPU.

    python -m nunerf_tpu_torch.bench

The counterpart of the repository's ``bench.py``: the full-width stage-1
training step (``BENCH_CFG``: 1024 rays, 64 + 64 SDF samples in 4 up-sampling
rounds, 32 background samples, 8x256 SDF and NeRF++, bf16 heads and SDF
trunk, all seven losses) at step 25000, where the occlusion loss is on, on
``bench.py``'s synthetic rays, with weights from seed 0.  3 warm-up steps,
then 20 timed steps on the host clock, ending in ``torch.cuda.synchronize()``.

Prints ONE JSON line with ``bench.py``'s keys (``metric``
``stage1_train_rays_per_sec``, ``value``, ``unit``, ``vs_baseline``,
``baseline_estimated``, ``rays_per_step``, ``step_ms``) and ``device``, the
card's name and power limit as ``nvidia-smi`` reports them.  No FLOP count
or peak is printed.  Needs CUDA: without it, it exits 2.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

# bench.py's estimate of the reference's stage-1 throughput on one NVIDIA
# GPU (the reference publishes none; BASELINE.md)
REFERENCE_RAYS_PER_SEC = 7000.0

BENCH_CFG = {
    "name": "bench",
    "network": "shape",
    "is_nerf": True,
    "get_mask": False,
    "shader_config": {"sphere_direction": False, "human_light": False},
    "loss": ["nerf_render", "eikonal", "std", "init_sdf_reg", "occ", "mask",
             "outer_reg"],
    "eikonal_weight": 0.1,
    "n_samples": 64,
    "n_bg_samples": 32,
    "n_importance": 64,
    "up_sample_steps": 4,
    "train_ray_num": 1024,
    "occ_loss_step": 20000,
    "occ_loss_max_pn": 2048,
    "apply_occ_loss": True,
    "anneal_end": 50000,
    "mixed_precision": True,
    "sdf_mixed_precision": True,
}
STEP = 25000  # occlusion loss on: the steady state
WARMUP, STEPS = 3, 20


def synthetic_batch(rn: int, device) -> dict:
    """``bench.py``'s rays: from (0, 0, -2.5) towards Gaussian targets."""
    rs = np.random.RandomState(0)
    origins = np.tile(np.array([[0.0, 0.0, -2.5]], np.float32), (rn, 1))
    targets = rs.randn(rn, 3).astype(np.float32) * 0.3
    dirs = targets - origins
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    b = {"rays_o": origins, "rays_d": dirs.astype(np.float32),
         "near": np.full((rn, 1), 0.8, np.float32),
         "far": np.full((rn, 1), 4.5, np.float32),
         "rgbs": rs.rand(rn, 3).astype(np.float32),
         "masks": np.ones((rn,), np.float32)}
    return {k: torch.as_tensor(v, device=device) for k, v in b.items()}


def card() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 else "unknown"


def run() -> dict:
    from nunerf_tpu_torch.models.stage1 import ShapeRenderer
    from nunerf_tpu_torch.train.trainer import TrainStep

    dev = torch.device("cuda")
    renderer = ShapeRenderer(BENCH_CFG, device=dev, seed=0)
    train = TrainStep(renderer, 5e-4)
    rn = BENCH_CFG["train_ray_num"]
    batch = synthetic_batch(rn, dev)
    for _ in range(WARMUP):
        train(batch, STEP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        terms = train(batch, STEP)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if not np.isfinite(float(terms["loss_total"])):
        raise FloatingPointError("the benchmark's loss is not finite")
    rays_per_sec = STEPS * rn / dt
    return {
        "metric": "stage1_train_rays_per_sec",
        "value": round(rays_per_sec, 1),
        "unit": "rays/s",
        "vs_baseline": round(rays_per_sec / REFERENCE_RAYS_PER_SEC, 3),
        "baseline_estimated": True,
        "rays_per_step": rn,
        "step_ms": round(dt / STEPS * 1e3, 2),
        "device": card(),
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("nunerf_tpu_torch.bench: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps(run()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
