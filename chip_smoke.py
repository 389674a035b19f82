"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--parent DIR]

``--parent DIR`` (DIR holding another tree's ``nunerf_tpu_torch``, for
instance an unpacked parent commit) also times that tree's K1 at the main
path's shapes, and its K2, K4 and K5 whole and by pass at the paths'
shapes, in turns with this one's.

Phases (any failure exits non-zero):
  1. device: CUDA required; prints the card's name and power limit; TF32 off
     for f32 matmuls and convolutions (the plain versions run in full f32);
  2. build: every ``nunerf_tpu_torch/csrc/*.cu``, one ``nvcc`` each, in
     parallel;
  3. kernels: K1 (chain forward), K2 (chain backward), K3 (ray/triangle
     closest hit), K4 (chain value + Jacobian of channel 0) and K5 (its
     backward) against their plain PyTorch versions at the main paths'
     shapes, with times after warm-up (CUDA events) beside each kernel's
     bound; K1's bf16 forward also at every row count the main path gives
     it (8,192 to 2^21: kernel, wrapper and pack times, bound and share);
     K1/K2 also at a shading head's shape (259 inputs) and at the
     NeRF++ trunk's, beside the plain modules; K2 at every chain and row
     count the stage-1 paths give it held to its plain version, and there
     and K4 and K5 at the full SDF chain's 131,072 rows, timed whole call,
     host time and each pass beside the pass's floor (and the dW's
     ``torch.mm`` yardstick), in processes of their own; K1, K2, K4
     and K5 at the shapes
     that can break a tiled MMA (N = 1, 63, 65, 1000; inputs of 39, 84, 131,
     259 and 512; the 217-deep layer; last layers of 1, 3, 64 and 257 with
     no activation, a relu or a softplus), f32 and bf16; K2's bf16 data pass
     also against f32 products of its own stashes, and on one-layer probes
     whose dx is the f32 weights to the last bit; K3, a warp a ray over the
     scene's two-level box index, in its tolerant mode (the scene's default:
     the barycentric tolerance of the sweeps and of the JAX package's
     default closest hit) and its exact mode (the Pallas kernel's), on the
     full-width mesh at 1024, 5000 and 131,072 rays (its pair counts, the
     bounds of the flat and of the two-level culled work beside the brute
     sweep's, its time in both modes and its device time by kernel), against the port's brute sweep and tile-culled descent with no
     ray allowed to disagree on ``hit``, and on an adversarial box mesh;
  4. correctness: one bf16 dense layer on the card against the CPU (both
     round once, after the f32 bias; the share of outputs not bit-equal and
     the layer's CUDA route printed); a small stage-1 step, a small stage-2
     step and a small shell step on the card (kernels on) against the same
     steps on the CPU (plain versions), plain and with the ``fused_sdf`` /
     ``fused_mlp`` gates on;
  5. the main paths, each with the launch counters set to 0 just before and
     read just after: the stage-1 training step at ``BENCH_CFG``'s full
     width (1024 rays, 64+64 SDF samples, 8x256 SDF and NeRF++), a few Adam
     steps at step 0 (init-SDF regulariser on: K1 and K2) and at step 25000
     (occlusion loss on: K1); the stage-2 zero-thickness training step at
     ``STAGE2_CFG``'s full width (1024 rays, 256 samples on each outside
     segment, 64 + 2x32 inside the glass, 3 bounces through a mesh of about
     10^5 triangles, frozen stage-1 weights): 3 K3 launches a step; and the
     same two steps with the opt-in gates on: path A (stage 1, ``fused_sdf``:
     K4 and K5 once a step), path B (stage 2, ``fused_sdf``: K4 and K5 on the
     inner SDF, 3 K3) and path C (stage 1, ``fused_mlp``: K1/K2 on the NeRF++
     trunk and every shading head);
  6. data parallelism (``phase_parallel``): the full-width stage-1 step at
     25000 and stage-2 step, 3 Adam steps each, through the mesh at world
     size 1 on ``nccl`` against the same steps with no mesh, then in two
     ranks spawned on this one card over ``gloo`` (512 of the 1024 rays
     each) against the one-process run and bit for bit against each other;
     K1 and K3 counted on each rank (paths ``parallel_s1``, ``parallel_s2``);
     the per-rank step, the gradient all-reduce's ms and bytes and each
     rank's peak memory printed.  Two ranks on one card measure correctness
     and overhead, not scaling;
  7. the trainer (``phase_trainer``): a 100-view 800x800 NeRF-synthetic
     scene written with the port's PNG writer, ``Trainer(cfg).run()`` of
     stage 1 at ``BENCH_CFG``'s width (30 steps, validation, checkpoints),
     a second trainer resuming at step 30, and the zero-thickness stage 2
     from that checkpoint through K3 in its tolerant mode (10 steps, a
     validation with the TIR mask), each run's launch counts read as a main
     path's;
  8. the pipeline between the stages, in the same working directory, each
     run's launch counts read as a main path's: ``extract-mesh-stage1``
     through ``cli.main`` at 512^3 from the trainer's stage-1 checkpoint
     (``extract_s1``: K1 sweeps the SDF in chunks of 2^21 points, native
     marching, the remesh), after K1 on one such chunk against the plain
     chain and before the K1 extraction at 128^3 against the plain f32 one
     (their chamfer under (h/4)^2); the curvature-shell stage-2 step at
     ``SHELL_CFG``'s width on the remeshed mesh (``shell``: 4 steps at step
     5000, 3 K3 launches a step, every physical field training), after a
     small shell step on the card against the CPU (phase 4); then the
     users' shell pipeline through ``cli.main``: ``train`` (10 steps and a
     masked validation, ``trainer_shell``), ``extract-mesh-stage2`` at 256^3
     (``extract_s2``: K1 on the inner and the frozen outer SDF),
     ``postprocess-stage2 --largest-component``, ``eval-geometry`` against
     the analytic sphere and ``eval-images`` on the test split;
  9. the tools (``phase_tools``), in the same working directory, each run's
     launch counts read as a main path's: ``render-mask`` on the raw 512^3
     mesh for every view of the trainer's scene at 800x800 (K3 on every
     pixel, path ``render_mask``; K3 timed at the chosen chunk and a whole
     view, beside both bounds, its device time by kernel; two views held to the plain closest hit,
     pixel for pixel), ``mask-erosion`` (read back by the database; the
     device erosion against its numpy twin), ``postprocess-outer`` on the
     remeshed mesh (``postprocess_outer``: 64 views through K3; its visible
     faces against the plain closest hit's), ``primary_visibility`` from a
     train pose (``primary_visibility``: 2 K3 launches, equal to the plain
     closest hit's, its ``verts`` gradient against the CPU's), ``render-orbit``
     at 256x256 (``render_orbit``: K1; a band of a view against the CPU's
     f32 render), ``sphere_trace`` of the same SDF (``sphere_trace``: K1,
     against the CPU at 64x64), ``synth-scene --colmap --shell`` with
     ``silhouette-prior``, ``hull-mesh`` and ``render-mask`` on its capture
     database (``render_mask_prior``), and ``relight``;
 10. the leg runner (``phase_pipeline``): ``nunerf_tpu_torch.pipeline``'s
     ``front`` leg in a working directory of its own, its launch counts read
     as a main path's (``pipeline_front``: K1 in every sweep and the
     extraction, K2 in the init-SDF regulariser): ``synth-scene`` at its
     defaults, ``configs/shape/nerf/nested.yaml`` at full width cut to 100
     steps (validations and checkpoints at 50 and 100), the 512^3
     extraction, ``eval-geometry`` and ``eval-images`` on the test split,
     every artifact and metric checked; then the port's ``eval_shell`` on
     the shell pipeline's checkpoint on the card against the CPU (1e-5);
 11. the leg runner's curvature-shell legs (``phase_pipeline_shell``, path
     ``pipeline_shell``: K1 in the sweeps and the extractions, K2 in the
     init-SDF regulariser, K3 in ``postprocess-outer`` and the stage-2
     renders): ``shell_front``, ``shell_stage2`` and the absorption-gated
     ``shell_stage2b`` in one working
     directory, at full width, each cut to 100 steps through
     ``cfg_overrides``, the stage-2 ``train`` in a child under a budget it
     never reaches; every artifact's presence, the chained mesh names, the
     outer chamfer and the test scores checked, and ``eval_shell`` on the
     stage-2 legs' checkpoints on the card against the CPU (1e-5); the inner
     mesh of a 100-step stage 2 is empty, and only its report as empty is
     checked;
 12. the leg runner's zero-thickness ``stage2`` leg (``phase_pipeline_stage2``,
     path ``pipeline_stage2``: K3 in its budgeted ``train`` child, counted
     there and read back from the child's launch record, K1 in
     ``extract-mesh-stage2``, K3 in ``eval-images``) in ``phase_pipeline``'s
     working directory, on its 100-step ``front``:
     ``configs/stage2/nerf/nested.yaml`` at full width with its own rays and
     samples, cut to 100 steps (validations and checkpoints at 50 and 100),
     the front mesh chained through ``cfg_overrides``; every artifact, the
     mesh names, the steps and validations logged, a finite loss, the inner
     chamfer and the 8 test views finite (not judged), the step's ms, rays/s
     and the child's peak memory printed;
 13. the leg runner's three real-capture legs (``phase_pipeline_real``,
     path ``pipeline_real``) in a working directory of their own, each at
     full width with its config's rays and samples cut to 100 steps:
     ``real_front``, ``real_boot`` (prior masks from the cloud's hull, the
     mask term on the ``rawmask`` database, masks rendered anew from its
     mesh), ``real_stage2`` on the boot's mesh (``boot_overrides``) in a
     budgeted child; the 56 masks of each kind, every artifact, finite
     losses, chamfers, test views and ``eval_shell`` checked, and each
     subcommand's launches (K1, K2 in the stage-1 ``train``s, K1 in the
     extractions, K3 in ``postprocess-outer``, ``render-mask``, the child
     and the stage 2's ``eval-images``); step ms, rays/s and peak memory of
     each leg and the seconds of each subcommand printed.
 14. the leg runner's ``res1024`` leg (``phase_pipeline_res1024``, path
     ``pipeline_res1024``) in ``phase_pipeline``'s working directory, on its
     100-step ``front``, at the leg's own 1024^3: ``extract-mesh-stage1
     --tag r1024`` (K1 over 2^30 points in 516 launches, the native
     marching, the dedup, the remesh; seconds by part, counts, peak device
     memory and host RSS printed) and ``render-mask`` on the raw mesh of
     millions of triangles (K3, one launch a view); then K3 on that mesh
     timed on 65,536 rays beside its flat and two-level bounds, and held bit
     for bit to the brute plain closest hit on 4,096 rays of one view.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

# the full-width stage-1 step: the port's copy of bench.py's BENCH_CFG, and
# its synthetic rays
from nunerf_tpu_torch.bench import BENCH_CFG, synthetic_batch  # noqa: E402

# the small configuration of phase 4
SMALL_CFG = dict(BENCH_CFG, n_samples=8, n_importance=8, up_sample_steps=2,
                 n_bg_samples=4, n_front_samples=2, n_back_samples=2,
                 sdf_n_layers=4, perturb=0.0, train_ray_num=16,
                 occ_loss_max_pn=1 << 20, mixed_precision=False,
                 sdf_mixed_precision=False)

# the full-width stage-2 step: ZERO_THICK_DEFAULTS as they stand with the keys
# of configs/stage2/nerf/glassice.yaml, stage 1 = BENCH_CFG
STAGE2_CFG = {
    "name": "bench_s2",
    "network": "stage2",
    "is_nerf": True,
    "zero_thickness": True,
    "stage1_cfg": BENCH_CFG,
    "loss": ["eikonal", "std", "nerf_render"],
    "eikonal_weight": 0.02,
    "train_ray_num": 1024,
    "mixed_precision": True,
}
MESH_RESOLUTION = 128   # the lumpy sphere marched at 128^3: ~117k triangles

# the small configuration of the stage-2 check
SMALL_S2_CFG = dict(STAGE2_CFG, stage1_cfg=SMALL_CFG, n_samples_outer=16,
                    n_bg_importance=4, n_samples_inner=8, inner_up_rounds=1,
                    inner_up_each=4, sdf_n_layers=4, train_ray_num=16,
                    mixed_precision=False)

# the full-width curvature-shell stage 2: SHELL_DEFAULTS (64 outer samples,
# 64 + 2x32 inside the glass) with the keys of
# configs/stage2/nerf/nested_shell.yaml, stage 1 = BENCH_CFG
SHELL_CFG = {
    "name": "bench_shell_s2",
    "network": "stage2",
    "is_nerf": True,
    "zero_thickness": False,
    "stage1_cfg": BENCH_CFG,
    "shader_config": {"sphere_direction": False, "human_light": False},
    "loss": ["eikonal", "std", "nerf_render"],
    "eikonal_weight": 0.02,
    "freeze_inv_s_step": 1500,
    "freeze_ior_step": 3000,
    "freeze_thickness_step": 3000,
    "freeze_thickness_inv_s": 100,
    "inner_diffuse_only": True,
    "sdf_bias": 0.35,
    "anneal_end": 8000,
    "learn_absorption": True,
    "inv_s_floor_max": 300.0,
    "inv_s_floor_start": 10000,
    "inv_s_floor_end": 28000,
    "inv_s_floor_base": 32.0,
    "sdf_mixed_precision": True,
    "mixed_precision": True,
    "train_ray_num": 1024,
}
SHELL_STEP = 5000   # past the IoR and thickness freeze steps
SHELL_TRIANGLES = (50000, 150000)   # the remeshed outer mesh the shell traces
EXTRACT_RESOLUTION = 512   # extract-mesh-stage1 in tools/run_nested_pipeline.sh
EXTRACT_S2_RESOLUTION = 256
SMALL_SHELL_CFG = dict(SHELL_CFG, stage1_cfg=SMALL_CFG, n_samples_outer=16,
                       n_samples_inner=8, inner_up_rounds=1, inner_up_each=4,
                       sdf_n_layers=4, train_ray_num=16, mixed_precision=False,
                       sdf_mixed_precision=False)

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 without
# them, HBM3 bandwidth
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

# K2, K4 and K5: pass 1 is K1's chain_fwd_wgmma_kernel (fused_mlp.cu), the
# other passes the kernels of chain_bwd_wgmma.cuh (included by fused_mlp.cu)
SOURCE = {"K1": "nunerf_tpu_torch/csrc/fused_mlp.cu",
          "K2": "nunerf_tpu_torch/csrc/chain_bwd_wgmma.cuh",
          "K3": "nunerf_tpu_torch/csrc/ray_intersect.cu",
          "K4": "nunerf_tpu_torch/csrc/chain_bwd_wgmma.cuh",
          "K5": "nunerf_tpu_torch/csrc/chain_bwd_wgmma.cuh"}
REPLACES = {"K1": "nunerf_tpu/ops/fused_mlp.py:168",        # _fwd_kernel
            "K2": "nunerf_tpu/ops/fused_mlp.py:199",        # _make_bwd_kernel
            "K3": "nunerf_tpu/ops/pallas_intersect.py:33",  # _mt_kernel
            "K4": "nunerf_tpu/ops/fused_mlp.py:573",        # _jac_fwd_kernel
            "K5": "nunerf_tpu/ops/fused_mlp.py:593"}        # _make_jac_bwd_kernel

# tolerances of the chain kernels, relative to the plain output's largest
# magnitude: f32 sums in another order (1e-5 fwd, 1e-4 bwd and Jacobian);
# bf16 roundings of hidden activations and cotangents that flip with the sum
# order (1e-2, 3e-2)
CHAIN_TOL = {("fwd", "float32"): 1e-5, ("fwd", "bfloat16"): 1e-2,
             ("bwd", "float32"): 1e-4, ("bwd", "bfloat16"): 3e-2}


def log(*args):
    print(*args, flush=True)


def card_line():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr}")
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` runs after one warm-up."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def rel_err(a, b):
    return float((a - b).abs().max() / (b.abs().max() + 1e-30))


def chain_errs(fm, spec, x, g, flat, got, t_b):
    """K1 and K2 (``got`` = y, dx, dflat) against the plain version, every
    error relative to the plain array's largest magnitude.

    ``fwd`` and ``hidden``: y, and every hidden activation of the kernel's
    stash, against the plain chain's.  ``bwd``: dx and every weight and bias
    gradient, by the largest error over all rows, against autograd through the
    plain chain taken at the kernel's own relu gates
    (``chain_hidden_reference``): a relu whose pre-activation is within
    rounding of 0 opens or closes with the order of the sums, and then its
    unit's whole share of the row's gradients comes or goes; ``hidden`` holds
    the gates themselves, since a gate that differs where the plain
    pre-activation is not small shows there.  A chain without a relu has no
    gates and ``bwd`` is against plain autograd.  Beside them, against
    autograd at the plain chain's own gates: ``bwd_own_gates``, the rows in
    which some gate differs (``flipped_rows``), the rows whose dx is off by
    more than ``t_b`` (``outlier_rows``) and those of them in which no gate
    differs (``stray_rows``: there the gates explain nothing)."""
    y, dx, dflat = got
    leaves = [x.clone().requires_grad_(True)] + [f.clone().requires_grad_(True)
                                                 for f in flat]
    y_ref, h_ref = fm.chain_hidden_reference(spec, *leaves)
    ref = torch.autograd.grad(torch.sum(y_ref * g), leaves)
    y_k, h_k = fm.chain_hidden_cuda(spec, x, flat)
    torch.cuda.synchronize()
    row = (dx - ref[0]).abs().amax(dim=1) / (ref[0].abs().max() + 1e-30)
    outlier = row > t_b
    e = {"fwd": rel_err(y, y_ref.detach()),
         "hidden": max([rel_err(a, b.detach()) for a, b in zip(h_k, h_ref)], default=0.0),
         "bwd_own_gates": max(rel_err(a, b) for a, b in zip((dx,) + dflat, ref)),
         "outlier_rows": int(outlier.sum())}
    if "relu" not in spec.acts:
        e.update(bwd=e["bwd_own_gates"], flipped_rows=0, stray_rows=e["outlier_rows"])
        return e
    gates = fm.relu_gates(spec, h_k, y_k)
    flipped = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    for gate, a in zip(gates, h_ref + [y_ref]):
        if gate is not None:
            flipped |= ((a.detach() > 0) != (gate > 0)).any(dim=1)
    y_g, _ = fm.chain_hidden_reference(spec, *leaves, gates=gates)
    ref_g = torch.autograd.grad(torch.sum(y_g * g), leaves)
    e.update(bwd=max(rel_err(a, b) for a, b in zip((dx,) + dflat, ref_g)),
             flipped_rows=int(flipped.sum()), stray_rows=int((outlier & ~flipped).sum()))
    return e


def data_pass_check(fm, spec, x, g, flat, what):
    """K2's bf16 data pass against f32 ``torch.matmul`` (TF32 off) of its own
    stashes: dx within 1e-5 of its scale and every rounded gz within one
    bf16 unit (``data_pass_errors``).  ``CHAIN_TOL``'s 3e-2 cannot tell the
    exact three-piece split of ``W^T`` from one with a piece dropped.  This
    sees a dropped ``mid`` (about 1e-3 of dx's scale); a dropped ``lo`` (at
    most 2^-16 of a weight) moves dx by a few 1e-6, under the limit, and only
    ``split_probe_check`` sees it.  Returns (dx error, gz units)."""
    kept = {}
    dx, _ = fm.chain_bwd_cuda(spec, x, g, flat, keep=kept)
    torch.cuda.synchronize()
    dx_err, ulps = fm.data_pass_errors(spec, g, flat, kept, dx)
    if not (dx_err <= 1e-5 and ulps <= 1.0):
        raise AssertionError(f"K2 data pass {what}: dx {dx_err:.2e} (tol 1e-5), gz off by "
                             f"{ulps:.2f} bf16 units (tol 1) against f32 products of its stashes")
    return dx_err, ulps


# (input, last layer) widths of the split probes: one 16-deep k-block and
# many, the data pass's dx tile in shared memory and, past 256 inputs, in
# two column blocks written from the accumulators
SPLIT_PROBES = ((39, 1), (39, 257), (84, 256), (259, 3), (512, 512))


def split_probe_check(fm, dev):
    """K2's bf16 data pass on ``split_probe`` cases, whose dx is the f32
    weights times powers of two in any order of the sums: within one unit
    of the last place of the exact value (``split_probe_units``; the unit
    allows for the tensor cores' alignment of a sum that ends just under a
    power of two).  A build that leaves ``lo`` out is off by tens of units
    (``tools/prof_chain_kernels.py --split-faults``).  Returns the largest
    reading."""
    worst = 0.0
    for k, m in SPLIT_PROBES:
        spec, x, g, flat = fm.split_probe(k, m, 1000, seed=k + m, device=dev)
        dx, _ = fm.chain_bwd_cuda(spec, x, g, flat)
        torch.cuda.synchronize()
        units = fm.split_probe_units(g, flat, dx)
        if not units <= 1.0:
            raise AssertionError(f"K2 split probe {k}->{m}: dx off by {units:.0f} units of "
                                 "the last place of the f32 weights (tol 1)")
        worst = max(worst, units)
    return worst


def batch_for(cfg, dev):
    return synthetic_batch(cfg["train_ray_num"], dev)


def lumpy_sphere_mesh(resolution):
    """The outer mesh stage 2 traces: a lumpy sphere (radius 0.5 +- 0.05)
    marched with the port's ``extract_geometry`` (the native library)."""
    from nunerf_tpu_torch.tracing.mesh_ops import extract_geometry

    def sdf(p):
        r = np.linalg.norm(p, axis=-1)
        return r - (0.5 + 0.05 * np.sin(7 * p[..., 0]) * np.cos(7 * p[..., 1]))

    return extract_geometry(sdf, resolution=resolution, bound=1.0)


def intersect_rays(n, seed, dev):
    """A third each: from outside towards the mesh, from inside the glass,
    and pointing away from it (misses)."""
    rs = np.random.RandomState(seed)
    d = rs.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    target = rs.randn(n, 3).astype(np.float32) * 0.2
    k = np.arange(n) % 3
    o = np.where((k == 0)[:, None], target - 2.0 * d,
                 np.where((k == 1)[:, None], rs.rand(n, 3).astype(np.float32) * 0.4 - 0.2,
                          target + 2.0 * d)).astype(np.float32)
    return torch.as_tensor(o, device=dev), torch.as_tensor(d, device=dev), k


def stage2_batch(rn, dev):
    b = batch_for({"train_ray_num": rn}, dev)
    return {k: b[k] for k in ("rays_o", "rays_d", "rgbs")}


def shell_batch(rn, dev):
    """``stage2_batch`` with an object mask (a fifth of the rays off it)."""
    b = stage2_batch(rn, dev)
    rs = np.random.RandomState(2)
    b["masks"] = torch.as_tensor((rs.rand(rn) > 0.2).astype(np.float32), device=dev)
    return b


def chain_bytes(spec, n):
    """Bytes a chain call must move: x read once, y written once, the
    weights read once (f32)."""
    from nunerf_tpu_torch.ops.fused_mlp import flat_weight_shapes
    w = sum(a * b for a, b in flat_weight_shapes(spec)) + sum(spec.dims[1:])
    return 4 * (n * spec.dims[0] + n * spec.dims[-1] + w)


def bound_ms(flops, nbytes, dtype):
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


# rows the main path gives K1: the legs' 512 rays x 16, BENCH_CFG's sweeps
# and occlusion march of 1024 rays (16 to 128 points a ray), the
# extraction's chunks of 2^21 points
K1_MAIN_N = (8192, 16384, 32768, 65536, 131072, 2 ** 21)

# The SDF network's chain without its last layer (``fields/sdf.py``
# ``_sdf_chain``: dims, activations, skips, scales), the shading heads' and
# the NeRF++ trunk's (``fields/mlp.py`` ``Predictor``, ``fields/nerf.py``)
SDF_CHAIN = ((39, 256, 256, 256, 217, 256, 256, 256, 256), ("softplus100",) * 8 + ("none",),
             (False,) * 4 + (True,) + (False,) * 4,
             (1.0,) * 4 + (1 / math.sqrt(2),) + (1.0,) * 4)
TRUNK_CHAIN = ((84,) + (256,) * 8, ("relu",) * 8, (False,) * 5 + (True,) + (False,) * 2,
               (1.0,) * 8)


def sdf_chain(out):
    """``SDF_CHAIN`` with its last layer ``out`` wide (1: the value, 257: the
    value and the feature)."""
    return (SDF_CHAIN[0] + (out,),) + SDF_CHAIN[1:]


def head_chain(e, o):
    return (e, 256, 256, 256, o), ("relu",) * 3 + ("none",), (False,) * 4, (1.0,) * 4


# K2, K4 and K5 at the paths' shapes: (kernel, what, chain, rows).  K2's are
# the calls ``tools/prof_chain_kernels.py --paths`` records on the stage-1
# paths: the init-SDF regulariser's value chain at step 0, path C's NeRF++
# trunk and shading heads; K4 and K5 run on paths A and B at the full SDF
# chain's 131,072 rows (K5 in chunks of ``JAC_CHUNK_ROWS``)
PATH_CASES = (("K2", "sdf value", sdf_chain(1), 65536),
              ("K2", "trunk", TRUNK_CHAIN, 65536),
              ("K2", "head 72-3", head_chain(72, 3), 393216),
              ("K2", "head 111-3", head_chain(111, 3), 262144),
              ("K2", "head 78-3", head_chain(78, 3), 131072),
              ("K2", "head 259-1", head_chain(259, 1), 131072),
              ("K2", "head 72-3", head_chain(72, 3), 1024),
              ("K4", "sdf full", sdf_chain(257), 131072),
              ("K5", "sdf full", sdf_chain(257), 131072))


def case_key(case):
    k, what, _, n = case
    return f"{k} {what} N={n}"


# K1's bf16 forward of a parent tree (``--parent DIR``, DIR holding its
# ``nunerf_tpu_torch``) on the value-only SDF chain (argv[1], JSON) from a
# pre-built pack, in a process of its own: prints {n: ms} as one JSON line
PARENT_K1_TIMER = r"""
import json, math, sys, torch
from nunerf_tpu_torch.ops import fused_mlp as fm
spec = fm.ChainSpec(*[tuple(a) for a in json.loads(sys.argv[1])], "bfloat16")
dev = torch.device("cuda")
gen = torch.Generator().manual_seed(0)
flat = [(torch.randn(s, generator=gen) / math.sqrt(s[0])).to(dev) for s in fm.flat_weight_shapes(spec)]
flat += [(torch.randn((1, d), generator=gen) * 0.1).to(dev) for d in spec.dims[1:]]
lib = fm._lib()
W, B = fm._fwd_pack(spec, flat), fm._pack_biases(spec, flat)
res = {}
for n in [int(a) for a in sys.argv[2:]]:
    x = (torch.rand((n, 39), generator=gen) * 2 - 1).to(dev)
    out = torch.empty((n, 1), device=dev)
    fn = lambda: fm._fwd_launch(lib, spec, x, W, B, out, None)
    fn()
    torch.cuda.synchronize()
    reps = max(5, min(100, 2 ** 23 // n))
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    res[n] = e0.elapsed_time(e1) / reps
print(json.dumps(res))
"""


def parent_k1_ms(parent):
    """{n: ms} of the parent tree's K1 at ``K1_MAIN_N`` (its build included
    in the child's time, not in the numbers)."""
    import os
    # from inside the tree: ``-c`` puts the working directory first on the path
    res = subprocess.run([sys.executable, "-c", PARENT_K1_TIMER, json.dumps(sdf_chain(1)),
                          *map(str, K1_MAIN_N)],
                         cwd=os.path.abspath(parent), capture_output=True, text=True,
                         timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"the parent's K1 failed:\n{res.stderr[-3000:]}")
    return {int(k): v for k, v in json.loads(res.stdout.strip().splitlines()[-1]).items()}


# K2, K4 and K5 at the cases of argv[1] (JSON of ``PATH_CASES``), in a
# process of its own from a tree's directory: prints one JSON line {case:
# {"ms": call ms (CUDA events), "host_ms": host ms of a call (the stream
# drained before it), "kernels": {kernel: device ms} (torch.profiler),
# "profile_tries", "host_fns": {function: host ms} (cProfile's own time,
# calls of up to 4,096 rows)}}.  The profiler can lose kernel events: every kernel's count over
# the timed calls must be their number times its count in one call, else
# both are taken again, at most three times, and then the run fails.
CHAIN_TIMER = r"""
import cProfile, json, math, pstats, sys, time, torch
from torch.profiler import ProfilerActivity, profile
from nunerf_tpu_torch.ops import fused_mlp as fm
dev = torch.device("cuda")
gen = torch.Generator().manual_seed(0)
def events_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps
def host_ms(fn, reps):
    t = 0.0
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        t += time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e3
def profiled(fn, reps):
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if "chain_" in e.key and e.device_time_total > 0:
            name = e.key.replace("void ", "").split("(")[0]
            c, t = out.get(name, (0, 0.0))
            out[name] = (c + e.count, t + e.device_time_total / 1e3 / reps)
    return out
def kernel_ms(fn, reps, what):
    for tries in range(1, 4):
        one, got = profiled(fn, 1), profiled(fn, reps)
        if one and {k: c * reps for k, (c, _) in one.items()} == {k: c for k, (c, _) in got.items()}:
            return {k: t for k, (_, t) in got.items()}, tries
        print(f"{what}: kernel events lost ({one} a call, {got} over {reps}), again",
              file=sys.stderr)
    raise SystemExit(f"{what}: the profiler lost kernel events in three tries")
def host_fns(fn, reps):
    pr = cProfile.Profile()
    pr.enable()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    pr.disable()
    top = sorted(pstats.Stats(pr).stats.items(), key=lambda kv: -kv[1][2])[:12]
    return {f"{f[2]} ({f[0].rsplit('/', 1)[-1]}:{f[1]})": s[2] / reps * 1e3 for f, s in top}
res = {}
for k, what, chain, n in json.loads(sys.argv[1]):
    dims, acts, skip, scales = (tuple(a) for a in chain)
    spec = fm.ChainSpec(dims, acts, skip, scales, "bfloat16")
    flat = [(torch.randn(s, generator=gen) / math.sqrt(s[0])).to(dev)
            for s in fm.flat_weight_shapes(spec)]
    flat += [(torch.randn((1, d), generator=gen) * 0.1).to(dev) for d in dims[1:]]
    x = (torch.randn((n, dims[0]), generator=gen) * 0.5).to(dev)
    gy = torch.randn((n, dims[-1]), generator=gen).to(dev)
    gj = torch.randn((n, dims[0]), generator=gen).to(dev)
    fn = {"K2": lambda: fm.chain_bwd_cuda(spec, x, gy, flat),
          "K4": lambda: fm.chain_jac_fwd_cuda(spec, x, flat),
          "K5": lambda: fm.chain_jac_bwd_cuda(spec, x, gy, gj, flat)}[k]
    reps = 5 if n >= 65536 else 20
    key = f"{k} {what} N={n}"
    kern, tries = kernel_ms(fn, reps, key)
    res[key] = {"ms": events_ms(fn, reps), "host_ms": host_ms(fn, reps), "kernels": kern,
                "profile_tries": tries}
    if n <= 4096:
        res[key]["host_fns"] = host_fns(fn, reps)
print(json.dumps(res))
"""

# the passes of K2, K4 and K5 by their device kernels (chain_bwd_wgmma_kernel's
# first template argument: BW_DATA 0, BW_JDOWN 1, BW_JUP 2)
PASS_OF = {"chain_fwd_wgmma_kernel": "pass 1 (forward, h stash)",
           "chain_bwd_wgmma_kernel<0": "data pass", "chain_bwd_wgmma_kernel<1": "J-pass",
           "chain_bwd_wgmma_kernel<2": "reverse J-pass", "chain_dw_wgmma_kernel": "dW"}


def by_pass(kernels):
    """{pass: device ms} of a CHAIN_TIMER entry's kernels."""
    out = {}
    for name, ms in kernels.items():
        p = next((v for k, v in PASS_OF.items() if name.startswith(k)), name)
        out[p] = out.get(p, 0.0) + ms
    return out


def chain_timer(tree, cases=PATH_CASES):
    """CHAIN_TIMER on ``cases`` run from ``tree``'s directory (its build
    included in the child's time, not in the numbers)."""
    import os
    res = subprocess.run([sys.executable, "-c", CHAIN_TIMER, json.dumps(cases)],
                         cwd=os.path.abspath(tree), capture_output=True, text=True,
                         timeout=900)
    if res.returncode != 0:
        raise RuntimeError(f"the chain timer failed in {tree}:\n{res.stderr[-3000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def pass_floors(spec, n, kind):
    """{pass: least ms} of K2's (``kind`` "K2") or K5's passes over ``n``
    rows, and K4's: each the larger of its products at the bf16 peak and its
    own bytes at the card's memory rate, every array it reads read once and
    every array it writes written once (the stashes in the bf16 route's
    padded layout: h, p, qbar, zs bf16; q, dbar f32).  K2's data pass forms
    three products a weight (the split of the f32 W^T)."""
    from nunerf_tpu_torch.ops import fused_mlp as fm
    lay = fm.mma_layout(spec)
    e, out = spec.dims[0], spec.dims[-1]
    hid, allp, ep = n * lay.psum_hidden, n * lay.psum, n * lay.ep
    f = fm.chain_flops(spec, n)
    fj = jac_flops(spec, n) - f
    w = 2 * sum(a * b for a, b in fm.flat_weight_shapes(spec))

    def ms(flops, nbytes):
        return bound_ms(flops, nbytes + w, "bfloat16")[0]
    fwd = ms(f, 4 * n * (e + out) + 2 * hid)
    if kind == "K2":
        return {"pass 1 (forward, h stash)": fwd,
                "data pass": ms(3 * f, 4 * n * (2 * out + e) + 2 * hid + 2 * allp),
                "dW": ms(f, 2 * (ep + hid + allp) + 2 * w)}
    jd = ms(fj, 2 * hid + 4 * hid + 4 * n * e)
    if kind == "K4":
        return {"pass 1 (forward, h stash)": fwd, "J-pass": jd}
    return {"pass 1 (forward, h stash)": fwd, "J-pass": jd,
            "reverse J-pass": ms(fj, 4 * n * e + 2 * hid + 4 * hid + 4 * hid + 2 * hid + 2 * hid),
            "data pass": ms(f, 4 * n * (out + e) + 2 * hid + 4 * hid + 2 * allp),
            "dW": ms(f + fj, 2 * (2 * ep + hid + allp + 2 * hid) + 2 * w)}


def dw_library_ms(fm, spec, chunks, jac, dev):
    """The dW's library yardstick: ``torch.mm`` of its own bf16 operands
    (the stashes' layers, transposed times the zs layer, and K5's second
    term) with f32 output, one call a weight, over every chunk of rows in
    ``chunks`` (K5: two of ``JAC_CHUNK_ROWS``), each chunk's operands its
    own."""
    lay = fm.mma_layout(spec)
    gen = torch.Generator(device=dev).manual_seed(6)
    pairs = []
    for n in chunks:
        ops = {("x0", None): torch.randn((n, lay.ep), generator=gen, device=dev).bfloat16(),
               ("gj", None): torch.randn((n, lay.ep), generator=gen, device=dev).bfloat16()}
        for l, (_, wp, _, _, _) in enumerate(lay.layers):
            for name in ("h", "zs", "qbar", "p"):
                ops[(name, l)] = torch.randn((n, wp), generator=gen, device=dev).bfloat16()
        for l, (_, _, _, pwx, _) in enumerate(lay.layers):
            second = jac and l < spec.n_layers - 1
            srcs = [(("x0", None) if l == 0 else ("h", l - 1),
                     ("gj", None) if l == 0 else ("qbar", l - 1))]
            if pwx >= 0:
                srcs.append((("x0", None), ("gj", None)))
            for a1, a2 in srcs:
                pairs.append((ops[a1], ops[("zs", l)]))
                if second:
                    pairs.append((ops[a2], ops[("p", l)]))

    def run():
        for a, b in pairs:
            torch.mm(a.t(), b, out_dtype=torch.float32)
    return cuda_ms(run, 5)


def case_inputs(fm, chain, n, dev, gen):
    """A bf16 chain of ``PATH_CASES`` with weights, biases, inputs and a
    cotangent from ``gen``, made as ``CHAIN_TIMER`` makes them."""
    spec = fm.ChainSpec(*chain, compute_dtype="bfloat16")
    flat = [(torch.randn(s, generator=gen) / math.sqrt(s[0])).to(dev)
            for s in fm.flat_weight_shapes(spec)]
    flat += [(torch.randn((1, d), generator=gen) * 0.1).to(dev) for d in spec.dims[1:]]
    x = (torch.randn((n, spec.dims[0]), generator=gen) * 0.5).to(dev)
    g = torch.randn((n, spec.dims[-1]), generator=gen).to(dev)
    return spec, flat, x, g


def phase_path_checks(dev):
    """K2 at every shape of ``PATH_CASES`` held to its plain version: dx and
    every weight and bias gradient to autograd through the plain chain at
    the kernel's own relu gates (``chain_errs``, ``CHAIN_TOL``, no stray row),
    and its data pass to f32 products of its own stashes
    (``data_pass_check``).  K4 and K5 at their shape: ``phase_kernels_jac``.
    Returns {case: errors}."""
    from nunerf_tpu_torch.ops import fused_mlp as fm
    gen = torch.Generator(device="cpu").manual_seed(7)
    t_f, t_b = CHAIN_TOL[("fwd", "bfloat16")], CHAIN_TOL[("bwd", "bfloat16")]
    out, failed = {}, []
    for case in PATH_CASES:
        k, _, chain, n = case
        if k != "K2":
            continue
        spec, flat, x, g = case_inputs(fm, chain, n, dev, gen)
        y = fm.chain_fwd_cuda(spec, x, flat)
        dx, dflat = fm.chain_bwd_cuda(spec, x, g, flat)
        torch.cuda.synchronize()
        e = chain_errs(fm, spec, x, g, flat, (y, dx, dflat), t_b)
        e_f = max(e["fwd"], e["hidden"])
        dx_err, ulps = data_pass_check(fm, spec, x, g, flat, case_key(case))
        ok = e_f <= t_f and e["bwd"] <= t_b and e["stray_rows"] == 0
        out[case_key(case)] = dict(fwd_rel_err=e_f, bwd_rel_err=e["bwd"],
                                   flipped_rows=e["flipped_rows"],
                                   data_pass_dx_err=dx_err, data_pass_gz_ulps=ulps)
        log(f"{case_key(case)} {spec.dims} bf16: rel err y and hidden {e_f:.2e} (tol "
            f"{t_f:.0e}); dx and weight gradients at the kernel's gates {e['bwd']:.2e} "
            f"(tol {t_b:.0e}); a gate differs in {e['flipped_rows']} rows, "
            f"{e['stray_rows']} outlier rows without one; data pass dx {dx_err:.2e} (tol "
            f"1e-5), gz within {ulps:.2f} bf16 units (tol 1) {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(case_key(case))
        del y, dx, dflat, x, g, flat
    if failed:
        raise AssertionError(f"K2 disagrees with the plain chain at {failed}")
    return out


# the small call whose host time the parent's is held to, in alternating
# pairs beyond the main turns
HOST_CASE = ("K2", "head 72-3", head_chain(72, 3), 1024)
HOST_PAIRS = 4


def phase_chain_passes(dev, parent=None):
    """K2, K4 and K5 at the paths' shapes (``CHAIN_TIMER`` on ``PATH_CASES``),
    whole call, host time and each pass, beside each pass's floor
    (``pass_floors``); with ``parent`` the parent tree's kernels timed in
    turns with this tree's (parent, this, this, parent), and the host time
    of ``HOST_CASE`` in ``HOST_PAIRS`` alternating pairs; else this tree's
    once; the dW's ``torch.mm`` yardstick (``dw_library_ms``)."""
    from nunerf_tpu_torch.ops import fused_mlp as fm
    if parent:
        runs = [chain_timer(parent), chain_timer("."), chain_timer("."), chain_timer(parent)]
        here = runs[1:3]
        host = {"this": [r[case_key(HOST_CASE)]["host_ms"] for r in here],
                "parent": [runs[i][case_key(HOST_CASE)]["host_ms"] for i in (0, 3)]}
        for i in range(HOST_PAIRS - 2):
            for tree in ((".", parent) if i % 2 else (parent, ".")):
                r = chain_timer(tree, [HOST_CASE])[case_key(HOST_CASE)]
                host["this" if tree == "." else "parent"].append(r["host_ms"])
        log(f"{case_key(HOST_CASE)} host ms a call in {HOST_PAIRS} alternating pairs: this "
            + " / ".join(f"{t:.4f}" for t in host["this"]) + "; parent "
            + " / ".join(f"{t:.4f}" for t in host["parent"]))
        for what, i in (("this", 1), ("parent", 0)):
            log(f"{case_key(HOST_CASE)} {what}'s host ms by function (cProfile): "
                + json.dumps(runs[i][case_key(HOST_CASE)]["host_fns"]))
    else:
        here = [chain_timer(".")]
    value, full = (fm.ChainSpec(*sdf_chain(o), compute_dtype="bfloat16") for o in (1, 257))
    half = fm.JAC_CHUNK_ROWS
    lib_ms = {"K2 sdf value N=65536": dw_library_ms(fm, value, [65536], False, dev),
              "K5 sdf full N=131072": dw_library_ms(fm, full, [half, 131072 - half], True, dev)}
    floors = {"K2 sdf value N=65536": pass_floors(value, 65536, "K2"),
              "K4 sdf full N=131072": pass_floors(full, 131072, "K4"),
              "K5 sdf full N=131072": pass_floors(full, 131072, "K5")}
    out = {}
    for case in here[0]:
        r = dict(ms=[h[case]["ms"] for h in here], host_ms=[h[case]["host_ms"] for h in here],
                 passes=[by_pass(h[case]["kernels"]) for h in here],
                 kernels=here[0][case]["kernels"],
                 profile_tries=[h[case]["profile_tries"] for h in here])
        if parent:
            r["parent_ms"] = [runs[i][case]["ms"] for i in (0, 3)]
            r["parent_host_ms"] = [runs[i][case]["host_ms"] for i in (0, 3)]
            r["parent_passes"] = [by_pass(runs[i][case]["kernels"]) for i in (0, 3)]
            r["parent_profile_tries"] = [runs[i][case]["profile_tries"] for i in (0, 3)]
            if case == case_key(HOST_CASE):
                r["host_ms_pairs"] = host
        if case in floors:
            r["bound_ms"] = floors[case]
        if case in lib_ms:
            r["dw_library_ms"] = lib_ms[case]
        out[case] = r
        line = (f"{case}: call {' / '.join(f'{t:.4f}' for t in r['ms'])} ms, host "
                f"{' / '.join(f'{t:.4f}' for t in r['host_ms'])}"
                + (f" (parent {r['parent_ms'][0]:.4f} / {r['parent_ms'][1]:.4f}, host "
                   f"{r['parent_host_ms'][0]:.4f} / {r['parent_host_ms'][1]:.4f})"
                   if parent else ""))
        for p in r["passes"][0]:
            line += f"; {p} " + " / ".join(f"{q.get(p, float('nan')):.4f}" for q in r["passes"])
            if parent:
                line += (f" (parent {r['parent_passes'][0].get(p, float('nan')):.4f} / "
                         f"{r['parent_passes'][1].get(p, float('nan')):.4f})")
            if p in r.get("bound_ms", {}):
                line += f" floor {r['bound_ms'][p]:.4f}"
        if "dw_library_ms" in r:
            line += f"; dW's torch.mm yardstick {r['dw_library_ms']:.4f} ms"
        tries = r["profile_tries"] + r.get("parent_profile_tries", [])
        if max(tries) > 1:
            line += f"; profiled again after lost kernel events: tries {tries}"
        log(line)
    return out


def k1_main_shapes(fm, spec, flat, inputs, parent=None):
    """K1's bf16 forward on the value-only SDF chain at ``K1_MAIN_N``: held to
    the plain chain (``CHAIN_TOL``), then its device time from a pre-built
    pack, the wrapper's (``chain_fwd_cuda``, packing included) and the pack's
    own (``pack_wgmma``), CUDA events after warm-up, beside the bound and the
    share of it the kernel reaches; with ``parent``, the parent's kernel
    timed in turns with this one (parent, this, this, parent)."""
    lib = fm._lib()
    W, B = fm.pack_wgmma(spec, flat), fm._pack_biases(spec, flat)
    par = [parent_k1_ms(parent)] if parent else []
    rows, xs = [], {}
    for n in K1_MAIN_N:
        x = xs[n] = inputs(n)
        y = fm.chain_fwd_cuda(spec, x, flat)
        torch.cuda.synchronize()
        err = rel_err(y, fm.chain_mlp_reference(spec, x, *flat))
        if not (err <= CHAIN_TOL[("fwd", "bfloat16")] and bool(torch.isfinite(y).all())):
            raise AssertionError(f"K1 N={n}: rel err {err:.2e} over its tolerance")
        out = torch.empty_like(y)
        reps = max(5, min(100, 2 ** 23 // n))
        dev_ms = cuda_ms(lambda: fm._fwd_launch(lib, spec, x, W, B, out, None), reps)
        wrap_ms = cuda_ms(lambda: fm.chain_fwd_cuda(spec, x, flat), reps)
        pack_ms = cuda_ms(lambda: fm.pack_wgmma(spec, flat), reps)
        b, by = bound_ms(fm.chain_flops(spec, n), chain_bytes(spec, n), "bfloat16")
        rows.append(dict(n=n, rel_err=err, device_ms=dev_ms, wrapper_ms=wrap_ms,
                         pack_ms=pack_ms, bound_ms=b, bound_by=by, share=b / dev_ms))
    if parent:
        for r in rows:
            n = r["n"]
            out = torch.empty((n, 1), device=W.device)
            r["device_ms_again"] = cuda_ms(
                lambda: fm._fwd_launch(lib, spec, xs[n], W, B, out, None),
                max(5, min(100, 2 ** 23 // n)))
        par.append(parent_k1_ms(parent))
        for r in rows:
            r["parent_ms"] = [p[r["n"]] for p in par]
    for r in rows:
        extra = ""
        if parent:
            extra = (f"; again {r['device_ms_again']:.4f} ms; parent's kernel "
                     f"{r['parent_ms'][0]:.4f} / {r['parent_ms'][1]:.4f} ms")
        log(f"K1 sdf value N={r['n']} bf16: rel err {r['rel_err']:.2e}; kernel {r['device_ms']:.4f} "
            f"ms, wrapper {r['wrapper_ms']:.4f} ms, pack {r['pack_ms']:.4f} ms; bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), share {r['share']:.3f}{extra}")
    return rows


def phase_kernels(renderer, dev, parent=None):
    """K1 and K2 against their plain versions at the main path's shapes."""
    from nunerf_tpu_torch.fields.sdf import _sdf_chain
    from nunerf_tpu_torch.ops import fused_mlp as fm

    gen = torch.Generator(device="cpu").manual_seed(1)
    with torch.no_grad():
        spec_full, flat_full = _sdf_chain(renderer.sdf_net, dev)
        flat_full = [f.detach().contiguous() for f in flat_full]
    nw = fm.n_weights(spec_full)
    flat_val = list(flat_full)
    flat_val[nw - 1] = flat_full[nw - 1][:, :1].contiguous()
    flat_val[-1] = flat_full[-1][:, :1].contiguous()

    def with_dtype(spec, out, cd):
        return fm.ChainSpec(spec.dims[:-1] + (out,), spec.acts, spec.has_skip,
                            spec.scales, compute_dtype=cd)

    def inputs(n):
        pts = (torch.rand((n, 3), generator=gen) * 2 - 1).to(dev)
        return renderer.sdf_net.embed(pts).float().contiguous()

    tol = CHAIN_TOL
    rec = {}
    for n in (65536, 131072):
        x = inputs(n)
        for out, flat in ((1, flat_val), (257, flat_full)):
            if out == 257 and n == 131072:
                continue
            for cd in ("bfloat16", "float32"):
                spec = with_dtype(spec_full, out, cd)
                y = fm.chain_fwd_cuda(spec, x, flat)
                torch.cuda.synchronize()
                y_ref = fm.chain_mlp_reference(spec, x, *flat)
                err = rel_err(y, y_ref)
                ok = err <= tol[("fwd", cd)]
                log(f"K1 sdf chain N={n} out={out} {cd}: rel err {err:.2e} "
                    f"(tol {tol[('fwd', cd)]:.0e}) {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError("K1 disagrees with its plain version")
                if out == 1 and cd == "bfloat16" and n == 131072:
                    ms = cuda_ms(lambda: fm.chain_fwd_cuda(spec, x, flat), 10)
                    plain = cuda_ms(lambda: fm.chain_mlp_reference(spec, x, *flat), 10)
                    b, by = bound_ms(fm.chain_flops(spec, n), chain_bytes(spec, n), cd)
                    rec["K1"] = dict(max_abs_err=float((y - y_ref).abs().max()),
                                     max_rel_err=err, tol=tol[("fwd", cd)],
                                     ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                                     shape=f"SDF value-only chain, N={n}, bf16")
                    log(f"K1 N={n} bf16: {ms:.3f} ms, plain {plain:.3f} ms, "
                        f"bound {b:.4f} ms ({by})")
                    shapes = k1_main_shapes(fm, spec, flat, inputs, parent)
                    main = next(r for r in shapes if r["n"] == n)
                    rec["K1"].update(kernel="chain_fwd_wgmma_kernel",
                                     device_ms=main["device_ms"], share=main["share"],
                                     by_shape=shapes)

    relu = fm.ChainSpec((131, 256, 256, 256, 3), ("relu",) * 3 + ("none",),
                        (False,) * 4, (1.0,) * 4)
    relu_flat = [(torch.randn(s, generator=gen) / math.sqrt(s[0])).to(dev)
                 for s in fm.flat_weight_shapes(relu)]
    relu_flat += [(torch.randn((1, d), generator=gen) * 0.1).to(dev) for d in relu.dims[1:]]
    n = 65536
    x_sdf = inputs(n)
    cases = [(with_dtype(spec_full, 1, "bfloat16"), x_sdf, flat_val, "sdf bf16"),
             (with_dtype(spec_full, 1, "float32"), x_sdf, flat_val, "sdf f32"),
             (relu, torch.randn((n, 131), generator=gen).to(dev), relu_flat, "relu4 f32")]
    for spec, x, flat, what in cases:
        g = torch.randn((n, spec.dims[-1]), generator=gen).to(dev)
        dx, dflat = fm.chain_bwd_cuda(spec, x, g, flat)
        torch.cuda.synchronize()
        leaves = [x.clone().requires_grad_(True)] + [f.clone().requires_grad_(True) for f in flat]

        def plain_grads():
            y = fm.chain_mlp_reference(spec, *leaves)
            return torch.autograd.grad(torch.sum(y * g), leaves)

        ref = plain_grads()
        errs = [rel_err(a, b) for a, b in zip((dx,) + dflat, ref)]
        t = tol[("bwd", spec.compute_dtype)]
        ok = max(errs) <= t
        log(f"K2 {what} N={n}: worst rel err {max(errs):.2e} over {len(errs)} "
            f"grads (tol {t:.0e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("K2 disagrees with autograd through its plain version")
        if what == "sdf bf16":
            dx_err, ulps = data_pass_check(fm, spec, x, g, flat, what)
            log(f"K2 {what} N={n}: data pass against f32 products of its own stashes: "
                f"dx {dx_err:.2e} (tol 1e-5), gz within {ulps:.2f} bf16 units (tol 1)")
            probe = split_probe_check(fm, dev)
            log(f"K2 split probes {SPLIT_PROBES}, N=1000: dx within {probe:.0f} units of the "
                "last place of the f32 weights (tol 1)")
            ms = cuda_ms(lambda: fm.chain_bwd_cuda(spec, x, g, flat), 5)
            plain = cuda_ms(plain_grads, 5)
            nbytes = 4 * (2 * x.numel() + g.numel()) + 2 * chain_bytes(spec, 0)
            b, by = bound_ms(3 * fm.chain_flops(spec, n), nbytes, spec.compute_dtype)
            rec["K2"] = dict(max_abs_err=max(float((a - r).abs().max())
                                             for a, r in zip((dx,) + dflat, ref)),
                             max_rel_err=max(errs), tol=t,
                             ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                             data_pass_dx_err=dx_err, data_pass_gz_ulps=ulps,
                             split_probe_f32_units=probe,
                             shape=f"SDF value-only chain, N={n}, bf16")
            log(f"K2 N={n} bf16: {ms:.3f} ms, plain (autograd fwd+bwd) "
                f"{plain:.3f} ms, bound {b:.4f} ms ({by})")
    return rec


def jac_flops(spec, n):
    """Matmul FLOPs of K4 over ``n`` rows: the forward, and the J-pass over
    every layer but the last (whose column 0 only seeds it)."""
    from nunerf_tpu_torch.ops.fused_mlp import flat_weight_shapes
    shapes = flat_weight_shapes(spec)
    last = 2 if spec.has_skip[-1] else 1
    return 2 * n * (sum(a * b for a, b in shapes)
                    + sum(a * b for a, b in shapes[:-last]))


def phase_kernels_jac(renderer, dev):
    """K4 against its plain version (y, j) and K5 against autograd through
    that plain version (dx, every dW, every db) at the full SDF chain,
    N = 131,072 (1024 rays x 128 samples), f32 and bf16."""
    from nunerf_tpu_torch.fields.sdf import _sdf_chain
    from nunerf_tpu_torch.ops import fused_mlp as fm

    gen = torch.Generator(device="cpu").manual_seed(2)
    with torch.no_grad():
        spec0, flat = _sdf_chain(renderer.sdf_net, dev)
        flat = [f.detach().contiguous() for f in flat]
    n = 131072
    pts = (torch.rand((n, 3), generator=gen) * 2 - 1).to(dev)
    x = renderer.sdf_net.embed(pts).float().contiguous()
    gy = torch.randn((n, spec0.dims[-1]), generator=gen).to(dev)
    gj = torch.randn((n, spec0.dims[0]), generator=gen).to(dev)
    rec = {}
    for cd in ("float32", "bfloat16"):
        spec = fm.ChainSpec(spec0.dims, spec0.acts, spec0.has_skip, spec0.scales,
                            compute_dtype=cd)
        y, j = fm.chain_jac_fwd_cuda(spec, x, flat)
        dx, dflat = fm.chain_jac_bwd_cuda(spec, x, gy, gj, flat)
        torch.cuda.synchronize()
        leaves = [x.clone().requires_grad_(True)] + [f.clone().requires_grad_(True)
                                                     for f in flat]

        def plain_fwd():
            with torch.no_grad():
                return fm.chain_mlp_with_grad0_reference(spec, x, *flat)

        def plain_grads():
            yr, jr = fm.chain_mlp_with_grad0_reference(spec, *leaves)
            return torch.autograd.grad(torch.sum(yr * gy) + torch.sum(jr * gj), leaves)

        y_ref, j_ref = plain_fwd()
        ref = plain_grads()
        e_y, e_j = rel_err(y, y_ref), rel_err(j, j_ref)
        errs = [rel_err(a, b) for a, b in zip((dx,) + dflat, ref)]
        t_y, t_g = CHAIN_TOL[("fwd", cd)], CHAIN_TOL[("bwd", cd)]
        ok = e_y <= t_y and e_j <= t_g and max(errs) <= t_g
        log(f"K4 sdf chain N={n} {cd}: rel err y {e_y:.2e} (tol {t_y:.0e}), "
            f"j {e_j:.2e} (tol {t_g:.0e}); K5: worst rel err {max(errs):.2e} over "
            f"{len(errs)} grads (tol {t_g:.0e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("K4/K5 disagree with their plain version: "
                                 f"y {e_y}, j {e_j}, grads {errs}")
        abs5 = max(float((a - r).abs().max()) for a, r in zip((dx,) + dflat, ref))
        del ref
        if cd != "bfloat16":
            continue
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ms4 = cuda_ms(lambda: fm.chain_jac_fwd_cuda(spec, x, flat), 5)
        ms5 = cuda_ms(lambda: fm.chain_jac_bwd_cuda(spec, x, gy, gj, flat), 3)
        scratch = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        plain4 = cuda_ms(plain_fwd, 5)
        plain5 = cuda_ms(plain_grads, 3)
        w_bytes = 2 * chain_bytes(spec, 0)   # rounded weights and their transposes
        b4, by4 = bound_ms(jac_flops(spec, n),
                           4 * (2 * x.numel() + y.numel()) + w_bytes, cd)
        b5, by5 = bound_ms(3 * jac_flops(spec, n),
                           4 * (3 * x.numel() + gy.numel()) + 2 * w_bytes, cd)
        shape = f"full SDF chain {spec.dims}, N={n}, bf16"
        floor_ms, floor_bytes = stash_floor_ms(spec, n)
        rec["K4"] = dict(max_abs_err=max(float((y - y_ref).abs().max()),
                                         float((j - j_ref).abs().max())),
                         max_rel_err=max(e_y, e_j), tol=t_g, ms=ms4, plain_ms=plain4,
                         bound_ms=b4, bound_by=by4, shape=shape)
        rec["K5"] = dict(max_abs_err=abs5, max_rel_err=max(errs), tol=t_g, ms=ms5, plain_ms=plain5,
                         bound_ms=b5, bound_by=by5, shape=shape,
                         scratch_gib=scratch)
        log(f"K4 N={n} bf16: {ms4:.3f} ms, plain {plain4:.3f} ms, bound {b4:.4f} ms "
            f"({by4}); K5: {ms5:.3f} ms, plain (autograd through K4's plain version) "
            f"{plain5:.3f} ms, bound {b5:.4f} ms ({by5}); peak scratch of the two "
            f"{scratch:.2f} GiB; K5's stash traffic floor {floor_ms:.3f} ms "
            f"({floor_bytes / 1e9:.2f} GB written once and read once a consuming pass)")
    return rec


def stash_floor_ms(spec, n):
    """The least time K5's pass structure could take on its scratch stashes
    (bf16 route): every stash element written once and read once by each pass
    that consumes it, at the card's memory rate.  h is written by pass 1 and
    read by the J-pass, its reverse, the data pass and dW; q (f32) written by
    the J-pass, read by its reverse; p and qbar (bf16) written there, read by
    dW; dbar (f32) written there, read by the data pass; zs (bf16, all
    layers) written by the data pass, read by dW."""
    from nunerf_tpu_torch.ops.fused_mlp import mma_layout
    lay = mma_layout(spec)
    per_row = lay.psum_hidden * (2 * 5 + 4 * 2 + 2 * 2 + 4 * 2 + 2 * 2) + lay.psum * 2 * 2
    return n * per_row / PEAK_BYTES * 1e3, n * per_row


def phase_kernels_odd(renderer, dev):
    """K1, K2, K4 and K5 against their plain versions at the shapes that can
    break a tiled MMA: ragged and single-row tiles (N = 1, 63, 65, 1000), the
    39-, 84-, 131-, 259- and 512-wide inputs, the 217-deep layer after the
    NeuS skip, last layers of 1, 3, 64 and 257 columns with no activation, a
    relu or a softplus; f32 and bf16, and K2's bf16 data pass against f32
    products of its own stashes."""
    from nunerf_tpu_torch.fields.mlp import Predictor
    from nunerf_tpu_torch.fields.sdf import _sdf_chain
    from nunerf_tpu_torch.ops import fused_mlp as fm

    gen = torch.Generator(device="cpu").manual_seed(6)
    with torch.no_grad():
        spec_full, flat_full = _sdf_chain(renderer.sdf_net, dev)
        flat_full = [f.detach().contiguous() for f in flat_full]
        head = Predictor(259, 3, dtype=torch.bfloat16, device=dev)
        head.reset_parameters(gen)
        spec_head, flat_head = head.chain()
    nw = fm.n_weights(spec_full)
    flat_val = list(flat_full)
    flat_val[nw - 1] = flat_full[nw - 1][:, :1].contiguous()
    flat_val[-1] = flat_full[-1][:, :1].contiguous()
    spec_val = fm.ChainSpec(spec_full.dims[:-1] + (1,), spec_full.acts,
                            spec_full.has_skip, spec_full.scales)
    def random_chain(dims, skip, last=None, scale=1.0, rng=gen):
        n_l = len(dims) - 1
        last = last or ("none" if dims[-1] == 3 else "relu")
        spec = fm.ChainSpec(dims, ("relu",) * (n_l - 1) + (last,), skip,
                            (1.0,) * (n_l - 1) + (scale,))
        flat = [(torch.randn(s, generator=rng) / math.sqrt(s[0])).to(dev)
                for s in fm.flat_weight_shapes(spec)]
        return spec, flat + [(torch.randn((1, d), generator=rng) * 0.1).to(dev)
                             for d in dims[1:]]

    # the last two chains draw from a generator of their own, so that the
    # chains before them keep their inputs
    gen7 = torch.Generator(device="cpu").manual_seed(7)

    # the trunk's 84-wide input and post-activation skip on a 3-layer cut (the
    # full trunk is held at N = 131,072 by phase_kernels_heads); the widest
    # input K1/K2 take; a softplus last layer (relu: the trunk cut and the
    # 512-wide chain; none: the rest)
    chains = [("sdf value", spec_val, flat_val),
              ("sdf full", spec_full, flat_full),
              ("head 259", spec_head, flat_head),
              ("relu 131", *random_chain((131, 256, 256, 256, 3), (False,) * 4)),
              ("NeRF++ trunk cut", *random_chain((84, 256, 256, 256), (False, False, True))),
              ("input 512", *random_chain((512, 256, 256, 64), (False,) * 3, rng=gen7)),
              ("softplus out", *random_chain((259, 256, 257), (False,) * 2, "softplus100",
                                             0.5, rng=gen7))]
    worst, rows, own, failed = {}, {}, {}, []
    data_pass = [0.0, 0.0]
    for what, spec0, flat in chains:
        flat = [f.detach().float().contiguous() for f in flat]
        n_failed = len(failed)
        for n in (1, 63, 65, 1000):
            if spec0.dims[0] == 39:
                pts = (torch.rand((n, 3), generator=gen) * 2 - 1).to(dev)
                x = renderer.sdf_net.embed(pts).float().contiguous()
            else:
                x = torch.randn((n, spec0.dims[0]), generator=gen).to(dev)
            g = torch.randn((n, spec0.dims[-1]), generator=gen).to(dev)
            gj = torch.randn((n, spec0.dims[0]), generator=gen).to(dev)
            for cd in ("float32", "bfloat16"):
                spec = fm.ChainSpec(spec0.dims, spec0.acts, spec0.has_skip,
                                    spec0.scales, compute_dtype=cd)
                t_f, t_b = CHAIN_TOL[("fwd", cd)], CHAIN_TOL[("bwd", cd)]
                y = fm.chain_fwd_cuda(spec, x, flat)
                dx, dflat = fm.chain_bwd_cuda(spec, x, g, flat)
                torch.cuda.synchronize()
                e = chain_errs(fm, spec, x, g, flat, (y, dx, dflat), t_b)
                for k in ("flipped_rows", "outlier_rows", "stray_rows"):
                    rows[(k, cd)] = rows.get((k, cd), 0) + e[k]
                own[cd] = max(own.get(cd, 0.0), e["bwd_own_gates"])
                errs = {"K1": (max(e["fwd"], e["hidden"]), t_f), "K2": (e["bwd"], t_b)}
                if cd == "bfloat16":
                    dx_err, ulps = data_pass_check(fm, spec, x, g, flat,
                                                   f"{what} {spec.dims} N={n}")
                    data_pass = [max(data_pass[0], dx_err), max(data_pass[1], ulps)]
                if e["stray_rows"]:
                    failed.append(f"K2 {what} {spec.dims} N={n} {cd}: dx of "
                                  f"{e['stray_rows']} rows is off by more than {t_b:.0e} "
                                  "and no relu gate differs in them")
                if what == "sdf full":
                    leaves = [x.clone().requires_grad_(True)] + [
                        f.clone().requires_grad_(True) for f in flat]
                    yr, jr = fm.chain_mlp_with_grad0_reference(spec, *leaves)
                    ref5 = torch.autograd.grad(torch.sum(yr * g) + torch.sum(jr * gj), leaves)
                    y4, j4 = fm.chain_jac_fwd_cuda(spec, x, flat)
                    dx5, dflat5 = fm.chain_jac_bwd_cuda(spec, x, g, gj, flat)
                    torch.cuda.synchronize()
                    errs["K4"] = (max(rel_err(y4, yr.detach()) * t_b / t_f,
                                      rel_err(j4, jr.detach())), t_b)
                    errs["K5"] = (max(rel_err(a, b) for a, b in zip((dx5,) + dflat5, ref5)),
                                  t_b)
                for k, (e_k, t) in errs.items():
                    worst[(k, cd)] = max(worst.get((k, cd), 0.0), e_k / t)
                    if not e_k <= t:
                        failed.append(f"{k} {what} {spec.dims} N={n} {cd}: rel err "
                                      f"{e_k:.2e} over its tolerance {t:.0e}")
        log(f"odd shapes, {what} {spec0.dims}, N=1/63/65/1000, f32 and bf16: "
            f"{'ok' if len(failed) == n_failed else 'FAIL'}")
    log(f"odd shapes, K2 bf16 data pass against f32 products of its own stashes: dx "
        f"{data_pass[0]:.2e} (tol 1e-5), gz within {data_pass[1]:.2f} bf16 units (tol 1)")
    log("odd shapes: worst error as a share of its tolerance " +
        ", ".join(f"{k} {cd} {v:.2f}" for (k, cd), v in sorted(worst.items())))
    for cd in ("float32", "bfloat16"):
        log(f"odd shapes, {cd}: a relu gate differs from the plain chain's in "
            f"{rows[('flipped_rows', cd)]} rows; against autograd at the plain chain's "
            f"own gates K2's worst rel err is {own[cd]:.2e} and dx is off by more than "
            f"{CHAIN_TOL[('bwd', cd)]:.0e} in {rows[('outlier_rows', cd)]} rows, "
            f"{rows[('stray_rows', cd)]} of them without a differing gate")
    if failed:
        raise AssertionError("; ".join(failed))


def phase_kernels_heads(dev):
    """K1 and K2 at the shapes the ``fused_mlp`` gate gives them: a material
    head (259 inputs, wider than the hidden layers) and the NeRF++ trunk
    (84 inputs, a post-activation skip), bf16 as ``BENCH_CFG`` runs them,
    N = 131,072; held to the plain chain, and timed beside the plain modules
    (cuBLAS, the route the step takes with the gate off)."""
    from nunerf_tpu_torch.fields.mlp import Predictor
    from nunerf_tpu_torch.fields.nerf import NeRFNetwork
    from nunerf_tpu_torch.ops import fused_mlp as fm
    from nunerf_tpu_torch.ops.embedder import posenc

    gen = torch.Generator(device="cpu").manual_seed(4)
    n = 131072
    head = Predictor(259, 3, dtype=torch.bfloat16, device=dev)
    head.reset_parameters(gen)
    nerf = NeRFNetwork(dtype=torch.bfloat16, device=dev)
    nerf.reset_parameters(gen)
    pts4 = torch.randn((n, 4), generator=gen).to(dev)
    with torch.no_grad():
        cases = [("head 259", head, *head.chain(),
                  torch.randn((n, 259), generator=gen).to(dev)),
                 ("NeRF++ trunk", nerf, *nerf.trunk_chain(),
                  posenc(pts4, nerf.multires).contiguous())]

    # Backward errors of these relu chains are taken at the kernel's own gates
    # (``chain_errs``).  At 131,072 rows x 768-2,048 units some gates always
    # differ from the plain chain's: in f32 with the order of the sums (the
    # plain f32 version sits as far from a float64 evaluation as the kernel
    # does there), in bf16 also where a hidden activation rounds the other
    # way.  Against the same gates every row of dx and every weight gradient
    # is held by its largest error, to the chain tolerances of both dtypes.
    out, failed = [], []
    for what, mod, spec16, flat, x in cases:
        flat = [f.detach().contiguous() for f in flat]
        x_in = x if mod is head else pts4
        g = torch.randn((n, spec16.dims[-1]), generator=gen).to(dev)
        for cd in ("float32", "bfloat16"):
            spec = fm.ChainSpec(spec16.dims, spec16.acts, spec16.has_skip,
                                spec16.scales, compute_dtype=cd)
            y = fm.chain_fwd_cuda(spec, x, flat)
            dx, dflat = fm.chain_bwd_cuda(spec, x, g, flat)
            torch.cuda.synchronize()
            t_f, t_b = CHAIN_TOL[("fwd", cd)], CHAIN_TOL[("bwd", cd)]
            e = chain_errs(fm, spec, x, g, flat, (y, dx, dflat), t_b)
            e_f, e_b = max(e["fwd"], e["hidden"]), e["bwd"]
            ok = e_f <= t_f and e_b <= t_b and e["stray_rows"] == 0
            if cd == "bfloat16":
                dx_err, ulps = data_pass_check(fm, spec, x, g, flat, what)
                log(f"K2 {what} bf16 data pass against f32 products of its own stashes: "
                    f"dx {dx_err:.2e} (tol 1e-5), gz within {ulps:.2f} bf16 units (tol 1)")
            log(f"K1/K2 {what} {spec.dims} {cd} N={n}: rel err y {e['fwd']:.2e}, hidden "
                f"activations {e['hidden']:.2e} (tol {t_f:.0e}); dx and weight gradients "
                f"at the kernel's gates {e_b:.2e} (tol {t_b:.0e}); a gate differs from "
                f"the plain chain's in {e['flipped_rows']} rows; against autograd at the "
                f"plain chain's own gates {e['bwd_own_gates']:.2e}, dx off by more than "
                f"{t_b:.0e} in {e['outlier_rows']} rows, {e['stray_rows']} of them "
                f"without a differing gate {'ok' if ok else 'FAIL'}")
            if not ok:
                failed.append(f"{what} {cd}")
        # timed in bf16, the loop's last spec, as the step runs these chains

        def module_fwd():
            with torch.no_grad():
                return mod(x_in) if mod is head else mod._trunk(x_in)

        def module_fwd_bwd():
            o = mod(x_in) if mod is head else mod._trunk(x_in)
            torch.autograd.grad(torch.sum(o.float() * (g if mod is head else 1.0)),
                                list(mod.parameters()), allow_unused=True)

        k1 = cuda_ms(lambda: fm.chain_fwd_cuda(spec, x, flat), 5)
        k2 = cuda_ms(lambda: fm.chain_bwd_cuda(spec, x, g, flat), 3)
        m1 = cuda_ms(module_fwd, 5)
        m2 = cuda_ms(module_fwd_bwd, 3)
        b1, _ = bound_ms(fm.chain_flops(spec, n), chain_bytes(spec, n), cd)
        nbytes = 4 * (2 * x.numel() + g.numel()) + 2 * chain_bytes(spec, 0)
        b2, _ = bound_ms(3 * fm.chain_flops(spec, n), nbytes, cd)
        out.append(dict(shape=f"{what} {spec.dims}, N={n}, {cd}", k1_ms=k1, k1_bound_ms=b1,
                        module_fwd_ms=m1, k2_ms=k2, k2_bound_ms=b2,
                        module_fwd_bwd_ms=m2, fwd_rel_err=e_f, bwd_rel_err=e_b))
        log(f"K1 {what}: {k1:.3f} ms (bound {b1:.4f}), plain module forward {m1:.3f} "
            f"ms; K2: {k2:.3f} ms (bound {b2:.4f}), plain module forward+backward "
            f"{m2:.3f} ms")
    if failed:
        raise AssertionError(f"K1/K2 disagree with the plain chain at {failed}")
    return out


def k3_bound(ri, index, rn, stats):
    """The least time of the flat culled work this run's rays needed, and
    what bounds it: every (ray, tile) box test and every ray-triangle pair
    swept (the kernel's own counts) at the f32 peak without tensor cores,
    against the rays, the index and the outputs (t, index, hit) moved once.
    Kept beside ``k3_bound_two_level`` so that the row stays comparable
    with the flat index's."""
    n_tiles = index.box.shape[0]
    flops = rn * n_tiles * ri.OPS_PER_BOX + int(stats[1]) * ri.OPS_PER_PAIR
    nbytes = 24 * rn + 40 * index.v0.shape[0] + 24 * n_tiles + 9 * rn
    return bound_ms(flops, nbytes, "float32")


def k3_bound_two_level(ri, index, ro, rd, stats):
    """The least time of the two-level culled work of these rays: every
    (ray, group) box test, the tile box tests of the groups that pass (the
    plain group test on these rays) and every ray-triangle pair swept (the
    kernel's count), at the f32 peak, against the rays, the index with its
    group boxes and the outputs moved once.  Returns (ms, what bounds it,
    the tile box tests)."""
    n_tiles, n_groups, g = index.box.shape[0], index.gbox.shape[0], index.group
    sizes = torch.clamp(n_tiles - g * torch.arange(n_groups, device=ro.device), max=g)
    tile_tests = sum(int((ri.group_candidates_reference(ro[i:i + 16384], rd[i:i + 16384],
                                                        index).long() * sizes).sum())
                     for i in range(0, ro.shape[0], 16384))
    rn = ro.shape[0]
    flops = ((rn * n_groups + tile_tests) * ri.OPS_PER_BOX
             + int(stats[1]) * ri.OPS_PER_PAIR)
    nbytes = 24 * rn + 40 * index.v0.shape[0] + 24 * (n_tiles + n_groups) + 9 * rn
    return (*bound_ms(flops, nbytes, "float32"), tile_tests)


def sweep_agreement(got, ref, ro, rd, tri, what, strict=True):
    """K3's answer ``got`` (t, index, hit) against a tolerant sweep's
    ``ref`` (``tracing/intersect.py``), as ``tests/test_pallas_intersect.py``
    holds the JAX pair: ``hit`` equal on every ray, and where both hit ``t``
    within rtol 1e-6 and the index equal, but for a tie: the sweep's own
    ``t`` for K3's triangle equals its chosen ``t`` within rtol 1e-6 (a
    shared edge reached at the same depth).  Raises on a ``hit`` that
    differs, and with ``strict`` on any other disagreement; returns the
    counts, and over the rays that disagree otherwise than by a tie the
    largest error of each side's f32 ``t`` against its own triangle's ``t`` in
    float64 (``k3_t_err_f64``, ``sweep_t_err_f64``, relative): which of the
    two is off, or both (an ill-conditioned hit)."""
    from nunerf_tpu_torch.tracing import intersect as ti

    t, idx, hit = got
    both = hit & ref.hit
    differ = both & (idx != ref.tri_idx)
    i = idx[differ].long()
    t_own = ti._mt_per_ray(ro[differ], rd[differ], tri[0][i][:, None], tri[1][i][:, None],
                           tri[2][i][:, None])[:, 0]
    tie = (t_own - ref.t[differ]).abs() <= 1e-6 * ref.t[differ].abs()
    rel = (t - ref.t).abs() / ref.t.abs()
    off = both & (rel > 1e-6)
    off[torch.nonzero(differ)[:, 0][~tie]] = True
    o64, d64 = ro[off].double(), rd[off].double()

    def err64(t32, i):
        v0, e1, e2 = (a[i.long()].double() for a in tri)
        det = (torch.linalg.cross(d64, e2) * e1).sum(-1)
        t64 = (torch.linalg.cross(o64 - v0, e1) * e2).sum(-1) / det
        return float(((t32.double() - t64).abs() / t64.abs()).max()) if bool(off.any()) else 0.0
    c = {"hit_differs": int((hit != ref.hit).sum()), "index_differs": int(differ.sum()),
         "ties": int(tie.sum()), "t_off": int((both & (rel > 1e-6)).sum()),
         "t_rel_max": float(rel[both].max()) if bool(both.any()) else 0.0,
         "disagreeing_rays": int(off.sum()),
         "k3_t_err_f64": err64(t[off], idx[off]),
         "sweep_t_err_f64": err64(ref.t[off], ref.tri_idx[off])}
    if c["hit_differs"] or (strict and c["disagreeing_rays"]):
        raise AssertionError(f"{what} and K3 disagree: {c}")
    return c


def phase_kernel_k3(scene, dev):
    """K3, a warp a ray over the scene's two-level index, against its plain version on
    the full-width mesh, in the scene's tolerant mode (the barycentric
    tolerance of the brute sweep and of the JAX package's default closest
    hit) and in the exact mode (the Pallas kernel's): ``t``, index and ``hit``
    bit-equal to the plain version of the same mode (the kernel multiplies
    and adds without FMA contraction, one rounding an operation as the plain
    version) at R = 1024 and 5000, on a fixed 8,192-ray subset of R = 131,072
    (a ray's answer does not depend on the other rays), and on an adversarial
    box mesh; the tolerant mode against the port's brute sweep and culled
    descent at R = 1024 and on the adversarial box (``sweep_agreement``:
    ``hit`` equal on every ray, no allowance; ``t`` within rtol 1e-6 and the
    index equal but for ties), and against the brute sweep at R = 131,072
    (``hit`` held; rays whose ``t`` or index differ otherwise counted, with
    how grazing they are: the two sweeps order their operations apart, and a
    grazing hit's f32 ``t`` is ill-conditioned); the kernel's candidates
    against the plain box test, exactly; the pairs it tested and the bounds
    of the flat and the two-level culled work beside the brute sweep's; its
    time in both modes and its device time by kernel."""
    from nunerf_tpu_torch.ops import ray_intersect as ri
    from nunerf_tpu_torch.tracing import intersect as ti
    from nunerf_tpu_torch.tracing.probes import adversarial_rays, box_mesh

    n_tris = len(scene.tris_np)
    tri = (scene.v0, scene.e1, scene.e2)
    index = scene.kernel_index
    tol = scene.kernel_tol
    if tol != ri.BARY_TOL:
        raise AssertionError(f"the scene's K3 mode is tol={tol}, not the sweeps' {ri.BARY_TOL}")
    modes = {"tolerant": tol, "exact": 0.0}
    # the tile index the scene would build with the kernel off, to time the
    # culled descent beside K3
    cull_tile, group = ti.auto_tile_params(n_tris)
    descent_index = ti.build_tile_index(scene.verts_np, scene.tris_np, tile=cull_tile,
                                        group=group, device=dev)
    rec = {"mode": f"tolerant (barycentric tolerance {tol:g}, the scene's default); "
                   "exact (0) also held and timed"}
    for rn in (1024, 5000, 131072):
        ro, rd, kind = intersect_rays(rn, rn, dev)
        sub = (torch.arange(rn, device=dev) if rn <= 5000 else
               torch.as_tensor(np.random.RandomState(5).choice(rn, 8192, replace=False),
                               device=dev))
        kind = torch.as_tensor(kind, device=dev)
        for mode, mtol in modes.items():
            stats = torch.zeros(2, dtype=torch.int64, device=dev)
            got = ri.closest_hit_cuda(ro, rd, index, stats=stats, tol=mtol)
            t, idx, hit = got
            torch.cuda.synchronize()
            rt, ridx, rhit = ri.closest_hit_reference(ro[sub], rd[sub], *tri, tol=mtol)
            share = [float(hit[kind == j].double().mean()) for j in range(3)]
            same = (torch.equal(t[sub], rt) and torch.equal(idx[sub], ridx)
                    and torch.equal(hit[sub], rhit))
            err = float((t[sub] - rt).abs().max())
            pairs, tests = int(stats[0]), int(stats[1])
            log(f"K3 culled closest hit, {mode} mode, R={rn} T={n_tris} "
                f"({index.box.shape[0]} tiles of {index.tile}): {len(sub)} rays held, hit "
                f"share outside/inside/away {share[0]:.3f}/{share[1]:.3f}/{share[2]:.3f}, max "
                f"|t - plain| {err:.1e}, index and hit {'equal' if same else 'DIFFER'} "
                f"(held exactly); (ray, tile) pairs passed {pairs} ({pairs / rn:.1f} a ray), "
                f"ray-triangle pairs tested {tests} ({tests / rn:.0f} a ray, brute {n_tris})")
            if not same:
                bad = (int((idx[sub] != ridx).sum()), int((hit[sub] != rhit).sum()),
                       int((t[sub] != rt).sum()))
                raise AssertionError(f"K3 ({mode}) disagrees with its plain version: {bad} "
                                     "(index, hit, t) rays differ")
            if not (share[0] > 0.9 and bool(hit[kind == 1].all())
                    and not bool(hit[kind == 2].any())):
                raise AssertionError(f"K3 hit shares {share}: expected hits from outside "
                                     "and inside, none pointing away")
            if not (bool((idx[~hit] == 0).all()) and bool((t[~hit] == ri.MISS_T).all())):
                raise AssertionError("K3 missed lanes do not carry (MISS_T, 0)")
            if mode == "tolerant":
                got_tol, err_tol, pairs_tol, tests_tol = got, err, pairs, tests
        if rn == 5000:
            cand = ri.cull_candidates_cuda(ro, rd, index)
            plain = ri.cull_candidates_reference(ro, rd, index)
            torch.cuda.synchronize()
            if not torch.equal(plain, cand) or int(cand.sum()) != pairs_tol:
                raise AssertionError("K3's candidates differ from the plain box test's, or "
                                     "its count disagrees with them")
            log(f"K3 R={rn}: the kernel's walk over {index.gbox.shape[0]} groups finds the "
                f"{int(plain.sum())} pairs of the plain box test, no more ({int(cand.sum())})")
        if rn == 1024:
            # the brute sweep and the culled descent answer the same query
            # with the same tolerance
            brute = ti.ray_mesh_intersect(ro, rd, *tri, tile=scene.tile)
            rounds = []
            culled = ti.ray_mesh_intersect_culled(ro, rd, descent_index, group=group,
                                                  rounds_out=rounds)
            for name, other in (("brute sweep", brute), ("culled descent", culled)):
                c = sweep_agreement(got_tol, other, ro, rd, tri, f"{name} R={rn}")
                rec[f"{name.replace(' ', '_')}_agreement"] = c
                log(f"K3 tolerant vs the {name}, R={rn}: {c} (hit equal on every ray, t "
                    "within rtol 1e-6, index equal but for the ties)")
        if rn == 131072:
            brute = ti.Hit(*(torch.cat(x) for x in zip(*(
                ti.ray_mesh_intersect(ro[i:i + 8192], rd[i:i + 8192], *tri, tile=scene.tile)
                for i in range(0, rn, 8192)))))
            c = sweep_agreement(got_tol, brute, ro, rd, tri, f"brute sweep R={rn}",
                                strict=False)
            rec["brute_sweep_agreement_r131072"] = c
            log(f"K3 tolerant vs the brute sweep, R={rn}: {c} (hit equal on every ray; the "
                "rays whose t or index differ otherwise than by a tie counted, with each "
                "side's largest error of t against float64 on them)")
        if rn in (1024, 131072):
            ms = {m: cuda_ms(lambda: ri.closest_hit_cuda(ro, rd, index, tol=mt), 20)
                  for m, mt in modes.items()}
            plain_ms = cuda_ms(lambda: ri.closest_hit_reference(ro, rd, *tri, tol=tol), 2) \
                if rn == 1024 else None
            # the brute sweep's bound: every pair at 46 f32 ops a pair, the
            # mesh's own triangles and the rays read once
            brute_b, _ = bound_ms(rn * n_tris * ri.OPS_PER_PAIR,
                                  4 * (6 * rn + 9 * n_tris) + 9 * rn, "float32")
            stats = torch.zeros(2, dtype=torch.int64, device=dev)
            ri.closest_hit_cuda(ro, rd, index, stats=stats, tol=tol)
            b, by = k3_bound(ri, index, rn, stats)
            b2, by2, tile_tests = k3_bound_two_level(ri, index, ro, rd, stats)
            split = k3_device_split(lambda: ri.closest_hit_cuda(ro, rd, index, tol=tol))
            log(f"K3 R={rn}: tolerant {ms['tolerant']:.4f} ms, exact {ms['exact']:.4f} ms, "
                f"bound of the flat culled work {b:.4f} ms ({by}), of the two-level work "
                f"{b2:.4f} ms ({by2}; {index.gbox.shape[0]} groups of {index.group} tiles, "
                f"{tile_tests / rn:.1f} tile tests a ray), bound of the brute sweep "
                f"{brute_b:.4f} ms; device ms a call by kernel {split}"
                + (f", plain {plain_ms:.1f} ms" if plain_ms is not None else ""))
            if rn == 1024:
                brute_ms = cuda_ms(lambda: ti.ray_mesh_intersect(ro, rd, *tri, tile=scene.tile), 2)
                culled_ms = cuda_ms(lambda: ti.ray_mesh_intersect_culled(
                    ro, rd, descent_index, group=group), 2)
                log(f"K3 R={rn}: port's brute sweep {brute_ms:.1f} ms, culled descent "
                    f"{culled_ms:.1f} ms ({rounds[0]} rounds, one host sync each)")
                rec.update(max_abs_err=err_tol, ms=ms["tolerant"], ms_exact=ms["exact"],
                           plain_ms=plain_ms, bound_ms=b, bound_by=by,
                           bound_ms_two_level=b2, bound_by_two_level=by2,
                           groups=index.gbox.shape[0], device_ms_by_kernel=split,
                           box_pairs_passed=pairs_tol, tri_pairs_tested=tests_tol,
                           brute_ms=brute_ms, culled_ms=culled_ms, culled_rounds=rounds[0],
                           shape=f"R={rn} rays x T={n_tris} triangles, f32, a warp a ray "
                                 f"over {index.box.shape[0]} tiles of {index.tile} in "
                                 f"{index.gbox.shape[0]} groups of {index.group}")
            else:
                rec.update(ms_r131072=ms["tolerant"], ms_exact_r131072=ms["exact"],
                           bound_ms_r131072=b, bound_ms_two_level_r131072=b2,
                           device_ms_by_kernel_r131072=split,
                           box_pairs_passed_r131072=pairs_tol,
                           tri_pairs_tested_r131072=tests_tol)

    # the adversarial box: rays along its faces, through its edges and
    # vertices, with zero direction components, from the tile boxes' planes
    verts, tris = box_mesh()
    tv = verts[tris]
    btri = [torch.as_tensor(a, device=dev)
            for a in (tv[:, 0], tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0])]
    for tile in (8, 32):
        bindex = ri.build_cull_index(*btri, tile=tile)
        o, d = (torch.as_tensor(a, device=dev)
                for a in adversarial_rays(verts, bindex.box.cpu().numpy()))
        for mode, mtol in modes.items():
            got = ri.closest_hit_cuda(o, d, bindex, tol=mtol)
            torch.cuda.synchronize()
            ref = ri.closest_hit_reference(o, d, *btri, tol=mtol)
            if not all(torch.equal(a, r) for a, r in zip(got, ref)):
                raise AssertionError(f"K3 ({mode}) disagrees with its plain version on the "
                                     f"adversarial box (tile {tile})")
            log(f"K3 adversarial box ({len(tris)} triangles, tiles of {tile}), {mode} mode: "
                f"{len(o)} rays, {int(got[2].sum())} hits, t, index and hit equal (held "
                "exactly)")
            if mode == "tolerant":
                brute = ti.ray_mesh_intersect(o, d, *btri, tile=len(tris))
                c = sweep_agreement(got, brute, o, d, btri, f"adversarial box, tile {tile}")
                rec[f"adversarial_agreement_tile{tile}"] = c
                log(f"K3 tolerant vs the brute sweep on the adversarial box: {c}")
    return rec


DENSE_ROWS = 131072   # one bf16 dense layer, 256x256, at this many rows
DENSE_UNEQUAL_TOL = 1e-3   # share of outputs not bit-equal to the CPU's


def phase_dense_rounding(dev):
    """One bf16 ``WNDense`` (256x256, ``DENSE_ROWS`` rows) on the card against
    the same layer on the CPU.  Both round once, after the f32 bias: the
    card's output equals its route's (``ROUTES['cuda']``) to the bit, and at
    most ``DENSE_UNEQUAL_TOL`` of it differs from the CPU's, each output
    within one bf16 unit plus what the order of the f32 sums and the weight
    norm's rounding may move it; dx, dv, dg and db within one bf16 unit of
    their scale."""
    from nunerf_tpu_torch.fields.mlp import ROUTES, WNDense

    gen = torch.Generator().manual_seed(11)
    x = torch.randn(DENSE_ROWS, 256, generator=gen)
    w = torch.randn(DENSE_ROWS, 256, generator=gen)
    res, kt = {}, {}
    for d in (dev, torch.device("cpu")):
        layer = WNDense(256, 256, dtype=torch.bfloat16, device=d)
        layer.reset_parameters(torch.Generator().manual_seed(12))
        xd = x.to(d).requires_grad_(True)
        y = layer(xd)
        torch.sum(y.float() * w.to(d)).backward()
        res[d.type] = [t.detach().float().cpu() for t in (
            y, xd.grad, layer.v.grad, layer.g.grad, layer.b.grad)]
        with torch.no_grad():
            kb = layer.weight().to(torch.bfloat16)
        kt[d.type] = kb.float().cpu()
        if d.type == "cuda":
            with torch.no_grad():
                route = (torch.mm(x.to(d).to(torch.bfloat16), kb, out_dtype=torch.float32)
                         + layer.b).to(torch.bfloat16)
            if not torch.equal(y, route):
                raise AssertionError("the bf16 dense layer did not take its CUDA route")
            xb = x.to(d).to(torch.bfloat16)

            def fwd_bwd():
                yy = layer(xb.requires_grad_(True))
                yy.backward(torch.ones_like(yy))

            with torch.no_grad():
                layer_ms = cuda_ms(lambda: layer(xb), 20)
            layer_bwd_ms = cuda_ms(fwd_bwd, 20)
    got, want = res["cuda"][0], res["cpu"][0]
    unequal = float((got != want).float().mean())
    _, e = torch.frexp(torch.maximum(got.abs(), want.abs()))
    xa = x.to(torch.bfloat16).float().abs()
    # one bf16 unit, the f32 sums' order, and the two devices' weight norms
    # rounding a kernel element to bf16 differently
    bound = (torch.ldexp(torch.ones_like(got), e - 8)
             + 256 * 2.0 ** -24 * (xa @ kt["cpu"].abs()) + xa @ (kt["cuda"] - kt["cpu"]).abs())
    over = float(((got - want).abs() / bound).max())
    grad_units = [rel_err(a, b) * 2.0 ** 7 for a, b in zip(res["cuda"][1:], res["cpu"][1:])]
    rec = {"route": ROUTES["cuda"], "rows": DENSE_ROWS, "unequal_share": unequal,
           "max_over_bound": over, "grad_bf16_units": grad_units,
           "fwd_ms": layer_ms, "fwd_bwd_ms": layer_bwd_ms}
    log(f"bf16 WNDense 256x256 at {DENSE_ROWS} rows, route {ROUTES['cuda']}: card vs CPU "
        f"{unequal:.3e} of the outputs not bit-equal (tol {DENSE_UNEQUAL_TOL:.0e}), the "
        f"largest difference {over:.3f} of its bound; dx/dv/dg/db "
        f"{', '.join(f'{u:.3f}' for u in grad_units)} bf16 units of scale; "
        f"forward {layer_ms:.4f} ms, forward+backward {layer_bwd_ms:.4f} ms")
    if not (unequal <= DENSE_UNEQUAL_TOL and over <= 1.0 and max(grad_units) <= 1.0):
        raise AssertionError(f"the bf16 dense layer on the card disagrees with the CPU: {rec}")
    return rec


def _compare_terms(what, card, cpu, tol_total, tol_term):
    """loss_total within ``tol_total`` relative, each term within ``tol_term``
    of itself plus 1e-3 of loss_total."""
    total = float(cpu["loss_total"])
    for k, v in cpu.items():
        a, b = float(card[k]), float(v)
        tol = tol_total * abs(b) if k == "loss_total" else tol_term * abs(b) + 1e-3 * abs(total)
        if not (math.isfinite(a) and abs(a - b) <= tol):
            raise AssertionError(f"{what} {k}: card {a} vs cpu {b}")
    log(f"{what}: card loss_total {float(card['loss_total']):.6f} vs cpu {total:.6f} ok")


def phase_small_check(dev):
    """The small step on the card (kernels on) against the CPU (plain): the
    plain step at steps 0 and 25000, and at step 25000 with each gate on."""
    from nunerf_tpu_torch.models.stage1 import ShapeRenderer
    from nunerf_tpu_torch.ops import fused_mlp as fm
    from nunerf_tpu_torch.train.trainer import TrainStep

    for step, extra in ((0, {}), (25000, {}), (25000, {"fused_sdf": True}),
                        (25000, {"fused_mlp": True})):
        terms = {}
        cfg = dict(SMALL_CFG, **extra)
        for d in (dev, torch.device("cpu")):
            r = ShapeRenderer(cfg, device=d, seed=3)
            if step == 0:
                with torch.no_grad():  # SDF about |x| - 1.2: init reg "large" live
                    r.sdf_net.layers()[-1].b[0] -= 0.7
            before = dict(fm.launches)
            terms[d.type] = TrainStep(r)(batch_for(cfg, d), step)
            got = {k: fm.launches[k] - before[k] for k in before}
            if r.fused_sdf_value != (d.type == "cuda"):
                raise AssertionError("the fused SDF gate does not follow the device")
            on_card = d.type == "cuda"
            if (got["chain_jac_fwd"], got["chain_jac_bwd"]) != (
                    (1, 1) if on_card and extra.get("fused_sdf") else (0, 0)):
                raise AssertionError(f"K4/K5 launches {got} with {extra} on {d.type}")
            if (got["chain_bwd"] > 0) != (on_card and (step == 0 or bool(extra.get("fused_mlp")))):
                raise AssertionError(f"K2 launches {got} with {extra} on {d.type}")
        # the card's SDF sweeps and occlusion march run the bf16 chain (and
        # with fused_sdf the normals too), so sample positions and the
        # march's hits move slightly: loss_total agrees to 1e-2 relative, each
        # term to 5e-2 of itself plus 1e-3 of loss_total (the occlusion term
        # is the most sensitive)
        _compare_terms(f"small step {step} {extra or 'plain'}", terms["cuda"],
                       terms["cpu"], 1e-2, 5e-2)


def phase_small_check_stage2(dev):
    """A small stage-2 step on the card (closest hit by K3) against the same
    step on the CPU (closest hit by the brute sweep): f32 on both sides, and
    with ``fused_sdf`` (the card's inner SDF in bf16 through K4/K5)."""
    from nunerf_tpu_torch.models.stage1 import ShapeRenderer
    from nunerf_tpu_torch.models.stage2 import Stage2Renderer
    from nunerf_tpu_torch.ops import fused_mlp as fm
    from nunerf_tpu_torch.ops import ray_intersect as ri
    from nunerf_tpu_torch.tracing.mesh_ops import extract_geometry
    from nunerf_tpu_torch.tracing.scene import Scene
    from nunerf_tpu_torch.train.trainer import TrainStep

    mesh = extract_geometry(lambda p: np.linalg.norm(p, axis=-1) - 0.5, resolution=16)
    for fused in (False, True):
        terms = {}
        cfg = dict(SMALL_S2_CFG, fused_sdf=fused)
        for d in (dev, torch.device("cpu")):
            scene = Scene(mesh, tile=512, device=d)
            if scene.use_kernel != (d.type == "cuda"):
                raise AssertionError("the closest-hit kernel gate does not follow the device")
            s1 = ShapeRenderer(SMALL_CFG, device=d, seed=3)
            r = Stage2Renderer(cfg, scene, s1, device=d, seed=4)
            before = dict(ri.launches, **fm.launches)
            terms[d.type] = TrainStep(r, 5e-4)(stage2_batch(16, d), 10)
            after = dict(ri.launches, **fm.launches)
            got = {k: after[k] - before[k] for k in before}
            on_card = d.type == "cuda"
            jac = 1 if on_card and fused else 0
            if (got["closest_hit"], got["chain_jac_fwd"], got["chain_jac_bwd"]) != (
                    3 if on_card else 0, jac, jac):
                raise AssertionError(f"launches {got} in a small stage-2 step on "
                                     f"{d.type}, fused_sdf={fused}")
        # plain: f32 on both sides and no bf16; the card orders its sums
        # differently, and a sample position or an edge ray can move with it,
        # so loss_total agrees to 1e-3 relative and each term to 1e-2 of
        # itself plus 1e-3 of loss_total.  fused_sdf: the card's inner SDF
        # runs K4/K5 with bf16 operands: 1e-2 and 5e-2, as in stage 1.
        _compare_terms(f"small stage-2 step ({len(mesh[1])} triangles, fused_sdf={fused})",
                       terms["cuda"], terms["cpu"], *((1e-2, 5e-2) if fused else (1e-3, 1e-2)))


def phase_main_path_stage2(scene, dev, fused_sdf=False):
    """A few stage-2 training steps at full width through the entry points;
    with ``fused_sdf`` it is path B (the inner SDF through K4/K5)."""
    from nunerf_tpu_torch.models.stage1 import ShapeRenderer
    from nunerf_tpu_torch.models.stage2 import Stage2Renderer
    from nunerf_tpu_torch.ops import fused_mlp as fm
    from nunerf_tpu_torch.ops import ray_intersect as ri
    from nunerf_tpu_torch.train.trainer import TrainStep

    label = "path B (stage 2, fused_sdf)" if fused_sdf else "stage-2 main path"
    stage1 = ShapeRenderer(BENCH_CFG, device=dev, seed=0)
    renderer = Stage2Renderer(dict(STAGE2_CFG, fused_sdf=fused_sdf), scene, stage1,
                              device=dev, seed=1)
    del stage1
    if not scene.use_kernel:
        raise AssertionError("the closest-hit kernel is off on the card")
    if renderer.fused_sdf != fused_sdf or renderer.stage1.fused_sdf:
        raise AssertionError("the fused_sdf gate does not follow the cfg")
    train = TrainStep(renderer, 5e-4)
    rn = STAGE2_CFG["train_ray_num"]
    batch = stage2_batch(rn, dev)
    frozen = {n: p.detach().clone() for n, p in renderer.stage1.named_parameters()}
    watched = ("sdf_inner.lin0.v", "color_inner.albedo.out.v",
               "ior_net.module0.layer_0.v", "var_inner.variance")
    params = dict(renderer.named_parameters())
    watch = {n: params[n].detach().clone() for n in watched}
    n_steps, step = 4, 1000

    torch.cuda.reset_peak_memory_stats()
    ri.reset_launches()
    fm.reset_launches()
    times = []
    for _ in range(n_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        terms = train(batch, step)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        bad = [k for k, v in terms.items() if not math.isfinite(float(v))]
        if bad:
            raise AssertionError(f"{label}: non-finite {bad}")
    launches = dict(ri.launches, **fm.launches)

    steady = times[1:]
    ms = 1e3 * sum(steady) / len(steady)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"{label}: {n_steps} steps, steady {ms:.1f} ms/step "
        f"({rn / (ms / 1e3):.0f} rays/s), first {1e3 * times[0]:.1f} ms, loss_total "
        f"{float(terms['loss_total']):.5f}, ior_glass {float(terms['ior_glass']):.4f}, "
        f"launches {launches}, peak memory {peak:.2f} GiB")
    # one K3 launch a bounce, three bounces a step; the frozen stage-1 SDF and
    # the plain inner SDF launch no chain kernel; with fused_sdf the inner
    # SDF's one call a step is K4 forward and K5 backward
    jac = n_steps if fused_sdf else 0
    want = {"closest_hit": 3 * n_steps, "cull_bin": 0, "chain_fwd": 0, "chain_bwd": 0,
            "chain_jac_fwd": jac, "chain_jac_bwd": jac}
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, expected {want}")
    for n, p in renderer.stage1.named_parameters():
        if p.grad is not None or not torch.equal(frozen[n], p.detach()):
            raise AssertionError(f"frozen stage-1 parameter {n} changed")
    for n in watched:
        if torch.equal(watch[n], params[n].detach()):
            raise AssertionError(f"trainable parameter {n} did not change")
    return launches, dict(step_ms=ms, rays_per_s=rn / (ms / 1e3),
                          first_step_ms=1e3 * times[0], peak_gib=peak,
                          loss_total=float(terms["loss_total"]))


def phase_main_path(dev, gate=None):
    """A few stage-1 training steps at full width through the entry points:
    the plain step at steps 0 and 25000, or, with ``gate`` ("fused_sdf": path
    A, "fused_mlp": path C), the gated step at step 25000."""
    from nunerf_tpu_torch.models.stage1 import ShapeRenderer
    from nunerf_tpu_torch.ops import fused_mlp as fm
    from nunerf_tpu_torch.train.trainer import TrainStep

    label = {None: "main path", "fused_sdf": "path A (stage 1, fused_sdf)",
             "fused_mlp": "path C (stage 1, fused_mlp)"}[gate]
    cfg = dict(BENCH_CFG, **({gate: True} if gate else {}))
    renderer = ShapeRenderer(cfg, device=dev, seed=0)
    if not renderer.fused_sdf_value:
        raise AssertionError("the fused SDF value path is off on the card")
    if (renderer.fused_sdf, renderer.fused) != (gate == "fused_sdf", gate == "fused_mlp"):
        raise AssertionError("the fused gates do not follow the cfg")
    train = TrainStep(renderer, 5e-4)
    batch = batch_for(cfg, dev)
    watch = {n: p.detach().clone() for n, p in renderer.named_parameters()
             if n in ("sdf_net.lin0.v", "sdf_net.lin8.b", "outer_nerf.pts_0.kernel",
                      "color_net.albedo.out.v", "var_net.variance")}
    rn = cfg["train_ray_num"]
    n0, n1 = 3, 6
    phases = ((0, n0), (25000, n1)) if gate is None else ((25000, 4),)
    res = {}

    torch.cuda.reset_peak_memory_stats()
    fm.reset_launches()
    phase_counts = {}
    for step, n_steps in phases:
        before = dict(fm.launches)
        times = []
        for i in range(n_steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            terms = train(batch, step)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            bad = [k for k, v in terms.items() if not math.isfinite(float(v))]
            if bad:
                raise AssertionError(f"{label} step {step}: non-finite {bad}")
        phase_counts[step] = {k: fm.launches[k] - before[k] for k in before}
        steady = times[1:]
        ms = 1e3 * sum(steady) / len(steady)
        res[step] = dict(step_ms=ms, rays_per_s=rn / (ms / 1e3),
                         first_step_ms=1e3 * times[0],
                         loss_total=float(terms["loss_total"]),
                         peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                         launches_per_step={k: v / n_steps
                                            for k, v in phase_counts[step].items()},
                         terms={k: float(v) for k, v in terms.items()})
        log(f"{label} step {step}: {n_steps} steps, steady {ms:.1f} ms/step "
            f"({rn / (ms / 1e3):.0f} rays/s), first {1e3 * times[0]:.1f} ms, "
            f"loss_total {float(terms['loss_total']):.5f}, launches "
            f"{phase_counts[step]}, peak memory {res[step]['peak_gib']:.2f} GiB")
    launches = dict(fm.launches)

    # the sampling sweeps are 4 K1 launches a step, the occlusion march 2, the
    # init-SDF regulariser 1 and its backward K2; fused_sdf adds one K4 and
    # one K5 a step; fused_mlp adds the trunk and the heads to K1 and K2
    zero = {"chain_jac_fwd": 0, "chain_jac_bwd": 0}
    if gate is None:
        want = {0: dict(zero, chain_fwd=5 * n0, chain_bwd=n0),
                25000: dict(zero, chain_fwd=6 * n1, chain_bwd=0)}
    elif gate == "fused_sdf":
        want = {25000: dict(chain_fwd=6 * 4, chain_bwd=0, chain_jac_fwd=4,
                            chain_jac_bwd=4)}
    else:
        # + the trunk and 9 head calls forward (8 heads in the shader, the
        # outer light once more for the specular candidate), and the backward
        # of each
        want = {25000: dict(zero, chain_fwd=(6 + 10) * 4, chain_bwd=10 * 4)}
    if phase_counts != want:
        raise AssertionError(f"{label}: launch counts {phase_counts}, expected {want}")
    if not res[25000]["terms"]["loss_occ"] > 0:
        raise AssertionError("the occlusion loss is not live at step 25000")
    for n, p in renderer.named_parameters():
        if n in watch and torch.equal(watch[n], p.detach()):
            raise AssertionError(f"parameter {n} did not change")
    return launches, res


# the scene of the trainer phase: a NeRF-synthetic-layout dataset of the
# size the Blender scenes of configs/shape/nerf/*.yaml have
SCENE_VIEWS = (100, 4)   # train, test
SCENE_HW = 800


def look_at_pose(cam_pos):
    """c2w of an OpenGL camera at ``cam_pos`` looking at the origin."""
    z_axis = cam_pos / np.linalg.norm(cam_pos)
    up = np.array([0.0, 0.0, 1.0])
    if abs(np.dot(up, z_axis)) > 0.99:
        up = np.array([0.0, 1.0, 0.0])
    x_axis = np.cross(up, z_axis)
    x_axis /= np.linalg.norm(x_axis)
    y_axis = np.cross(z_axis, x_axis)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x_axis, y_axis, z_axis, cam_pos
    return c2w


def render_sphere_view(c2w, h, w, focal, radius=0.5):
    """An analytic lambertian sphere on a white background: RGBA uint8."""
    i, j = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    dirs = np.stack([(i - w / 2) / focal, -(j - h / 2) / focal, -np.ones_like(i)], -1)
    o = c2w[:3, 3]
    d = dirs @ c2w[:3, :3].T
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    b = np.sum(o * d, -1)
    disc = b * b - (np.sum(o * o) - radius ** 2)
    t = -b - np.sqrt(np.maximum(disc, 0))
    hit = (disc > 0) & (t > 0)
    n = (o + t[..., None] * d) / radius
    light = np.array([0.5, 0.5, 0.7]) / np.linalg.norm([0.5, 0.5, 0.7])
    lam = np.clip(np.sum(n * light, -1), 0, 1)
    base = np.array([0.8, 0.3, 0.2])
    img = np.ones((h, w, 3), np.float32)
    img[hit] = (0.2 * base + 0.8 * base * lam[..., None])[hit]
    return (np.concatenate([img, hit[..., None]], -1) * 255).astype(np.uint8)


def write_blender_scene(root, n_train, n_test, hw, cam_dist=2.5):
    """``transforms_{train,test}.json`` with ``camera_angle_x`` and RGBA PNGs
    written by the port's ``image_io.imwrite``: cameras on a ring around the
    sphere."""
    import os

    from nunerf_tpu_torch.data.image_io import imwrite

    camera_angle_x = 0.8
    focal = 0.5 * hw / np.tan(0.5 * camera_angle_x)
    for split, n in (("train", n_train), ("test", n_test)):
        os.makedirs(os.path.join(root, split), exist_ok=True)
        frames = []
        for k in range(n):
            phi = 2 * np.pi * (k + (0.5 if split == "test" else 0)) / n
            c2w = look_at_pose(cam_dist * np.array([np.cos(phi), np.sin(phi), 0.45]))
            imwrite(os.path.join(root, split, f"r_{k}.png"), render_sphere_view(c2w, hw, hw, focal))
            frames.append({"file_path": f"./{split}/r_{k}", "transform_matrix": c2w.tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": camera_angle_x, "frames": frames}, f)


def read_log(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def timed(obj, name, times):
    """Wrap the method ``name`` of ``obj`` to append its seconds to ``times``."""
    fn = getattr(obj, name)

    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return out

    setattr(obj, name, wrapper)


def phase_trainer(dev, verts, tris, step0_ms, work):
    """``Trainer(cfg).run()``, the port's entry point, on a 100-view 800x800
    scene written into ``work`` (the working directory): stage 1 at
    ``BENCH_CFG``'s width (30 steps, logs and checkpoints every 10, a
    validation at step 20 on one view at a quarter of its size), then a
    second trainer that resumes at step 30 and runs to 40, then the
    zero-thickness stage 2 at ``STAGE2_CFG``'s width from that checkpoint
    and the outer mesh (10 steps, a validation with the TIR mask).  Each
    run's launch counts are set to 0 just before it and read just after.
    Returns ({path: launches}, numbers, the stage-1 checkpoint)."""
    import os

    from nunerf_tpu_torch.data import image_io
    from nunerf_tpu_torch.ops import fused_mlp as fm
    from nunerf_tpu_torch.ops import ray_intersect as ri
    from nunerf_tpu_torch.tracing.mesh_ops import save_ply
    from nunerf_tpu_torch.train.trainer import Trainer

    def reset():
        fm.reset_launches()
        ri.reset_launches()

    def counts():
        return dict(fm.launches, **ri.launches)

    out, paths = {}, {}
    t0 = time.perf_counter()
    write_blender_scene(os.path.join(work, "ds", "sphere"), *SCENE_VIEWS, SCENE_HW)
    out["scene_write_s"] = time.perf_counter() - t0
    # an 800x800 RGBA PNG whose rows all carry the Paeth filter: its
    # rows depend on their left neighbours, the slow case of the decoder
    view = image_io.imread(os.path.join(work, "ds", "sphere", "train", "r_0.png"))
    image_io.imwrite("paeth.png", view, png_filter=4)
    t0 = time.perf_counter()
    back = image_io.imread("paeth.png")
    out["paeth_decode_800x800_rgba_s"] = time.perf_counter() - t0
    if not np.array_equal(back, view):
        raise AssertionError("a Paeth-filtered PNG does not decode to what was written")
    log(f"trainer scene: {SCENE_VIEWS[0]} + {SCENE_VIEWS[1]} views of {SCENE_HW}x"
        f"{SCENE_HW} RGBA written in {out['scene_write_s']:.1f} s; an 800x800 RGBA PNG "
        f"of Paeth rows decodes in {out['paeth_decode_800x800_rgba_s']:.3f} s on the host")

    common = dict(database_name="nerf/sphere", dataset_dir=os.path.join(work, "ds"),
                  model_dir=os.path.join(work, "model"), downsample_ratio=0.25)
    cfg1 = dict(BENCH_CFG, total_step=30, train_log_step=10, save_interval=10,
                val_interval=20, **common)
    t0 = time.perf_counter()
    tr = Trainer(cfg1, device=dev)
    out["stage1_load_s"] = time.perf_counter() - t0
    store = {k: v.numel() * v.element_size() for k, v in tr.store.items() if v.is_cuda}
    out["store_bytes"] = store
    log(f"stage-1 trainer: database and device store in {out['stage1_load_s']:.1f} s, "
        f"{len(tr.train_ids)} train views, store on the card {store} bytes "
        f"({sum(store.values()) / 2 ** 20:.1f} MiB)")
    val_s, save_s = [], []
    timed(tr, "validate", val_s)
    timed(tr, "save", save_s)
    torch.cuda.reset_peak_memory_stats()
    reset()
    t0 = time.perf_counter()
    tr.run()
    torch.cuda.synchronize()
    paths["trainer_s1"] = counts()
    run_s = time.perf_counter() - t0
    recs = read_log(os.path.join(tr.model_dir, "train_log.jsonl"))
    train_recs = {r["step"]: r for r in recs if r["prefix"] == "train"}
    val = [r for r in recs if r["prefix"] == "val"]
    if sorted(train_recs) != [10, 20, 30] or [r["step"] for r in val] != [20]:
        raise AssertionError(f"stage-1 trainer logged {sorted(train_recs)} and "
                             f"validated at {[r['step'] for r in val]}")
    bad = [k for r in train_recs.values() for k, v in r.items()
           if k != "prefix" and not math.isfinite(v)]
    if bad:
        raise AssertionError(f"stage-1 trainer logged non-finite {bad}")
    rn = BENCH_CFG["train_ray_num"]
    steady = rn / train_recs[20]["rays_per_sec"] * 1e3
    ckpt_bytes = os.path.getsize(tr.ckpt_path)
    out["stage1"] = dict(
        run_s=run_s, steady_step_ms=steady, rays_per_s=train_recs[20]["rays_per_sec"],
        step30_interval_ms=rn / train_recs[30]["rays_per_sec"] * 1e3,
        bare_step0_ms=step0_ms, loop_gap_ms=steady - step0_ms,
        val_psnr=val[0]["psnr"], val_ssim=val[0]["ssim"], val_s=val_s[0],
        ckpt_bytes=ckpt_bytes, save_s=sum(save_s) / len(save_s), saves=len(save_s),
        best_ckpt=os.path.exists(tr.best_ckpt_path),
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        launches=paths["trainer_s1"], loss_total=train_recs[30]["loss_total"])
    log(f"stage-1 trainer: 30 steps in {run_s:.1f} s; steps 11-20 (one checkpoint "
        f"among them) {steady:.1f} ms/step ({train_recs[20]['rays_per_sec']:.0f} rays/s) "
        f"against the bare step's {step0_ms:.1f} at step 0: the loop adds "
        f"{steady - step0_ms:.1f} ms/step; steps 21-30 (with the validation) "
        f"{out['stage1']['step30_interval_ms']:.1f} ms/step; validation PSNR "
        f"{val[0]['psnr']:.3f} SSIM {val[0]['ssim']:.4f} rendered in {val_s[0]:.2f} s "
        f"(one 200x200 view, 40 chunks of 1024 rays); checkpoint {ckpt_bytes} bytes in "
        f"{out['stage1']['save_s']:.3f} s ({len(save_s)} saves); peak memory "
        f"{out['stage1']['peak_gib']:.2f} GiB; launches {paths['trainer_s1']}")
    if not (paths["trainer_s1"]["chain_fwd"] > 0 and paths["trainer_s1"]["chain_bwd"] > 0):
        raise AssertionError(f"the stage-1 trainer launched {paths['trainer_s1']}: K1 "
                             "and K2 expected")
    if not out["stage1"]["best_ckpt"]:
        raise AssertionError("no model_best.ckpt after the validation")
    tr.logger.close()
    del tr
    torch.cuda.empty_cache()

    # resume: a second trainer picks the run up at step 30
    tr = Trainer(dict(cfg1, total_step=40), device=dev)
    resumed = []
    load = tr._load_if_exists

    def load_and_record():
        step, best = load()
        resumed.append((step, tr.train.n_updates,
                        {float(st["step"]) for st in tr.train.optimizer.state.values()}))
        return step, best

    tr._load_if_exists = load_and_record
    reset()
    tr.run()
    torch.cuda.synchronize()
    paths["trainer_s1_resume"] = counts()
    if resumed != [(30, 30, {30.0})] or tr.train.n_updates != 40:
        raise AssertionError(f"the second trainer resumed at {resumed} and ended at "
                             f"{tr.train.n_updates} updates: expected step 30, 30 "
                             "updates, Adam at 30, then 40")
    recs = read_log(os.path.join(tr.model_dir, "train_log.jsonl"))
    if [r["step"] for r in recs if r["prefix"] == "train"][-1] != 40:
        raise AssertionError("the resumed run did not log step 40")
    log(f"stage-1 trainer resumed at step 30 (Adam's count 30) and ran to 40; "
        f"launches {paths['trainer_s1_resume']}")
    ckpt1 = tr.ckpt_path
    tr.logger.close()
    del tr
    torch.cuda.empty_cache()

    # stage 2 from that checkpoint and the outer mesh
    mesh_path = os.path.join(work, "outer.ply")
    save_ply(mesh_path, verts, tris)
    cfg2 = dict(STAGE2_CFG, network="stage2", zero_thickness=True,
                stage1_ckpt_dir=ckpt1, stage1_mesh_dir=mesh_path, total_step=10,
                train_log_step=5, val_interval=10, **common)
    t0 = time.perf_counter()
    tr = Trainer(cfg2, device=dev)
    out["stage2_load_s"] = time.perf_counter() - t0
    scene = tr.renderer.scene
    if not (scene.use_kernel and scene.kernel_tol == ri.BARY_TOL):
        raise AssertionError("the stage-2 trainer's scene does not trace with K3 in "
                             "its tolerant mode")
    frozen = {n: p.detach().clone() for n, p in tr.renderer.stage1.named_parameters()}
    val_s = []
    timed(tr, "validate", val_s)
    torch.cuda.reset_peak_memory_stats()
    reset()
    t0 = time.perf_counter()
    tr.run()
    torch.cuda.synchronize()
    paths["trainer_s2"] = counts()
    run_s = time.perf_counter() - t0
    recs = read_log(os.path.join(tr.model_dir, "train_log.jsonl"))
    train_recs = {r["step"]: r for r in recs if r["prefix"] == "train"}
    val = [r for r in recs if r["prefix"] == "val"]
    if sorted(train_recs) != [5, 10] or len(val) != 1:
        raise AssertionError(f"stage-2 trainer logged {sorted(train_recs)}, {len(val)} "
                             "validations")
    if not all(math.isfinite(r["loss_total"]) for r in train_recs.values()):
        raise AssertionError("stage-2 trainer logged a non-finite loss")
    for n, p in tr.renderer.stage1.named_parameters():
        if p.grad is not None or not torch.equal(frozen[n], p.detach()):
            raise AssertionError(f"frozen stage-1 parameter {n} changed")
    h, w = (int(SCENE_HW * 0.25),) * 2
    val_chunks = -(-h * w // tr.renderer.cfg["test_ray_num"])
    want = 3 * 10 + 3 * val_chunks
    if paths["trainer_s2"]["closest_hit"] != want:
        raise AssertionError(f"stage-2 trainer: {paths['trainer_s2']['closest_hit']} K3 "
                             f"launches, expected 3 x 10 steps + 3 x {val_chunks} "
                             "validation chunks")
    rn = STAGE2_CFG["train_ray_num"]
    steady = rn / train_recs[10]["rays_per_sec"] * 1e3
    out["stage2"] = dict(run_s=run_s, steady_step_ms=steady,
                         rays_per_s=train_recs[10]["rays_per_sec"],
                         tir_masked_val_psnr=val[0]["psnr"], val_ssim=val[0]["ssim"],
                         val_s=val_s[0], loss_total=train_recs[10]["loss_total"],
                         peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                         launches=paths["trainer_s2"])
    log(f"stage-2 trainer: 10 steps in {run_s:.1f} s (load {out['stage2_load_s']:.1f} s); "
        f"steps 6-10 {steady:.1f} ms/step ({train_recs[10]['rays_per_sec']:.0f} rays/s); "
        f"loss_total {train_recs[10]['loss_total']:.5f}; TIR-masked validation PSNR "
        f"{val[0]['psnr']:.3f} SSIM {val[0]['ssim']:.4f} in {val_s[0]:.2f} s; frozen "
        f"stage 1 bit-equal; peak memory {out['stage2']['peak_gib']:.2f} GiB; launches "
        f"{paths['trainer_s2']}")
    tr.logger.close()
    del tr
    torch.cuda.empty_cache()
    return paths, out, ckpt1


def phase_small_check_shell(dev):
    """A small curvature-shell step on the card (closest hit by K3) against
    the same step on the CPU (the brute sweep), f32 on both sides, with the
    object mask, absorption and the freeze gates of ``SHELL_CFG``."""
    from nunerf_tpu_torch.models.stage1 import ShapeRenderer
    from nunerf_tpu_torch.models.stage2_shell import Stage2ShellRenderer
    from nunerf_tpu_torch.ops import fused_mlp as fm
    from nunerf_tpu_torch.ops import ray_intersect as ri
    from nunerf_tpu_torch.tracing.mesh_ops import extract_geometry
    from nunerf_tpu_torch.tracing.scene import Scene
    from nunerf_tpu_torch.train.trainer import TrainStep

    mesh = extract_geometry(lambda p: np.linalg.norm(p, axis=-1) - 0.5, resolution=16)
    terms = {}
    for d in (dev, torch.device("cpu")):
        scene = Scene(mesh, tile=512, curv_smooth_iters=20, device=d)
        s1 = ShapeRenderer(SMALL_CFG, device=d, seed=3)
        r = Stage2ShellRenderer(SMALL_SHELL_CFG, scene, s1, device=d, seed=4)
        before = dict(ri.launches, **fm.launches)
        terms[d.type] = TrainStep(r, 5e-4)(shell_batch(16, d), SHELL_STEP)
        after = dict(ri.launches, **fm.launches)
        got = {k: after[k] - before[k] for k in before}
        if got["closest_hit"] != (3 if d.type == "cuda" else 0):
            raise AssertionError(f"launches {got} in a small shell step on {d.type}")
    # f32 on both sides; the card orders its sums differently and the shell
    # chord cancels where the curvature radius is large: loss_total to 1e-3
    # relative, each term to 1e-2 of itself plus 1e-3 of loss_total
    _compare_terms(f"small shell step ({len(mesh[1])} triangles)", terms["cuda"],
                   terms["cpu"], 1e-3, 1e-2)


def phase_main_path_shell(mesh_path, dev):
    """The curvature-shell stage-2 training step at full width through the
    entry points (``SHELL_CFG``, stage 1 ``BENCH_CFG``), tracing the remeshed
    mesh that ``extract-mesh-stage1`` wrote: 4 steps at ``SHELL_STEP``, 3 K3
    launches a step.  The inner surface is set hardened (variance 0.5: inv_s
    148, past ``freeze_thickness_inv_s``), so every physical field trains."""
    from nunerf_tpu_torch.models.stage1 import ShapeRenderer
    from nunerf_tpu_torch.models.stage2_shell import Stage2ShellRenderer
    from nunerf_tpu_torch.ops import fused_mlp as fm
    from nunerf_tpu_torch.ops import ray_intersect as ri
    from nunerf_tpu_torch.tracing.scene import Scene
    from nunerf_tpu_torch.train.trainer import TrainStep

    t0 = time.perf_counter()
    scene = Scene(mesh_path, curv_smooth_iters=20, device=dev)
    n_tris = len(scene.tris_np)
    if not SHELL_TRIANGLES[0] <= n_tris <= SHELL_TRIANGLES[1]:
        raise AssertionError(f"the remeshed mesh has {n_tris} triangles: outside "
                             f"{SHELL_TRIANGLES}")
    curv = scene.vertex_curvature.cpu().numpy()
    log(f"shell scene: {n_tris} triangles of {mesh_path} loaded in "
        f"{time.perf_counter() - t0:.2f} s; smoothed curvature {curv.min():.3f} to "
        f"{curv.max():.3f}, {int((curv < 0).sum())} of {len(curv)} vertices negative")
    stage1 = ShapeRenderer(BENCH_CFG, device=dev, seed=0)
    renderer = Stage2ShellRenderer(SHELL_CFG, scene, stage1, device=dev, seed=1)
    del stage1
    with torch.no_grad():
        renderer.var_inner.variance.fill_(0.5)
    train = TrainStep(renderer, 5e-4)
    rn = SHELL_CFG["train_ray_num"]
    batch = shell_batch(rn, dev)
    frozen = {n: p.detach().clone() for n, p in renderer.stage1.named_parameters()}
    watched = ("sdf_inner.", "color_inner.", "ior_net.", "thickness_net.", "absorption")
    before = {n: p.detach().clone() for n, p in renderer.named_parameters()
              if n.startswith(watched)}
    n_steps = 4

    torch.cuda.reset_peak_memory_stats()
    ri.reset_launches()
    fm.reset_launches()
    times = []
    for _ in range(n_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        terms = train(batch, SHELL_STEP)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        bad = [k for k, v in terms.items() if not math.isfinite(float(v))]
        if bad:
            raise AssertionError(f"shell main path: non-finite {bad}")
    launches = dict(ri.launches, **fm.launches)

    ms = 1e3 * sum(times[1:]) / (n_steps - 1)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    res = dict(step_ms=ms, rays_per_s=rn / (ms / 1e3), first_step_ms=1e3 * times[0],
               peak_gib=peak, triangles=n_tris, loss_total=float(terms["loss_total"]),
               thickness_mean=float(terms["thickness_mean"]),
               thickness_frozen=float(terms["thickness_frozen"]),
               ior_frozen=float(terms["ior_frozen"]), ior_glass=float(terms["ior_glass"]),
               kappa=[float(terms[k]) for k in ("kappa_r", "kappa_g", "kappa_b")])
    log(f"shell main path: {n_steps} steps at step {SHELL_STEP}, steady {ms:.1f} ms/step "
        f"({res['rays_per_s']:.0f} rays/s), first {res['first_step_ms']:.1f} ms, "
        f"loss_total {res['loss_total']:.5f}, thickness_mean {res['thickness_mean']:.5f} "
        f"(frozen {res['thickness_frozen']:.0f}), ior_glass {res['ior_glass']:.4f} (frozen "
        f"{res['ior_frozen']:.0f}), kappa {res['kappa']}, launches {launches}, peak memory "
        f"{peak:.2f} GiB")
    want = {"closest_hit": 3 * n_steps, "cull_bin": 0, "chain_fwd": 0, "chain_bwd": 0,
            "chain_jac_fwd": 0, "chain_jac_bwd": 0}
    if launches != want:
        raise AssertionError(f"shell main path: launches {launches}, expected {want}")
    if res["thickness_frozen"] != 0.0 or res["ior_frozen"] != 0.0:
        raise AssertionError("a freeze gate held at the shell main path's step")
    for n, p in renderer.stage1.named_parameters():
        if p.grad is not None or not torch.equal(frozen[n], p.detach()):
            raise AssertionError(f"frozen stage-1 parameter {n} changed")
    after = dict(renderer.named_parameters())
    for prefix in watched:
        if all(torch.equal(v, after[n].detach()) for n, v in before.items()
               if n.startswith(prefix)):
            raise AssertionError(f"no trainable parameter under {prefix} changed")
    return launches, res


def write_cfg(path, cfg):
    """A YAML config file for the CLI's ``--cfg``."""
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def sdf_value_chain(renderer, dev):
    """(spec, flat) of ``renderer``'s value-only SDF chain as
    ``fused_sdf_apply(..., value_only=True)`` hands it to K1."""
    from nunerf_tpu_torch.fields.sdf import _sdf_chain
    from nunerf_tpu_torch.ops import fused_mlp as fm

    with torch.no_grad():
        spec, flat = _sdf_chain(renderer.sdf_net, dev)
        flat = [f.detach().contiguous() for f in flat]
    nw = fm.n_weights(spec)
    flat[nw - 1] = flat[nw - 1][:, :1].contiguous()
    flat[-1] = flat[-1][:, :1].contiguous()
    spec = fm.ChainSpec(spec.dims[:-1] + (1,), spec.acts, spec.has_skip, spec.scales,
                        compute_dtype=spec.compute_dtype)
    return spec, flat


def slab_chunks(resolution, slab=128):
    """Sweep chunks of ``SWEEP_CHUNK`` points that ``extract_geometry``'s
    z-slabs give at ``resolution``."""
    from nunerf_tpu_torch.cli import SWEEP_CHUNK

    n = 0
    for i0 in range(0, resolution - 1, slab - 1):
        i1 = min(i0 + slab, resolution)
        n += -(-(i1 - i0) * resolution * resolution // SWEEP_CHUNK)
        if i1 == resolution:
            break
    return n


def phase_extract(dev, ckpt1):
    """``extract-mesh-stage1`` through ``cli.main`` at 512^3 from the
    trainer's stage-1 checkpoint, in the working directory: K1's launches,
    the seconds of the device sweep, the native marching, the remesh and the
    PLY writes, the triangle counts.  Before it, K1 on one 2^21-point chunk
    of the sweep against the plain chain; after it, the K1 (bf16) extraction
    at 128^3 against the plain f32 extraction of the same weights, by their
    chamfer.  Returns (launches, numbers, the remeshed mesh's path)."""
    from nunerf_tpu_torch import cli
    from nunerf_tpu_torch.convert import load_jax_checkpoint, load_jax_params
    from nunerf_tpu_torch.models.stage1 import PARAM_KEYS, ShapeRenderer
    from nunerf_tpu_torch.ops import fused_mlp as fm
    from nunerf_tpu_torch.ops.chamfer import chamfer_distance
    from nunerf_tpu_torch.tracing.mesh_ops import load_ply

    out = {}
    cfg = dict(BENCH_CFG)
    cfg_path = write_cfg("extract_s1.yaml", cfg)

    # K1 on one chunk of the sweep, at the trainer's weights
    renderer = ShapeRenderer(cfg, device=dev)
    step, params, _ = load_jax_checkpoint(ckpt1)
    load_jax_params(renderer, params, PARAM_KEYS)
    spec, flat = sdf_value_chain(renderer, dev)
    n = cli.SWEEP_CHUNK
    gen = torch.Generator(device="cpu").manual_seed(11)
    pts = (torch.rand((n, 3), generator=gen) * 2 - 1).to(dev)
    with torch.no_grad():
        x = renderer.sdf_net.embed(pts).float().contiguous()
    y = fm.chain_fwd_cuda(spec, x, flat)
    torch.cuda.synchronize()
    y_ref = fm.chain_mlp_reference(spec, x, *flat)
    err, tol = rel_err(y, y_ref), CHAIN_TOL[("fwd", spec.compute_dtype)]
    if not err <= tol:
        raise AssertionError(f"K1 on a 2^21-point sweep chunk: rel err {err:.2e} > {tol}")
    ms = cuda_ms(lambda: fm.chain_fwd_cuda(spec, x, flat), 5)
    plain = cuda_ms(lambda: fm.chain_mlp_reference(spec, x, *flat), 3)
    b, by = bound_ms(fm.chain_flops(spec, n), chain_bytes(spec, n), spec.compute_dtype)
    out["k1_chunk"] = dict(n=n, rel_err=err, tol=tol,
                           max_abs_err=float((y - y_ref).abs().max()), ms=ms,
                           plain_ms=plain, bound_ms=b, bound_by=by)
    log(f"K1 on a sweep chunk (N={n}, {spec.compute_dtype}): rel err {err:.2e} (tol "
        f"{tol:.0e}) ok; {ms:.3f} ms, plain {plain:.3f} ms, bound {b:.4f} ms ({by})")
    del renderer, x, y, y_ref, pts
    torch.cuda.empty_cache()

    fm.reset_launches()
    t0 = time.perf_counter()
    rec = cli.main(["extract-mesh-stage1", "--cfg", cfg_path, "--ckpt", ckpt1,
                    "--resolution", str(EXTRACT_RESOLUTION)])
    torch.cuda.synchronize()
    launches = dict(fm.launches)
    rec["total_s"] = time.perf_counter() - t0
    want = slab_chunks(EXTRACT_RESOLUTION)
    if launches["chain_fwd"] != want or launches["chain_bwd"] != 0:
        raise AssertionError(f"extract-mesh-stage1 launched {launches}: {want} K1 expected")
    out["extract_s1"] = rec
    parts = ("grid_s", "sweep_s", "march_s", "dedup_s", "remesh_s", "write_s")
    log(f"extract-mesh-stage1 at {EXTRACT_RESOLUTION}^3: {rec['total_s']:.2f} s = grid "
        f"points {rec['grid_s']:.2f} s + sweep {rec['sweep_s']:.2f} s ({want} K1 launches "
        f"of up to {n} points, with the copies) + native marching {rec['march_s']:.2f} s + "
        f"dedup {rec['dedup_s']:.2f} s + remesh {rec['remesh_s']:.3f} s + PLY writes "
        f"{rec['write_s']:.3f} s + the rest (load) "
        f"{rec['total_s'] - sum(rec[k] for k in parts):.2f} s; {rec['tris']} triangles, "
        f"{rec['tris_simplified']} after the remesh (target edge 0.01); launches {launches}")

    # the K1 extraction against the plain f32 one, at 128^3
    res = 128
    k1 = cli.extract_mesh_stage1(cfg, ckpt1, res, tag="k1_128", device=dev)
    pl = cli.extract_mesh_stage1(dict(cfg, fused_sdf_value=False, sdf_mixed_precision=False),
                                 ckpt1, res, tag="plain_128", device=dev)
    vk, _ = load_ply(k1["mesh"])
    vp, _ = load_ply(pl["mesh"])
    d1, d2 = chamfer_distance(vk, vp, device=dev)
    cham = float(d1) + float(d2)
    h = 2.0 / (res - 1)
    limit = (h / 4) ** 2
    out["k1_vs_plain_128"] = dict(chamfer=cham, limit=limit, tris_k1=k1["tris"],
                                  tris_plain=pl["tris"])
    log(f"extraction at {res}^3, K1 (bf16) against the plain f32 chain: {k1['tris']} and "
        f"{pl['tris']} triangles, chamfer of their vertices {cham:.3e} (limit (h/4)^2 = "
        f"{limit:.3e}, h = 2/{res - 1})")
    if not cham <= limit:
        raise AssertionError("the K1 extraction is off the plain f32 extraction")
    return launches, out, rec["simplified"]


def phase_shell_pipeline(dev, work, ckpt1, outer_mesh):
    """The users' shell pipeline through ``cli.main``: ``train`` of the shell
    (``SHELL_CFG`` on the trainer's scene, 10 steps from the stage-1
    checkpoint and the remeshed outer mesh, a masked validation at step 10),
    ``extract-mesh-stage2`` at 256^3, ``postprocess-stage2
    --largest-component``, ``eval-geometry`` of the outer mesh against the
    analytic sphere the scene was rendered from, and ``eval-images`` on the
    test split.  Returns ({path: launches}, numbers)."""
    import os

    from nunerf_tpu_torch import cli
    from nunerf_tpu_torch.convert import flat_leaves, load_jax_checkpoint
    from nunerf_tpu_torch.ops import fused_mlp as fm
    from nunerf_tpu_torch.ops import ray_intersect as ri

    def run(argv):
        fm.reset_launches()
        ri.reset_launches()
        t0 = time.perf_counter()
        rec = cli.main(argv)
        torch.cuda.synchronize()
        return rec, dict(fm.launches, **ri.launches), time.perf_counter() - t0

    paths, out = {}, {}
    name = SHELL_CFG["name"]
    cfg = dict(SHELL_CFG, database_name="nerf/sphere", dataset_dir=os.path.join(work, "ds"),
               model_dir=os.path.join(work, "model"), downsample_ratio=0.25,
               stage1_ckpt_dir=ckpt1, stage1_mesh_dir=outer_mesh, total_step=10,
               train_log_step=5, val_interval=10, save_interval=10)
    cfg_path = write_cfg("shell.yaml", cfg)
    model = os.path.join(work, "model", name)

    torch.cuda.reset_peak_memory_stats()
    _, paths["trainer_shell"], secs = run(["train", "--cfg", cfg_path])
    recs = read_log(os.path.join(model, "train_log.jsonl"))
    train_recs = {r["step"]: r for r in recs if r["prefix"] == "train"}
    val = [r for r in recs if r["prefix"] == "val"]
    if sorted(train_recs) != [5, 10] or len(val) != 1:
        raise AssertionError(f"shell trainer logged {sorted(train_recs)}, {len(val)} "
                             "validations")
    last = train_recs[10]
    for k in ("loss_total", "thickness_mean", "thickness_frozen", "kappa_r", "ior_glass"):
        if not math.isfinite(last[k]):
            raise AssertionError(f"shell trainer logged {k} = {last[k]}")
    h = w = int(SCENE_HW * 0.25)
    val_chunks = -(-h * w // 1024)
    want = 3 * 10 + 3 * val_chunks
    if paths["trainer_shell"]["closest_hit"] != want:
        raise AssertionError(f"shell trainer: {paths['trainer_shell']['closest_hit']} K3 "
                             f"launches, expected {want}")
    _, s1_params, _ = load_jax_checkpoint(ckpt1)
    _, s2_params, _ = load_jax_checkpoint(os.path.join(model, "model.ckpt"))
    a, b = flat_leaves(s1_params), flat_leaves(s2_params["frozen"])
    if sorted(a) != sorted(b) or not all(np.array_equal(a[k], b[k]) for k in a):
        raise AssertionError("the shell checkpoint's frozen stage 1 differs from stage 1's")
    out["trainer_shell"] = dict(
        s=secs, steady_step_ms=SHELL_CFG["train_ray_num"] / last["rays_per_sec"] * 1e3,
        rays_per_s=last["rays_per_sec"], loss_total=last["loss_total"],
        thickness_mean=last["thickness_mean"], thickness_frozen=last["thickness_frozen"],
        kappa_r=last["kappa_r"], val_psnr=val[0]["psnr"], val_ssim=val[0]["ssim"],
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        launches=paths["trainer_shell"])
    log(f"shell train (cli): 10 steps and a masked validation in {secs:.1f} s; steps 6-10 "
        f"{out['trainer_shell']['steady_step_ms']:.1f} ms/step "
        f"({last['rays_per_sec']:.0f} rays/s); loss_total {last['loss_total']:.5f}, "
        f"thickness_mean {last['thickness_mean']:.5f} (frozen "
        f"{last['thickness_frozen']:.0f}), kappa_r {last['kappa_r']:.4f}; validation PSNR "
        f"{val[0]['psnr']:.3f} SSIM {val[0]['ssim']:.4f}; frozen stage 1 bit-equal in the "
        f"checkpoint; peak memory {out['trainer_shell']['peak_gib']:.2f} GiB; launches "
        f"{paths['trainer_shell']}")

    ckpt = os.path.join(model, "model.ckpt")
    rec, paths["extract_s2"], secs = run(["extract-mesh-stage2", "--cfg", cfg_path, "--ckpt",
                                          ckpt, "--resolution", str(EXTRACT_S2_RESOLUTION)])
    want = 2 * slab_chunks(EXTRACT_S2_RESOLUTION)
    if paths["extract_s2"]["chain_fwd"] != want:
        raise AssertionError(f"extract-mesh-stage2 launched {paths['extract_s2']}: {want} "
                             "K1 expected (inner and frozen outer SDF)")
    out["extract_s2"] = dict(rec, total_s=secs)
    log(f"extract-mesh-stage2 at {EXTRACT_S2_RESOLUTION}^3: {secs:.2f} s: grid points "
        f"{rec['grid_s']:.2f} s, sweep {rec['sweep_s']:.2f} s (inner and frozen outer SDF, "
        f"{want} K1 launches), native marching {rec['march_s']:.2f} s, dedup "
        f"{rec['dedup_s']:.2f} s, write {rec['write_s']:.3f} s; {rec['tris']} triangles")
    if rec["tris"] == 0:
        raise AssertionError("extract-mesh-stage2 found no inner surface")

    (post, kept), paths["postprocess"], secs = run(
        ["postprocess-stage2", "--input", rec["mesh"], "--outer", outer_mesh,
         "--largest-component"])
    out["postprocess"] = dict(s=secs, kept=kept, of=rec["tris"])
    log(f"postprocess-stage2 --largest-component: {kept} of {rec['tris']} faces kept in "
        f"{secs:.2f} s")

    rs = np.random.RandomState(3)
    gt = rs.randn(200000, 3)
    np.save("gt_outer.npy", (0.5 * gt / np.linalg.norm(gt, axis=-1, keepdims=True))
            .astype(np.float32))
    geo, paths["eval_geometry"], secs = run(["eval-geometry", "--mesh", outer_mesh,
                                             "--gt", "gt_outer.npy"])
    if geo["chamfer"] is None or not math.isfinite(geo["chamfer"]):
        raise AssertionError(f"eval-geometry: {geo}")
    out["eval_geometry"] = dict(geo, s=secs)
    log(f"eval-geometry of the outer mesh against the analytic sphere (100,000 points a "
        f"side): chamfer {geo['chamfer']:.6f} in {secs:.2f} s")

    ev, paths["eval_images"], secs = run(["eval-images", "--cfg", cfg_path, "--ckpt",
                                          os.path.join(model, "model_best.ckpt"),
                                          "--split", "test"])
    if len(ev["views"]) != SCENE_VIEWS[1] or not all(
            math.isfinite(v["psnr"]) for v in ev["views"]):
        raise AssertionError(f"eval-images: {ev}")
    out["eval_images"] = dict(s=secs, mean_psnr=ev["mean_psnr"], mean_ssim=ev["mean_ssim"],
                              views=len(ev["views"]), launches=paths["eval_images"])
    log(f"eval-images on the test split: {len(ev['views'])} views, mean PSNR "
        f"{ev['mean_psnr']:.3f} SSIM {ev['mean_ssim']:.4f} in {secs:.1f} s; launches "
        f"{paths['eval_images']}")
    return paths, out


PIPELINE_STEPS = 100   # the front leg's 30,000 steps cut to 100 (K2 in all of them)
PIPELINE_INTERVAL = 50   # its validations and checkpoints
PIPELINE_SHELL_STEPS = 100   # each shell leg's 30,000 steps cut to 100
PIPELINE_SHELL_INTERVAL = 50
PIPELINE_SHELL_BUDGET = 1800.0   # seconds of shell_stage2's child: never reached
EVAL_SHELL_TOL = 1e-5


def eval_shell_check(what, cfg, card, cpu):
    """``eval_shell``'s numbers on the card against the CPU's: each relative
    to its own size, a field's std relative to the field's mean (its
    sigmoid outputs), which sets its rounding.  Raises above
    ``EVAL_SHELL_TOL``; returns the card's numbers and the error."""
    if sorted(card) != sorted(cpu) or [k for k in cpu if (card[k] is None) != (cpu[k] is None)]:
        raise AssertionError(f"eval_shell: card {card}, CPU {cpu}")
    scale = {"ior_field_std": cpu["learned_ior"] - cfg.get("ior_offset", 0.6),
             "thickness_field_std": cpu["learned_thickness"] / cfg.get("thickness_scale", 0.01)}
    errs = {}
    for k, v in cpu.items():
        if v is not None:
            a, b = np.asarray(card[k], np.float64), np.asarray(v, np.float64)
            errs[k] = float(np.max(np.abs(a - b))
                            / max(float(np.max(np.abs(scale.get(k, b)))), 1e-30))
    worst = max(errs.values())
    log(f"eval_shell on {what}: learned IoR {card['learned_ior']:.5f}, "
        f"thickness {card['learned_thickness']:.6f}, kappa {card.get('learned_kappa')}; "
        f"the card against the CPU: largest relative difference {worst:.2e} (tol "
        f"{EVAL_SHELL_TOL:.0e})")
    if not worst <= EVAL_SHELL_TOL:
        raise AssertionError(f"eval_shell on the card is off the CPU's: {errs}")
    return dict(card=card, max_rel_err=worst, tol=EVAL_SHELL_TOL)


def phase_pipeline(dev, work, shell_ckpt):
    """The leg runner's ``front`` leg (``nunerf_tpu_torch.pipeline``) in a
    working directory of its own: ``synth-scene`` at its defaults (48 + 8
    views of 128x128), ``train`` of ``configs/shape/nerf/nested.yaml`` at full
    width cut to ``PIPELINE_STEPS`` steps, its 512^3 ``extract-mesh-stage1``,
    ``eval-geometry`` against the scene's analytic outer surface and
    ``eval-images`` on the test split.  Then the port's ``eval_shell`` on the
    shell pipeline's checkpoint, on the card and on the CPU, against the
    scene's meta.  Returns (launches of the leg, numbers)."""
    import os

    from nunerf_tpu_torch import pipeline as pl
    from nunerf_tpu_torch.ops import fused_mlp as fm
    from nunerf_tpu_torch.ops import ray_intersect as ri
    from nunerf_tpu_torch.tools.eval_shell import eval_shell

    t_phase = time.perf_counter()
    leg_dir = os.path.join(work, "leg_front")
    cut = dict(total_step=PIPELINE_STEPS, val_interval=PIPELINE_INTERVAL,
               save_interval=PIPELINE_INTERVAL)
    fm.reset_launches()
    ri.reset_launches()
    rec = pl.run_leg("front", leg_dir, device=dev, cfg_overrides={pl.S1_NESTED: cut})
    torch.cuda.synchronize()
    launches = dict(fm.launches, **ri.launches)

    want = [os.path.join(leg_dir, p) for p in (
        "datasets/nested/meta.json", "data/model/nested/model.ckpt",
        "data/model/nested/model_best.ckpt", "data/model/nested/train_log.jsonl",
        rec["meshes"]["stage1"], "data/eval/nested/eval_test.json", "runs/leg_front.json")]
    missing = [p for p in want if not os.path.exists(p)]
    if missing:
        raise AssertionError(f"the front leg left no {missing}")
    if rec["steps"]["nested"]["to"] != PIPELINE_STEPS:
        raise AssertionError(f"the front leg trained {rec['steps']}")
    if not rec["meshes"]["stage1"].endswith(f"nested-{PIPELINE_STEPS}_simplified.ply"):
        raise AssertionError(f"the leg's mesh is {rec['meshes']['stage1']}")
    cham = rec["chamfer"]["outer"]["chamfer"]
    ev = rec["eval_images"]["nested"]
    if cham is None or not math.isfinite(cham):
        raise AssertionError(f"eval-geometry: {rec['chamfer']}")
    if ev["views"] != 8 or not (math.isfinite(ev["mean_psnr"])
                                and math.isfinite(ev["mean_ssim"])):
        raise AssertionError(f"eval-images: {ev}")
    logs = read_log(os.path.join(leg_dir, "data/model/nested/train_log.jsonl"))
    train = {r["step"]: r for r in logs if r["prefix"] == "train"}
    val = {r["step"]: r for r in logs if r["prefix"] == "val"}
    if sorted(val) != list(range(PIPELINE_INTERVAL, PIPELINE_STEPS + 1, PIPELINE_INTERVAL)) \
            or not all(math.isfinite(r["psnr"]) for r in val.values()):
        raise AssertionError(f"the front leg validated {val}")
    last = train[PIPELINE_STEPS]
    first = max((s for s in train if s < PIPELINE_STEPS), default=0) + 1
    if not (math.isfinite(last["loss_total"]) and last["rays_per_sec"] > 0
            and last["step_ms"] > 0):
        raise AssertionError(f"the front leg logged {last}")
    from nunerf_tpu_torch.config import load_cfg

    # the rays a step as the renderer resolved them (the trainer's own log)
    rays = round(last["rays_per_sec"] * last["step_ms"] / 1e3)
    out = dict(seconds={c["command"]: c["s"] for c in rec["commands"]},
               rays=rays, step_ms=last["step_ms"], rays_per_s=last["rays_per_sec"],
               loss_total=last["loss_total"], val={s: (r["psnr"], r["ssim"])
                                                   for s, r in val.items()},
               chamfer=cham, test_psnr=ev["mean_psnr"], test_ssim=ev["mean_ssim"],
               test_step=ev["step"], mesh=rec["meshes"]["stage1"],
               extract=rec["extract_s1"], launches=launches)
    log(f"front leg (pipeline.run_leg, nested.yaml at full width: {rays} rays a step, "
        f"{PIPELINE_STEPS} steps): " + ", ".join(
            f"{c['command']} {c['s']:.2f} s" for c in rec["commands"]))
    log(f"front leg: steps {first}-{PIPELINE_STEPS} {out['step_ms']:.1f} ms/step "
        f"({last['rays_per_sec']:.0f} rays/s, with a validation and a checkpoint); "
        f"validation PSNR/SSIM {out['val']}; {rec['meshes']['stage1']}: chamfer {cham:.6f}; "
        f"test ({ev['views']} views, step {ev['step']}) PSNR {ev['mean_psnr']:.3f} SSIM "
        f"{ev['mean_ssim']:.4f}; launches {launches}")

    # eval_shell on the shell pipeline's checkpoint: the card against the CPU
    with open(os.path.join(leg_dir, "datasets/nested/meta.json")) as f:
        meta = json.load(f)
    cfg = load_cfg("shell.yaml")
    card = eval_shell(cfg, meta, shell_ckpt, device=dev)
    out["eval_shell"] = eval_shell_check("the shell checkpoint", cfg, card,
                                         eval_shell(cfg, meta, shell_ckpt, device="cpu"))
    out["s"] = time.perf_counter() - t_phase
    log(f"phase_pipeline: {out['s']:.1f} s")
    return launches, out


def phase_pipeline_shell(dev, work):
    """The leg runner's three curvature-shell legs in one working directory
    of their own, at full width, each cut to ``PIPELINE_SHELL_STEPS`` steps
    through ``cfg_overrides``: ``shell_front`` (``synth-scene --shell``,
    ``configs/shape/nerf/nested_shell.yaml``, the 512^3
    ``extract-mesh-stage1``, ``postprocess-outer`` through K3,
    ``eval-geometry``, ``eval-images``), then ``shell_stage2`` (its
    ``train`` in a child under a budget it never reaches, ``eval_shell``,
    ``extract-mesh-stage2`` at 256^3, ``postprocess-stage2``,
    ``eval-geometry`` of the inner mesh, ``eval-images``), its ``train``
    keeping the parameters at ``PIPELINE_SHELL_INTERVAL`` (``--keep``), then
    ``shell_stage2b`` the same way on the same stage 1
    (``configs/stage2/nerf/nested_shell_b.yaml``: the absorption held at its
    init before step 3,000 and while the inner inv_s is under 200), each
    stage-2 config reading the chained outer mesh.  Checked: every artifact
    is there, the kept copy (that step, no Adam state), the chained mesh
    names, each child's config and its K3 launches, the steps and
    validations logged, finite losses, the outer chamfer and the test scores
    finite, and ``eval_shell`` of both stage-2 legs on the card against the
    CPU.  The inner geometry is not checked here: a stage 2 of 100 steps
    carves no inner surface yet, so ``extract-mesh-stage2``,
    ``postprocess-stage2`` and ``eval-geometry`` of the inner mesh run on
    an empty mesh, and the phase checks only that ``eval-geometry`` reports
    it as empty (a finite chamfer where a surface was carved).  The launch
    counts are this process's: the budgeted children's ``train`` count in
    their own, read back from their records.  Returns (launches, numbers)."""
    import os

    from nunerf_tpu_torch import pipeline as pl
    from nunerf_tpu_torch.config import load_cfg
    from nunerf_tpu_torch.ops import fused_mlp as fm
    from nunerf_tpu_torch.ops import ray_intersect as ri
    from nunerf_tpu_torch.tools.eval_shell import eval_shell

    t_phase = time.perf_counter()
    leg_dir = os.path.join(work, "leg_shell")
    n, every = PIPELINE_SHELL_STEPS, PIPELINE_SHELL_INTERVAL
    cut = dict(total_step=n, val_interval=every, save_interval=every)
    outer = f"./data/meshes/nested_shell-{n}_simplified_outer.ply"
    over = {pl.S1_SHELL: cut, pl.S2_SHELL: dict(cut, stage1_mesh_dir=outer),
            pl.S2_SHELL_B: dict(cut, stage1_mesh_dir=outer)}
    fm.reset_launches()
    ri.reset_launches()
    front = pl.run_leg("shell_front", leg_dir, device=dev, cfg_overrides=over)
    stage2 = pl.run_leg("shell_stage2", leg_dir, budget=PIPELINE_SHELL_BUDGET, device=dev,
                        cfg_overrides=over, keep=(every,))
    stage2b = pl.run_leg("shell_stage2b", leg_dir, budget=PIPELINE_SHELL_BUDGET, device=dev,
                         cfg_overrides=over)
    torch.cuda.synchronize()
    launches = dict(fm.launches, **ri.launches)

    meshes = dict(stage1=f"data/meshes/nested_shell-{n}_simplified.ply", outer=outer[2:])
    if front["meshes"] != meshes:
        raise AssertionError(f"shell_front's meshes are {front['meshes']}, not {meshes}")
    inner = f"data/meshes/nested_shell_s2-{n}-inner.ply"
    for r, name, rel in ((stage2, "nested_shell_s2", pl.S2_SHELL),
                         (stage2b, "nested_shell_s2b", pl.S2_SHELL_B)):
        mine = f"data/meshes/{name}-{n}-inner.ply"
        if r["meshes"] != dict(inner=mine, inner_post=mine[:-4] + "_post.ply"):
            raise AssertionError(f"{r['leg']}'s meshes are {r['meshes']}")
        post = [c["argv"] for c in r["commands"] if c["command"] == "postprocess-stage2"]
        if post != [["postprocess-stage2", "--input", mine, "--outer", outer]]:
            raise AssertionError(f"{r['leg']}'s postprocess-stage2 ran {post}")
        # the budgeted child ran the leg's own config, and ended by itself
        train = r["commands"][0]
        argv = train["argv"]
        if argv[argv.index("--cfg") + 1] != rel or train["paused"]:
            raise AssertionError(f"{r['leg']}'s train child ran {train}")
    want = [os.path.join(leg_dir, p) for p in (
        "datasets/nested_shell/meta.json", "data/model/nested_shell/model.ckpt",
        "data/model/nested_shell/model_best.ckpt", "data/model/nested_shell/train_log.jsonl",
        "data/model/nested_shell_s2/model.ckpt", "data/model/nested_shell_s2/model_best.ckpt",
        "data/model/nested_shell_s2/train_log.jsonl", "data/eval/nested_shell/eval_test.json",
        "data/eval/nested_shell_s2/eval_test.json", "runs/leg_shell_front.json",
        "runs/leg_shell_stage2.json", "runs/eval_shell_nested_shell_s2.json",
        "data/model/nested_shell_s2b/model.ckpt", "data/model/nested_shell_s2b/model_best.ckpt",
        "data/model/nested_shell_s2b/train_log.jsonl",
        "data/eval/nested_shell_s2b/eval_test.json", "runs/leg_shell_stage2b.json",
        "runs/eval_shell_nested_shell_s2b.json",
        *front["meshes"].values(), *stage2["meshes"].values(), *stage2b["meshes"].values())]
    missing = [p for p in want if not os.path.exists(p)]
    if missing:
        raise AssertionError(f"the shell legs left no {missing}")
    # the budgeted child's --keep: the parameters alone at the asked step
    from nunerf_tpu_torch.train.trainer import load_checkpoint
    kept = f"data/model/nested_shell_s2/model_{every}.ckpt.gz"
    if stage2.get("kept") != [kept]:
        raise AssertionError(f"shell_stage2 kept {stage2.get('kept')}, not [{kept}]")
    k_step, k_params, k_opt, _ = load_checkpoint(os.path.join(leg_dir, kept))
    last = load_checkpoint(os.path.join(leg_dir, "data/model/nested_shell_s2/model.ckpt"))
    if k_step != every or k_opt is not None or sorted(k_params) != sorted(last[1]):
        raise AssertionError(f"{kept}: step {k_step}, Adam state {k_opt is not None}")
    steps = {"nested_shell": front["steps"]["nested_shell"],
             "nested_shell_s2": stage2["steps"]["nested_shell_s2"],
             "nested_shell_s2b": stage2b["steps"]["nested_shell_s2b"]}
    for name, st in steps.items():
        if st != {"from": 0, "to": n, "total_step": n, "paused": False}:
            raise AssertionError(f"{name} trained {st}")
    legs = (front, stage2, stage2b)
    out = dict(seconds={f"{r['leg']}/{c['command']}": c["s"] for r in legs
                        for c in r["commands"]},
               chamfer={"outer": front["chamfer"]["outer"]["chamfer"],
                        "inner": stage2["chamfer"]["inner"]["chamfer"],
                        "inner_b": stage2b["chamfer"]["inner"]["chamfer"]},
               test={k: v for r in legs for k, v in r["eval_images"].items()},
               launches=launches,
               launches_by_child={r["leg"]: r["train_child"]["launches"]
                                  for r in (stage2, stage2b)})
    for r in (stage2, stage2b):
        if not r["train_child"]["launches"].get("closest_hit", 0) > 0:
            raise AssertionError(f"{r['leg']}'s train child launched K3 no time: "
                                 f"{r['train_child']}")
    for r in legs:
        for name, ev in r["eval_images"].items():
            # the best validation's checkpoint
            if ev["views"] != 8 or ev["step"] not in range(every, n + 1, every) or not (
                    math.isfinite(ev["mean_psnr"]) and math.isfinite(ev["mean_ssim"])):
                raise AssertionError(f"eval-images of {name}: {ev}")
    # a stage 2 cut to 100 steps carves no inner surface inside the outer
    # one yet: then the inner mesh is empty and eval-geometry must say so
    from nunerf_tpu_torch.tracing.mesh_ops import load_ply

    if not math.isfinite(out["chamfer"]["outer"]):
        raise AssertionError(f"eval-geometry of the outer mesh: {out['chamfer']}")
    for r, key in ((stage2, "inner_triangles"), (stage2b, "inner_triangles_b")):
        inner_tris = len(load_ply(os.path.join(leg_dir, r["meshes"]["inner_post"]))[1])
        geo = r["chamfer"]["inner"]
        empty = inner_tris == 0 and geo["chamfer"] is None and \
            geo.get("error", "").startswith("empty surface: pred=0 ")
        out[key] = inner_tris
        if not (empty or (geo["chamfer"] is not None and math.isfinite(geo["chamfer"]))):
            raise AssertionError(f"eval-geometry of {r['leg']}: {geo}, inner mesh of "
                                 f"{inner_tris} triangles")
    for name in steps:
        logs = read_log(os.path.join(leg_dir, "data/model", name, "train_log.jsonl"))
        val = sorted(r["step"] for r in logs if r["prefix"] == "val")
        last = [r for r in logs if r["prefix"] == "train" and r["step"] == n]
        if val != list(range(every, n + 1, every)) or not (
                last and math.isfinite(last[0]["loss_total"]) and last[0]["step_ms"] > 0):
            raise AssertionError(f"{name} logged validations {val} and {last}")
        out[f"{name}_step_ms"] = last[0]["step_ms"]
        out[f"{name}_loss_total"] = last[0]["loss_total"]
    log(f"shell legs (pipeline.run_leg at full width, {n} steps each): " + ", ".join(
        f"{k} {v:.2f} s" for k, v in out["seconds"].items()))
    log(f"shell legs: {front['meshes']['outer']} chamfer {out['chamfer']['outer']:.6f}, "
        f"{inner} post: {out['inner_triangles']} triangles, chamfer "
        f"{out['chamfer']['inner']}; the absorption-gated shell_stage2b's post: "
        f"{out['inner_triangles_b']} triangles, chamfer {out['chamfer']['inner_b']}; test "
        f"{out['test']}; stage 1 {out['nested_shell_step_ms']:.1f} ms/step, stage 2 "
        f"{out['nested_shell_s2_step_ms']:.1f} and the gated "
        f"{out['nested_shell_s2b_step_ms']:.1f} ms/step (their children's), step-{n} "
        f"loss_total {out['nested_shell_s2_loss_total']:.5f} and "
        f"{out['nested_shell_s2b_loss_total']:.5f}; launches {launches}, in the children "
        f"{out['launches_by_child']}")

    # eval_shell on the leg's checkpoint: the leg's record (the card) against
    # the CPU, in the leg's working directory
    with open(os.path.join(leg_dir, "datasets/nested_shell/meta.json")) as f:
        meta = json.load(f)
    for r, rel, key in ((stage2, pl.S2_SHELL, "eval_shell"),
                        (stage2b, pl.S2_SHELL_B, "eval_shell_b")):
        cfg = load_cfg(os.path.join(leg_dir, rel))
        cwd = os.getcwd()
        os.chdir(leg_dir)
        try:
            cpu = eval_shell(cfg, meta, device="cpu")
        finally:
            os.chdir(cwd)
        out[key] = eval_shell_check(f"{r['leg']}'s checkpoint", cfg, r["eval_shell"], cpu)
    # before step 3,000 shell_stage2b's gate holds the absorption at its init
    init = float(torch.nn.functional.softplus(torch.tensor(-2.0)))
    kappa = stage2b["eval_shell"]["learned_kappa"]
    if not all(abs(k - init) <= 1e-6 * init for k in kappa):
        raise AssertionError(f"shell_stage2b's absorption moved under its gate: {kappa}, "
                             f"init {init}")
    out["s"] = time.perf_counter() - t_phase
    log(f"phase_pipeline_shell: {out['s']:.1f} s")
    return launches, out


PIPELINE_STAGE2_STEPS = 100   # the stage2 leg's 60,000 steps cut to 100
PIPELINE_STAGE2_INTERVAL = 50   # its validations and checkpoints
PIPELINE_STAGE2_BUDGET = 1200.0   # seconds of its train child: never reached


def phase_pipeline_stage2(dev, work):
    """The leg runner's zero-thickness ``stage2`` leg in ``phase_pipeline``'s
    working directory, on its ``front`` leg: ``configs/stage2/nerf/nested.yaml``
    at full width, with its own rays and samples (1,024 rays, 176 clipped
    outer samples, 64 + 2 x 32 inside the glass, three K3 traces a step),
    cut to ``PIPELINE_STAGE2_STEPS`` steps with validations and checkpoints
    every ``PIPELINE_STAGE2_INTERVAL`` and reading the front leg's chained
    mesh through ``cfg_overrides``; its ``train`` in a budgeted child that
    never reaches its budget, then ``extract-mesh-stage2`` at 256^3 (K1),
    ``postprocess-stage2 --outer`` the front mesh, ``eval-geometry`` of the
    inner mesh against the scene's and ``eval-images`` on the test split
    (K3).  Checked: every artifact, the chained mesh names, the steps and
    validations logged, a finite loss, the inner chamfer and the 8 test
    views finite (not judged: 100 steps carve no inner surface), and the
    launches: K3 in the child (its own count, ``train_child``) and K1 and K3
    in this process.  Returns (launches of the path: this process's and the
    child's, summed; numbers)."""
    import os

    from nunerf_tpu_torch import pipeline as pl
    from nunerf_tpu_torch.ops import fused_mlp as fm
    from nunerf_tpu_torch.ops import ray_intersect as ri

    t_phase = time.perf_counter()
    leg_dir = os.path.join(work, "leg_front")
    n, every = PIPELINE_STAGE2_STEPS, PIPELINE_STAGE2_INTERVAL
    mesh = f"./data/meshes/nested-{PIPELINE_STEPS}_simplified.ply"
    cut = dict(total_step=n, val_interval=every, save_interval=every, stage1_mesh_dir=mesh)
    fm.reset_launches()
    ri.reset_launches()
    rec = pl.run_leg("stage2", leg_dir, budget=PIPELINE_STAGE2_BUDGET, device=dev,
                     cfg_overrides={pl.S2_NESTED: cut})
    torch.cuda.synchronize()
    here = dict(fm.launches, **ri.launches)

    child = rec.get("train_child")
    if child is None:
        raise AssertionError(f"the stage2 train child left no launch record: {rec['commands']}")
    launches = {k: here[k] + child["launches"].get(k, 0) for k in here}
    inner = f"data/meshes/nested_s2-{n}-inner.ply"
    if rec["meshes"] != dict(inner=inner, inner_post=inner[:-4] + "_post.ply"):
        raise AssertionError(f"the stage2 leg's meshes are {rec['meshes']}")
    post = [c["argv"] for c in rec["commands"] if c["command"] == "postprocess-stage2"]
    if post != [["postprocess-stage2", "--input", inner, "--outer", mesh]]:
        raise AssertionError(f"postprocess-stage2 ran {post}")
    want = [os.path.join(leg_dir, p) for p in (
        "data/model/nested_s2/model.ckpt", "data/model/nested_s2/model_best.ckpt",
        "data/model/nested_s2/train_log.jsonl", "data/eval/nested_s2/eval_test.json",
        "runs/leg_stage2.json", *rec["meshes"].values())]
    missing = [p for p in want if not os.path.exists(p)]
    if missing:
        raise AssertionError(f"the stage2 leg left no {missing}")
    if rec["steps"]["nested_s2"] != {"from": 0, "to": n, "total_step": n, "paused": False}:
        raise AssertionError(f"the stage2 leg trained {rec['steps']}")
    logs = read_log(os.path.join(leg_dir, "data/model/nested_s2/train_log.jsonl"))
    val = {r["step"]: r for r in logs if r["prefix"] == "val"}
    last = [r for r in logs if r["prefix"] == "train" and r["step"] == n]
    if sorted(val) != list(range(every, n + 1, every)) or not all(
            math.isfinite(r["psnr"]) for r in val.values()):
        raise AssertionError(f"the stage2 leg validated {val}")
    if not (last and math.isfinite(last[0]["loss_total"]) and last[0]["step_ms"] > 0
            and last[0]["rays_per_sec"] > 0):
        raise AssertionError(f"the stage2 leg logged {last}")
    last = last[0]
    cham = rec["chamfer"]["inner"]["chamfer"]
    ev = rec["eval_images"]["nested_s2"]
    if cham is None or not math.isfinite(cham):
        raise AssertionError(f"eval-geometry of the inner mesh: {rec['chamfer']}")
    if ev["views"] != 8 or ev["step"] not in range(every, n + 1, every) or not (
            math.isfinite(ev["mean_psnr"]) and math.isfinite(ev["mean_ssim"])):
        raise AssertionError(f"eval-images: {ev}")
    for where, counter, count in (("the train child", "closest_hit", child["launches"]),
                                  ("eval-images", "closest_hit", here),
                                  ("extract-mesh-stage2", "chain_fwd", here)):
        if not count.get(counter, 0) > 0:
            raise AssertionError(f"{where} launched {counter} no time: {count}")
    rays = round(last["rays_per_sec"] * last["step_ms"] / 1e3)
    out = dict(seconds={c["command"]: c["s"] for c in rec["commands"]}, rays=rays,
               step_ms=last["step_ms"], rays_per_s=last["rays_per_sec"],
               peak_gib=(child["max_memory_allocated"] or 0) / 2 ** 30,
               loss_total=last["loss_total"], ior_frozen=last.get("ior_frozen"),
               val={s: (r["psnr"], r["ssim"]) for s, r in val.items()}, inner_chamfer=cham,
               test_psnr=ev["mean_psnr"], test_ssim=ev["mean_ssim"], test_step=ev["step"],
               outer_mesh=mesh, launches=launches,
               launches_by_process={"train_child": child["launches"], "this": here})
    log(f"stage2 leg (pipeline.run_leg, nested.yaml at full width: {rays} rays a step, {n} "
        f"steps, on {mesh}): " + ", ".join(f"{c['command']} {c['s']:.2f} s"
                                          for c in rec["commands"]))
    log(f"stage2 leg: step {n} {out['step_ms']:.1f} ms/step ({last['rays_per_sec']:.0f} "
        f"rays/s, the child's log), peak memory {out['peak_gib']:.2f} GiB; validation "
        f"PSNR/SSIM {out['val']}; inner chamfer {cham:.6f} (not judged); test ({ev['views']} "
        f"views, step {ev['step']}) PSNR {ev['mean_psnr']:.3f} SSIM {ev['mean_ssim']:.4f}; "
        f"launches {out['launches_by_process']}")
    out["s"] = time.perf_counter() - t_phase
    log(f"phase_pipeline_stage2: {out['s']:.1f} s")
    return launches, out


RES1024_K3_SAMPLE = 4096   # rays of one view held to the brute plain closest hit
RES1024_K3_TILE = 4096     # triangles a step of that plain sweep


def counted_commands(fn):
    """``fn()`` with every ``cli.main`` subcommand it runs wrapped: returns
    (what ``fn`` returns, {subcommand: the launches it made}), each read
    after a synchronise.  The counters are not reset: the caller sets them
    to 0 before and reads the path's whole count after."""
    from nunerf_tpu_torch import cli
    from nunerf_tpu_torch.ops import fused_mlp as fm
    from nunerf_tpu_torch.ops import ray_intersect as ri

    by, real = {}, cli.main

    def main(argv=None):
        before = dict(fm.launches, **ri.launches)
        try:
            return real(argv)
        finally:
            torch.cuda.synchronize()
            mine = by.setdefault(argv[0], {})
            for k, v in dict(fm.launches, **ri.launches).items():
                mine[k] = mine.get(k, 0) + v - before[k]

    cli.main = main
    try:
        return fn(), by
    finally:
        cli.main = real


def views_rays(db, ids, n, dev):
    """The first ``n`` rays of the views ``ids`` in turn, as ``render-mask``
    builds each view's: (rays_o, rays_d) f32 on ``dev``."""
    from nunerf_tpu_torch.tools import render_mask as rm

    os_, ds_, have = [], [], 0
    for i in ids:
        o, d, _, _ = rm.view_rays(db, i, True)
        os_.append(o)
        ds_.append(d)
        have += len(o)
        if have >= n:
            break
    return tuple(torch.as_tensor(np.concatenate(a)[:n], device=dev) for a in (os_, ds_))


def k3_on_raw_mesh(dev, mesh_path, db):
    """K3 on a raw marched mesh as ``render-mask`` traces it: the scene's
    build seconds and its index; K3's ms on ``render_mask.CHUNK`` rays of
    the database's first views (one launch of the tool's size) beside the
    bounds of the flat and the two-level culled work those rays needed, and
    its device time by kernel; then K3 on ``RES1024_K3_SAMPLE`` rays drawn
    from the first view (seed 0) against the brute plain closest hit
    (``closest_hit_reference`` in the scene's tolerant mode, every
    triangle), ``t``, index and ``hit`` held bit for bit.  Raises where K3
    disagrees; returns the numbers."""
    from nunerf_tpu_torch.ops import ray_intersect as ri
    from nunerf_tpu_torch.tools import render_mask as rm
    from nunerf_tpu_torch.tracing.scene import Scene

    t0 = time.perf_counter()
    scene = Scene(mesh_path, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    index = scene.kernel_index
    ids = db.get_img_ids()
    o, d = views_rays(db, ids, rm.CHUNK, dev)
    c = len(o)
    ms = cuda_ms(lambda: scene.intersect(o, d), 5)
    stats = torch.zeros(2, dtype=torch.int64, device=dev)
    _, _, hit = ri.closest_hit_cuda(o, d, index, stats=stats, tol=scene.kernel_tol)
    bound, by = k3_bound(ri, index, c, stats)
    bound2, by2, tile_tests = k3_bound_two_level(ri, index, o, d, stats)
    split = k3_device_split(lambda: scene.intersect(o, d))
    n_tris, n_tiles, n_groups = len(scene.tris_np), index.box.shape[0], index.gbox.shape[0]
    rec = dict(triangles=n_tris, tiles=n_tiles, groups=n_groups, scene_build_s=build_s,
               rays=c, hit_share=float(hit.double().mean()), ms=ms, bound_ms=bound,
               bound_by=by, bound_ms_two_level=bound2, bound_by_two_level=by2,
               device_ms_by_kernel=split, box_tests=c * n_groups + tile_tests,
               tri_pairs=int(stats[1]), k3_rays_per_s=c / ms * 1e3)
    log(f"K3 on the raw mesh ({n_tris} triangles, {n_tiles} tiles in {n_groups} groups; "
        f"scene built in {build_s:.2f} s): {ms:.3f} ms for {c} rays of the first views "
        f"(hit share {rec['hit_share']:.3f}); bound of the flat work {bound:.4f} ms ({by}), "
        f"of the two-level work {bound2:.4f} ms ({by2}); {tile_tests / c:.1f} tile tests "
        f"and {int(stats[1]) / c:.0f} triangles a ray; device ms by kernel {split}")

    v0_o, v0_d, _, _ = rm.view_rays(db, ids[0], True)
    gen = torch.Generator().manual_seed(0)
    pick = torch.randperm(len(v0_o), generator=gen)[:RES1024_K3_SAMPLE]
    so, sd = (torch.as_tensor(a, device=dev)[pick.to(dev)] for a in (v0_o, v0_d))
    t, idx, hit = ri.closest_hit_cuda(so, sd, index, tol=scene.kernel_tol)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rt, ridx, rhit = ri.closest_hit_reference(so, sd, scene.v0, scene.e1, scene.e2,
                                              tile=RES1024_K3_TILE, tol=scene.kernel_tol)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    same = torch.equal(t, rt) and torch.equal(idx, ridx) and torch.equal(hit, rhit)
    rec.update(sample=len(pick), sample_hits=int(hit.sum()), plain="closest_hit_reference "
               f"(brute, tolerant mode {scene.kernel_tol:g}), every triangle",
               plain_s=plain_s, max_abs_err=float((t - rt).abs().max()), exact=same)
    log(f"K3 on the raw mesh against the brute plain closest hit: {len(pick)} rays of view "
        f"{ids[0]} (seed 0), {rec['sample_hits']} hits; t, index and hit "
        f"{'equal' if same else 'DIFFER'} (held exactly), max |t - plain| "
        f"{rec['max_abs_err']:.1e}; the plain sweep in {plain_s:.1f} s")
    if not same:
        bad = (int((idx != ridx).sum()), int((hit != rhit).sum()), int((t != rt).sum()))
        raise AssertionError(f"K3 on the raw mesh disagrees with its plain version: {bad} "
                             "(index, hit, t) rays differ")
    if not 0 < rec["sample_hits"] < len(pick):
        raise AssertionError(f"the sample's rays all {'miss' if not rec['sample_hits'] else 'hit'}")
    del scene
    torch.cuda.empty_cache()
    return rec


def phase_pipeline_res1024(dev, work):
    """The leg runner's ``res1024`` leg in ``phase_pipeline``'s working
    directory, on its 100-step ``front``, at the leg's own 1024^3:
    ``extract-mesh-stage1 --resolution 1024 --tag r1024`` (K1 over 2^30 grid
    points, ``slab_chunks(1024)`` launches of up to 2^21, the native
    marching, the dedup and the remesh), then ``render-mask`` on the raw
    mesh (K3 on every pixel of the 48 train views).  Checked: the mesh named
    from the checkpoint's step with its tag, both meshes and the 48 masks
    there, the launches of each subcommand, then K3 on that raw mesh
    against the brute plain closest hit (``k3_on_raw_mesh``).  Returns
    (launches, numbers)."""
    import os
    import resource

    from nunerf_tpu_torch import pipeline as pl
    from nunerf_tpu_torch.data.database import parse_database_name
    from nunerf_tpu_torch.ops import fused_mlp as fm
    from nunerf_tpu_torch.ops import ray_intersect as ri

    t_phase = time.perf_counter()
    leg_dir = os.path.join(work, "leg_front")
    torch.cuda.reset_peak_memory_stats()
    fm.reset_launches()
    ri.reset_launches()
    rec, by_cmd = counted_commands(lambda: pl.run_leg("res1024", leg_dir, device=dev))
    torch.cuda.synchronize()
    launches = dict(fm.launches, **ri.launches)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    rss_gib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20

    raw = f"data/meshes/nested-{PIPELINE_STEPS}_r1024.ply"
    if rec["meshes"] != {"raw": raw, "stage1": raw[:-4] + "_simplified.ply"} or \
            rec["checkpoints"] != {
            "extract-mesh-stage1": PIPELINE_STEPS}:
        raise AssertionError(f"the res1024 leg's meshes {rec['meshes']}, checkpoints "
                             f"{rec['checkpoints']}")
    if [c["command"] for c in rec["commands"]] != ["extract-mesh-stage1", "render-mask"]:
        raise AssertionError(f"the res1024 leg ran {rec['commands']}")
    db = parse_database_name("nerf/nested", os.path.join(leg_dir, "datasets"))
    masks = os.path.join(leg_dir, "datasets/nested/mask")
    n_masks = sum(len(names) for _, _, names in os.walk(masks))
    want = [os.path.join(leg_dir, p) for p in (raw, raw[:-4] + "_simplified.ply",
                                               "runs/leg_res1024.json")]
    missing = [p for p in want if not os.path.exists(p)]
    n_views = len(db.get_img_ids())
    sweeps = slab_chunks(1024)
    x = by_cmd["extract-mesh-stage1"]
    m = by_cmd["render-mask"]
    out = dict(seconds={c["command"]: c["s"] for c in rec["commands"]},
               extract=rec["extract_s1"], **rec["mesh_counts"], launches=launches,
               by_command=by_cmd, k1_expected=sweeps, masks=n_masks, views=n_views,
               peak_device_gib=peak_gib, peak_host_rss_gib=rss_gib)
    log(f"res1024 leg (pipeline.run_leg at 1024^3 on the {PIPELINE_STEPS}-step front): "
        + ", ".join(f"{c['command']} {c['s']:.2f} s" for c in rec["commands"])
        + "; extract-mesh-stage1 by part: " + ", ".join(
            f"{k} {v:.2f}" for k, v in rec["extract_s1"].items())
        + f"; {raw}: {out['verts']} vertices, {out['tris']} triangles, remeshed "
        f"{out['tris_simplified']}; K1 launches {x['chain_fwd']} ({sweeps} expected), "
        f"render-mask's K3 launches {m['closest_hit']} for {n_views} views, {n_masks} masks; "
        f"peak device memory {peak_gib:.2f} GiB, peak host RSS {rss_gib:.2f} GiB; "
        f"launches {launches}")
    if missing:
        raise AssertionError(f"the res1024 leg left no {missing}")
    if x["chain_fwd"] != sweeps or x["closest_hit"] != 0:
        raise AssertionError(f"extract-mesh-stage1 at 1024^3 launched {x}: {sweeps} K1 "
                             "expected")
    if m["closest_hit"] != n_views or m["chain_fwd"] != 0 or n_masks != n_views:
        raise AssertionError(f"render-mask launched {m} and wrote {n_masks} masks for "
                             f"{n_views} views")
    out["k3"] = k3_on_raw_mesh(dev, os.path.join(leg_dir, raw), db)
    if out["k3"]["triangles"] != out["tris"]:
        raise AssertionError(f"K3 traced {out['k3']['triangles']} triangles of {out['tris']}")
    out["leg_s"] = rec["seconds"]
    out["s"] = time.perf_counter() - t_phase
    log(f"phase_pipeline_res1024: {out['s']:.1f} s")
    return launches, out


PIPELINE_REAL_STEPS = 100   # each real leg's 20,000 / 32,000 / 30,000 steps cut to 100
PIPELINE_REAL_INTERVAL = 50   # their validations and checkpoints
PIPELINE_REAL_BUDGET = 1200.0   # seconds of real_stage2's train child: never reached
REAL_VIEWS, REAL_TEST_VIEWS = 56, 7   # synth-scene --colmap --n-train 56; 1/8 held out


def phase_pipeline_real(dev, work):
    """The leg runner's three real-capture legs in a working directory of
    their own, at full width with each config's own rays and samples, each
    cut to ``PIPELINE_REAL_STEPS`` steps with validations and checkpoints
    every ``PIPELINE_REAL_INTERVAL``: ``real_front`` (``synth-scene --colmap
    --shell --n-train 56``, ``configs/shape/real/nested_real.yaml``: NeRO
    rays, ``sphere_direction``, ``normal_ori``; ``extract-mesh-stage1`` at
    384^3, ``postprocess-outer``, ``eval-geometry``, ``render-mask``,
    ``mask-erosion``), ``real_boot`` (``silhouette-prior``, ``render-mask``
    of the hull, ``nested_real_boot.yaml`` on the ``rawmask`` database with
    the mask term, then its mesh at 384^3, ``postprocess-outer``,
    ``eval-geometry``, ``render-mask`` and ``mask-erosion`` anew,
    ``eval-images --split test`` of ``model.ckpt``), then ``real_stage2``
    (``configs/stage2/real/nested_real.yaml`` on the boot's mesh and
    checkpoint through ``pipeline.boot_overrides``; its ``train`` in a
    budgeted child that never reaches its budget, ``eval_shell``,
    ``extract-mesh-stage2`` at 256^3, ``postprocess-stage2``,
    ``eval-geometry``, ``eval-images --split test``).  Checked: every
    artifact and the mesh names handed on, the 56 prior, boot and eroded
    masks, the steps and validations logged, finite losses, the chamfers,
    the test views and ``eval_shell``'s fields finite (not judged: 100 steps
    carve no surface), and the launches of each subcommand: K1 and K2 in the
    stage-1 ``train``s, K1 in the three extractions and the boot's
    ``eval-images``, K3 in ``postprocess-outer``, ``render-mask``, the
    stage-2 child (its own count) and the stage 2's ``eval-images``.  Returns (launches of the path: this
    process's and the child's, summed; numbers)."""
    import glob
    import hashlib
    import os

    from nunerf_tpu_torch import pipeline as pl
    from nunerf_tpu_torch.ops import fused_mlp as fm
    from nunerf_tpu_torch.ops import ray_intersect as ri

    t_phase = time.perf_counter()
    leg_dir = os.path.join(work, "leg_real")
    n, every = PIPELINE_REAL_STEPS, PIPELINE_REAL_INTERVAL
    cut = dict(total_step=n, val_interval=every, save_interval=every)
    over = {pl.S1_REAL: cut, pl.S1_BOOT: cut, pl.S2_REAL: cut}
    scene = os.path.join(leg_dir, "datasets/nested_real")
    by_command, masks, peaks = [], {}, {}
    real_cli = pl._Leg.cli

    def cli(leg, *argv):
        # each subcommand's launches, and the masks each mask writer leaves
        before = dict(fm.launches, **ri.launches)
        out = real_cli(leg, *argv)
        torch.cuda.synchronize()
        after = dict(fm.launches, **ri.launches)
        by_command.append((leg.record["leg"], argv[0],
                           {k: after[k] - before[k] for k in after if after[k] != before[k]}))
        if argv[0] in ("render-mask", "mask-erosion"):
            sub = "mask" if argv[0] == "render-mask" else "mask_erosion"
            files = sorted(glob.glob(os.path.join(scene, sub, "*.png")))
            digest = hashlib.sha256(b"".join(open(f, "rb").read() for f in files)).hexdigest()
            masks.setdefault(leg.record["leg"], []).append((argv[0], len(files), digest))
        return out

    fm.reset_launches()
    ri.reset_launches()
    pl._Leg.cli = cli
    recs = {}
    try:
        for leg in ("real_front", "real_boot", "real_stage2"):
            torch.cuda.reset_peak_memory_stats()
            if leg == "real_stage2":
                boot = pl.boot_overrides(leg_dir)[pl.S2_REAL]
                over[pl.S2_REAL] = dict(cut, **boot)
            recs[leg] = pl.run_leg(leg, leg_dir, device=dev, cfg_overrides=over,
                                   budget=PIPELINE_REAL_BUDGET if leg == "real_stage2" else None)
            torch.cuda.synchronize()
            peaks[leg] = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        pl._Leg.cli = real_cli
    here = dict(fm.launches, **ri.launches)
    front, boot, stage2 = recs["real_front"], recs["real_boot"], recs["real_stage2"]
    child = stage2.get("train_child")
    if child is None:
        raise AssertionError(f"real_stage2's train child left no launch record: "
                             f"{stage2['commands']}")
    launches = {k: here[k] + child["launches"].get(k, 0) for k in here}

    names = {"real_front": "nested_real", "real_boot": "nested_real_boot"}
    for leg, name in names.items():
        want = dict(stage1=f"data/meshes/{name}-{n}_simplified.ply",
                    outer=f"data/meshes/{name}-{n}_simplified_outer.ply")
        if recs[leg]["meshes"] != want:
            raise AssertionError(f"{leg}'s meshes are {recs[leg]['meshes']}, not {want}")
    traced = "./" + boot["meshes"]["outer"]
    if stage2["stage1"] != {"mesh": traced, "ckpt": "./data/model/nested_real_boot/model.ckpt",
                            "ckpt_step": n}:
        raise AssertionError(f"real_stage2 traced {stage2['stage1']}")
    inner = f"data/meshes/nested_real_s2-{n}-inner.ply"
    if stage2["meshes"] != dict(inner=inner, inner_post=inner[:-4] + "_post.ply"):
        raise AssertionError(f"real_stage2's meshes are {stage2['meshes']}")
    want = [os.path.join(leg_dir, p) for p in (
        "datasets/nested_real/meta.json", "data/meshes/nested_real_silhouette.ply",
        "data/eval/nested_real_boot/eval_test.json", "data/eval/nested_real_s2/eval_test.json",
        "runs/eval_shell_nested_real_s2.json",
        *[f"runs/leg_{leg}.json" for leg in recs],
        *[f"data/model/{name}/{f}" for name in ("nested_real", "nested_real_boot",
                                                "nested_real_s2")
          for f in ("model.ckpt", "model_best.ckpt", "train_log.jsonl")],
        *[m for r in recs.values() for m in r["meshes"].values()])]
    missing = [p for p in want if not os.path.exists(p)]
    if missing:
        raise AssertionError(f"the real legs left no {missing}")
    # the masks: the front's, the boot's prior ones (the hull's), its own
    # and the eroded ones, all 56, and the boot's differing from the prior
    want_masks = {"real_front": ["render-mask", "mask-erosion"],
                  "real_boot": ["render-mask", "render-mask", "mask-erosion"]}
    for leg, cmds in want_masks.items():
        got = masks.get(leg, [])
        if [c for c, _, _ in got] != cmds or any(k != REAL_VIEWS for _, k, _ in got):
            raise AssertionError(f"{leg}'s masks: {got}")
    if masks["real_boot"][0][2] == masks["real_boot"][1][2]:
        raise AssertionError("real_boot's own masks are its prior masks")

    out = dict(seconds=[(r["leg"], c["command"], c["s"]) for r in recs.values()
                        for c in r["commands"]],
               chamfer={"real_front": front["chamfer"]["outer"]["chamfer"],
                        "real_boot": boot["chamfer"]["outer"]["chamfer"],
                        "real_stage2": stage2["chamfer"]["inner"]["chamfer"]},
               test={k: v for r in (boot, stage2) for k, v in r["eval_images"].items()},
               eval_shell=stage2["eval_shell"], traced=stage2["stage1"], launches=launches,
               launches_by_command=by_command, masks=masks, peak_gib=peaks)
    for leg, name in (("real_front", "nested_real"), ("real_boot", "nested_real_boot"),
                      ("real_stage2", "nested_real_s2")):
        st = recs[leg]["steps"][name]
        if st != {"from": 0, "to": n, "total_step": n, "paused": False}:
            raise AssertionError(f"{name} trained {st}")
        logs = read_log(os.path.join(leg_dir, "data/model", name, "train_log.jsonl"))
        val = {r["step"]: r for r in logs if r["prefix"] == "val"}
        last = [r for r in logs if r["prefix"] == "train" and r["step"] == n]
        if sorted(val) != list(range(every, n + 1, every)) or not all(
                math.isfinite(r["psnr"]) for r in val.values()):
            raise AssertionError(f"{name} validated {val}")
        train = [r for r in logs if r["prefix"] == "train"]
        if not (last and all(math.isfinite(r["loss_total"]) for r in train)
                and last[0]["step_ms"] > 0 and last[0]["rays_per_sec"] > 0):
            raise AssertionError(f"{name} logged {last}")
        last = last[0]
        out[name] = dict(step_ms=last["step_ms"], rays_per_s=last["rays_per_sec"],
                         rays=round(last["rays_per_sec"] * last["step_ms"] / 1e3),
                         loss_total=last["loss_total"],
                         peak_gib=((child["max_memory_allocated"] or 0) / 2 ** 30
                                   if leg == "real_stage2" else peaks[leg]),
                         val={s: (r["psnr"], r["ssim"]) for s, r in val.items()})
    for key in ("real_front", "real_boot"):
        if not math.isfinite(out["chamfer"][key]):
            raise AssertionError(f"{key}'s outer chamfer: {out['chamfer'][key]}")
    # 100 steps carve no inner surface inside the outer one: then the inner
    # mesh is empty and eval-geometry must say so
    from nunerf_tpu_torch.tracing.mesh_ops import load_ply

    inner_tris = len(load_ply(os.path.join(leg_dir, stage2["meshes"]["inner_post"]))[1])
    geo = stage2["chamfer"]["inner"]
    empty = inner_tris == 0 and geo["chamfer"] is None and \
        geo.get("error", "").startswith("empty surface: pred=0 ")
    if not (empty or (geo["chamfer"] is not None and math.isfinite(geo["chamfer"]))):
        raise AssertionError(f"real_stage2's inner chamfer: {geo}, {inner_tris} triangles")
    out["inner_triangles"] = inner_tris
    for name, ev in out["test"].items():
        if ev["views"] != REAL_TEST_VIEWS or not (
                math.isfinite(ev["mean_psnr"]) and math.isfinite(ev["mean_ssim"])):
            raise AssertionError(f"eval-images of {name}: {ev}")
    es = stage2["eval_shell"]
    if not all(math.isfinite(es[k]) for k in ("learned_ior", "learned_thickness")) or not (
            len(es["learned_kappa"]) == 3 and all(math.isfinite(x) for x in es["learned_kappa"])):
        raise AssertionError(f"eval_shell: {es}")

    def count(leg, command, counter):
        return sum(c.get(counter, 0) for lg, cmd, c in by_command if lg == leg and cmd == command)

    need = [("real_front", "train", "chain_fwd"), ("real_front", "train", "chain_bwd"),
            ("real_boot", "train", "chain_fwd"), ("real_boot", "train", "chain_bwd"),
            ("real_front", "extract-mesh-stage1", "chain_fwd"),
            ("real_boot", "extract-mesh-stage1", "chain_fwd"),
            ("real_stage2", "extract-mesh-stage2", "chain_fwd"),
            ("real_front", "postprocess-outer", "closest_hit"),
            ("real_boot", "postprocess-outer", "closest_hit"),
            ("real_front", "render-mask", "closest_hit"),
            ("real_boot", "render-mask", "closest_hit"),
            ("real_boot", "eval-images", "chain_fwd"),
            ("real_stage2", "eval-images", "closest_hit")]
    for leg, command, counter in need:
        if not count(leg, command, counter) > 0:
            raise AssertionError(f"{leg} {command} launched {counter} no time: {by_command}")
    if not child["launches"].get("closest_hit", 0) > 0:
        raise AssertionError(f"real_stage2's train child launched K3 no time: {child}")
    log(f"real legs (pipeline.run_leg at full width, {n} steps each): " + ", ".join(
        f"{leg}/{c} {v:.2f} s" for leg, c, v in out["seconds"]))
    for name in ("nested_real", "nested_real_boot", "nested_real_s2"):
        r = out[name]
        log(f"real legs: {name} step {n} {r['step_ms']:.1f} ms/step ({r['rays_per_s']:.0f} "
            f"rays/s, {r['rays']} rays a step), peak memory {r['peak_gib']:.2f} GiB; "
            f"validation PSNR/SSIM {r['val']}")
    log(f"real legs: chamfers {out['chamfer']} (not judged), inner mesh {inner_tris} "
        f"triangles; test {out['test']}; eval_shell {es}; stage 2 traced {stage2['stage1']}; "
        f"masks {masks}; launches {launches} (the child's {child['launches']})")
    out["s"] = time.perf_counter() - t_phase
    log(f"phase_pipeline_real: {out['s']:.1f} s")
    return launches, out


def k3_device_split(fn, reps=3):
    """Device time of K3's kernels over ``reps`` calls of ``fn``, by kernel
    (``torch.profiler``, as ``tools/prof_k3.py`` splits it): {name: ms a
    call}, empty where the profiler shows no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key.split("(")[0]: e.device_time_total / (1e3 * reps)
            for e in prof.key_averages() if "k3_" in e.key}


def visible_face_ties(of, verts, tris, faces, scenes, n_views=64, radius=2.0):
    """Where ``visible_faces`` of two scenes (K3, the plain culled descent)
    disagree on ``faces``: the (face, view) pairs whose decision differs,
    re-traced with ``visible_faces``' own rays (each ray's answer depends on
    that ray alone), and on those rays each query against the brute sweep
    of its own semantics: K3 against its plain version
    (``closest_hit_reference``, tolerant) and the culled descent against the
    brute sweep (``ray_mesh_intersect``), by triangle index; the largest
    relative ``t`` gap between the two scenes' hits, the pairs that are ties
    in ``t`` (within 1e-6), and for the others the nearer triangle, which one
    query took and the other did not: its largest distance to an edge
    (float64 barycentric margin), its smallest |det| and area, and how many
    of them K3 took.  Returns the counts and the first few
    pairs (face, K3's triangle and t, the descent's, the brute sweep's)."""
    from nunerf_tpu_torch.ops import ray_intersect as ri
    from nunerf_tpu_torch.tracing import intersect as ti

    rec = {"pairs": 0, "hit_differs": 0, "t_rel_max": 0.0, "t_ties": 0,
           "edge_margin_max": 0.0, "det_min": None, "area_min": None,
           "nearer_taken_by_k3": 0, "k3_off_its_plain": 0, "descent_off_brute": 0,
           "first": []}
    if len(faces) == 0:
        return rec
    centers = verts[tris[faces]].mean(1).astype(np.float32)
    k3, descent = scenes
    ro, rd, fs = [], [], []
    for v in (of._fibonacci_sphere(n_views) * radius).astype(np.float32):
        d = centers - v[None, :]
        d /= np.linalg.norm(d, axis=-1, keepdims=True) + 1e-12
        o = np.broadcast_to(v[None, :], d.shape).astype(np.float32)
        first = []
        for sc in scenes:
            with torch.no_grad():
                r = sc.dintersect(torch.as_tensor(o, device=sc.device),
                                  torch.as_tensor(d, device=sc.device))
            first.append((r["hit"] & (r["tri_idx"].long() == torch.as_tensor(
                faces, device=sc.device))).cpu().numpy())
        differ = first[0] != first[1]
        ro.append(o[differ])
        rd.append(d[differ])
        fs.append(faces[differ])
    ro, rd, fs = np.concatenate(ro), np.concatenate(rd), np.concatenate(fs)
    rec["pairs"] = len(fs)
    if not len(fs):
        return rec
    dev = k3.device
    o, d = torch.as_tensor(ro, device=dev), torch.as_tensor(rd, device=dev)
    got_k3, got_de = k3.intersect(o, d), descent.intersect(o, d)
    t_ref, i_ref, h_ref = ri.closest_hit_reference(o, d, k3.v0, k3.e1, k3.e2, tol=k3.kernel_tol)
    brute = ti.ray_mesh_intersect(o, d, descent.v0, descent.e1, descent.e2)
    rec["hit_differs"] = int((got_k3.hit != got_de.hit).sum())
    both = got_k3.hit & got_de.hit
    if bool(both.any()):
        gap = (got_k3.t - got_de.t).abs() / got_de.t.abs()
        rec["t_rel_max"] = float(gap[both].max())
    # a pair whose two hits lie within 1e-6 of each other is a tie in t;
    # otherwise the nearer triangle was taken by one query and rejected by
    # the other: its barycentric margin in float64 says how close to an edge
    tie = both & (gap <= 1e-6) if bool(both.any()) else both
    rec["t_ties"] = int(tie.sum())
    near = torch.where(got_k3.t < got_de.t, got_k3.tri_idx, got_de.tri_idx)[~tie].long()
    if len(near):
        o64, d64 = o[~tie].double(), d[~tie].double()
        tv = torch.as_tensor(verts, device=dev).double()[torch.as_tensor(
            tris, device=dev).long()[near]]
        e1, e2 = tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0]
        p = torch.linalg.cross(d64, e2)
        inv = 1.0 / (p * e1).sum(-1)
        tvec = o64 - tv[:, 0]
        u = (tvec * p).sum(-1) * inv
        v = (torch.linalg.cross(tvec, e1) * d64).sum(-1) * inv
        margin = torch.minimum(torch.minimum(u, v), 1.0 - u - v)
        rec["edge_margin_max"] = float(margin.abs().max())
        # a sliver seen edge-on has |det| near the 1e-9 below which both
        # queries skip a triangle
        rec["det_min"] = float((1.0 / inv).abs().min())
        rec["area_min"] = float(0.5 * torch.linalg.cross(e1, e2).norm(dim=-1).min())
        rec["nearer_taken_by_k3"] = int((got_k3.t < got_de.t)[~tie].sum())
    rec["k3_off_its_plain"] = int(((got_k3.tri_idx != i_ref) | (got_k3.hit != h_ref)).sum())
    rec["descent_off_brute"] = int(((got_de.tri_idx != brute.tri_idx)
                                    | (got_de.hit != brute.hit)).sum())
    rec["first"] = [(int(f), int(a), float(ta), int(b), float(tb), int(c), float(tc))
                    for f, a, ta, b, tb, c, tc in zip(
                        fs[:6], got_k3.tri_idx[:6], got_k3.t[:6], got_de.tri_idx[:6],
                        got_de.t[:6], brute.tri_idx[:6], brute.t[:6])]
    return rec


TOOL_ORBIT_VIEWS = 2      # render-orbit at --size 256: views cut from the default 12
TOOL_SYNTH_VIEWS = 8      # synth-scene --colmap: views cut from the pipeline's 56
# render-orbit's colours (in [0, 1]) against the CPU's f32 render, largest
# |diff|: through K1 and the bf16 heads a colour carries a few bf16
# roundings (2^-9 of a value each), so 1e-2; the card's plain f32 render
# differs by sums in another order, so 1e-5
ORBIT_TOL = 1e-2
ORBIT_F32_TOL = 1e-5


def phase_tools(dev, work, ckpt1, raw_mesh, outer_mesh):
    """The mask pipeline and the mesh tools through ``cli.main`` on the
    trainer's scene (100 train + 1 test views at 800x800) and
    ``phase_extract``'s meshes: ``render-mask`` on the raw 512^3 mesh (K3
    on every pixel; K3 at the chosen chunk timed beside both bounds, its
    device time by kernel;
    two views held to the plain closest hit), ``mask-erosion`` (read back
    by the database; the device erosion against its numpy twin),
    ``postprocess-outer`` on the remeshed mesh (64 views; ``visible_faces``
    with K3 against the plain closest hit), ``primary_visibility`` of the
    remeshed mesh from a train pose (against the plain closest hit; its
    ``verts`` gradient against the CPU's), ``render-orbit`` (K1; a band of
    one view against the CPU's f32 render) and ``sphere_trace`` of the same
    SDF (K1, card against CPU), ``synth-scene --colmap --shell`` with
    ``silhouette-prior``, ``hull-mesh`` and ``render-mask`` on its capture
    database, and ``relight``.  Every count is printed before any check
    raises.  Returns ({path: launches}, numbers)."""
    import os

    from nunerf_tpu_torch import cli
    from nunerf_tpu_torch.convert import load_jax_checkpoint, load_jax_params
    from nunerf_tpu_torch.data import image_io
    from nunerf_tpu_torch.data.database import parse_database_name
    from nunerf_tpu_torch.data.ray_store import construct_ray_batch
    from nunerf_tpu_torch.models.stage1 import PARAM_KEYS, ShapeRenderer
    from nunerf_tpu_torch.ops import fused_mlp as fm
    from nunerf_tpu_torch.ops import ray_intersect as ri
    from nunerf_tpu_torch.ops.sphere_tracing import sphere_trace
    from nunerf_tpu_torch.tools import outer_filter as of
    from nunerf_tpu_torch.tools import render_mask as rm
    from nunerf_tpu_torch.tracing.mesh_ops import load_ply
    from nunerf_tpu_torch.tracing.scene import Scene

    def run(argv):
        fm.reset_launches()
        ri.reset_launches()
        t0 = time.perf_counter()
        rec = cli.main(argv)
        torch.cuda.synchronize()
        return rec, dict(fm.launches, **ri.launches), time.perf_counter() - t0

    paths, out, faults = {}, {}, []
    ds = os.path.join(work, "ds")
    cfg_path = write_cfg("tools.yaml", dict(BENCH_CFG, database_name="nerf/sphere",
                                            dataset_dir=ds))

    # 1. render-mask on the raw mesh, every view at 800x800
    mask_dir, paths["render_mask"], secs = run(["render-mask", "--cfg", cfg_path,
                                                "--mesh_path", raw_mesh])
    db = parse_database_name("nerf/sphere", ds)
    ids = db.get_img_ids()
    hw = SCENE_HW * SCENE_HW
    want = len(ids) * -(-hw // rm.CHUNK)
    n_k3 = paths["render_mask"]["closest_hit"]
    if n_k3 != want:
        faults.append(f"render-mask launched K3 {n_k3} times, {want} expected")
    t0 = time.perf_counter()
    scene = Scene(raw_mesh, device=dev)
    build_s = time.perf_counter() - t0
    n_tris = len(scene.tris_np)
    o, d, _, _ = rm.view_rays(db, ids[0], True)
    o, d = (torch.as_tensor(a, device=dev) for a in (o, d))
    c = rm.CHUNK
    # the chunk through the middle of the view (the top rows miss the mesh)
    mid = slice(hw // 2 - c // 2, hw // 2 + c // 2)

    def one_view():
        for i in range(0, hw, c):
            scene.intersect(o[i:i + c], d[i:i + c])

    ms_chunk = cuda_ms(lambda: scene.intersect(o[mid], d[mid]), 5)
    ms_top = cuda_ms(lambda: scene.intersect(o[:c], d[:c]), 5)
    ms_view = cuda_ms(one_view, 3)
    ms_whole = cuda_ms(lambda: scene.intersect(o, d), 3)
    stats = torch.zeros(2, dtype=torch.int64, device=dev)
    ri.closest_hit_cuda(o[mid], d[mid], scene.kernel_index, stats=stats, tol=scene.kernel_tol)
    bound, by = k3_bound(ri, scene.kernel_index, c, stats)
    bound2, by2, tile_tests = k3_bound_two_level(ri, scene.kernel_index, o[mid], d[mid],
                                                 stats)
    split = k3_device_split(one_view)
    n_tiles = scene.kernel_index.box.shape[0]
    n_groups = scene.kernel_index.gbox.shape[0]
    rec = dict(s=secs, views=len(ids), rays=len(ids) * hw, triangles=n_tris, tiles=n_tiles,
               groups=n_groups, launches=n_k3, chunk=c, ms_chunk=ms_chunk, ms_chunk_top=ms_top,
               ms_view=ms_view, ms_view_one_call=ms_whole,
               rays_per_s=len(ids) * hw / secs, k3_rays_per_s=c / ms_chunk * 1e3,
               bound_ms_chunk=bound, bound_by=by, bound_ms_chunk_two_level=bound2,
               bound_by_two_level=by2, device_ms_by_kernel=split,
               box_tests_chunk=c * n_tiles, box_tests_chunk_two_level=c * n_groups + tile_tests,
               pairs_passed_chunk=int(stats[0]), tri_pairs_chunk=int(stats[1]),
               scene_build_s=build_s)
    log(f"render-mask on the raw mesh ({n_tris} triangles, {n_tiles} K3 tiles in "
        f"{n_groups} groups): "
        f"{len(ids)} views of {SCENE_HW}x{SCENE_HW} in {secs:.2f} s "
        f"({rec['rays_per_s']:.0f} rays/s end to end); {n_k3} K3 launches of up to {c} "
        f"rays; K3 {ms_chunk:.3f} ms for the view's middle {c} rays "
        f"({rec['k3_rays_per_s']:.0f} rays/s; bound of the flat work {bound:.4f} ms, {by}; "
        f"of the two-level work {bound2:.4f} ms, {by2}), {ms_top:.3f} ms "
        f"for its top {c} (all miss); a view {ms_view:.3f} ms in {-(-hw // c)} launches, "
        f"{ms_whole:.3f} ms in one; the middle chunk's box tests {c * n_tiles} flat, "
        f"{c * n_groups + tile_tests} over the groups ({tile_tests / c:.1f} tile tests a "
        f"ray), {int(stats[0]) / c:.1f} passed a ray, {int(stats[1]) / c:.0f} triangles "
        f"swept a ray; device ms a view by kernel {split}; the tool's "
        f"scene builds in {build_s:.2f} s")

    # two views against the plain closest hit (the culled descent at this size)
    plain = Scene(raw_mesh, device=dev, use_kernel=False)
    diffs = {}
    t0 = time.perf_counter()
    for i in (ids[0], ids[len(ids) // 2]):
        vo, vd, h, w = rm.view_rays(db, i, True)
        ref = rm.hit_mask(plain, vo, vd, h, w, chunk=8192)
        got = image_io.imread(rm.mask_path(db.root, "mask", db.get_image_name(i)))
        diffs[i] = int((got != ref).sum())
        if not (ref.any() and not ref.all()):
            faults.append(f"view {i}: the plain mask is {'empty' if not ref.any() else 'full'}")
    rec["plain_hit_differs"] = diffs
    rec["plain_s"] = time.perf_counter() - t0
    log(f"render-mask against the plain closest hit on views {list(diffs)}: pixels whose "
        f"hit differs {diffs} (the plain masks in {rec['plain_s']:.1f} s)")
    if any(diffs.values()):
        faults.append(f"render-mask's K3 masks differ from the plain closest hit: {diffs}")
    out["render_mask"] = rec
    del scene, plain, o, d
    torch.cuda.empty_cache()

    # 2. mask-erosion, read back by the database
    _, _, secs = run(["mask-erosion", "--cfg", cfg_path])
    db = parse_database_name("nerf/sphere", ds)
    bad = []
    for i in ids[:: max(1, len(ids) // 5)]:
        name = db.get_image_name(i)
        e = image_io.imread(rm.mask_path(db.root, "mask_erosion", name))
        if not np.array_equal(db.get_mask(i), e.astype(np.float32) / 255.0):
            bad.append(i)
    m = image_io.imread(rm.mask_path(db.root, "mask", db.get_image_name(ids[0])))
    card, twin = rm.erode(m, 15, dev), rm.erode_reference(m, 15)
    twin_differs = int((card != twin).sum())
    out["mask_erosion"] = dict(s=secs, db_mismatch=bad, erode_twin_differs=twin_differs)
    log(f"mask-erosion: {len(ids)} masks in {secs:.2f} s; the database reads back the "
        f"eroded PNGs (mismatches {bad}); the device erosion against its numpy twin: "
        f"{twin_differs} pixels differ")
    if bad or twin_differs:
        faults.append(f"mask-erosion: database mismatches {bad}, twin differs {twin_differs}")

    # 3. postprocess-outer on the remeshed mesh, the defaults (64 views, radius 2)
    (post, stats), paths["postprocess_outer"], secs = run(
        ["postprocess-outer", "--input", outer_mesh, "--output", "outer_filtered.ply"])
    verts, tris = load_ply(outer_mesh)
    t0 = time.perf_counter()
    keep_k3 = of.visible_faces(verts, tris, device=dev)
    k3_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    keep_plain = of.visible_faces(verts, tris, scene=Scene((verts, tris), device=dev,
                                                           use_kernel=False))
    plain_s = time.perf_counter() - t0
    face_diff = int((keep_k3 != keep_plain).sum())
    ties = visible_face_ties(of, verts, tris, np.flatnonzero(keep_k3 != keep_plain),
                             [Scene((verts, tris), device=dev),
                              Scene((verts, tris), device=dev, use_kernel=False)])
    out["postprocess_outer"] = dict(s=secs, stats=stats, launches=paths["postprocess_outer"],
                                    visible_k3=int(keep_k3.sum()),
                                    visible_plain=int(keep_plain.sum()),
                                    visible_faces_differ=face_diff, differing=ties,
                                    visible_k3_s=k3_s, visible_plain_s=plain_s)
    log(f"postprocess-outer on the remeshed mesh ({len(tris)} faces, 64 views): {secs:.2f} s, "
        f"K3 launches {paths['postprocess_outer']['closest_hit']}, stats {stats}; "
        f"visible_faces with K3 {int(keep_k3.sum())} ({k3_s:.2f} s) and with the plain "
        f"closest hit {int(keep_plain.sum())} ({plain_s:.2f} s): {face_diff} faces differ; "
        f"on them {ties}")
    if ties["k3_off_its_plain"]:
        faults.append(f"visible_faces: K3 is off its plain version on {ties}")
    if paths["postprocess_outer"]["closest_hit"] != 64 * -(-stats["after_floaters"] // 65536):
        faults.append(f"postprocess-outer launched {paths['postprocess_outer']}")

    # 4. primary_visibility of the remeshed mesh from a train pose at 800x800
    c2w = db.poses[int(ids[0])]
    pose, K, origin = cli.opencv_w2c(c2w), db.get_K(ids[0]), np.float32(c2w[:3, 3])
    k3_scene = Scene((verts, tris), device=dev)
    w = torch.as_tensor(np.random.RandomState(4).randn(len(k3_scene.topology.edges))
                        .astype(np.float32))

    def visibility(sc):
        v = sc.verts.clone().requires_grad_(True)
        res = sc.primary_visibility(pose, K, origin, (SCENE_HW, SCENE_HW), verts=v)
        torch.sum(res["value"] * w.to(v.device)).backward()
        return {k: x.detach().cpu() for k, x in res.items()}, v.grad.cpu()

    fm.reset_launches()
    ri.reset_launches()
    t0 = time.perf_counter()
    res_k3, g_k3 = visibility(k3_scene)
    torch.cuda.synchronize()
    paths["primary_visibility"] = dict(fm.launches, **ri.launches)
    pv_s = time.perf_counter() - t0
    res_plain, g_plain = visibility(Scene((verts, tris), device=dev, use_kernel=False))
    t0 = time.perf_counter()
    res_cpu, g_cpu = visibility(Scene((verts, tris), device="cpu"))
    cpu_s = time.perf_counter() - t0
    same = {k: bool(torch.equal(res_k3[k], res_plain[k])) for k in ("index", "valid", "value")}
    g_err = float((g_k3 - g_cpu).abs().max())
    g_scale = float(g_cpu.abs().max())
    out["primary_visibility"] = dict(
        s=pv_s, edges=len(w), valid=int(res_k3["valid"].sum()), same_as_plain=same,
        grad_max_abs_err=g_err, grad_scale=g_scale, grad_equal_plain=bool(torch.equal(g_k3,
                                                                                      g_plain)),
        cpu_s=cpu_s, launches=paths["primary_visibility"])
    log(f"primary_visibility of the remeshed mesh ({len(w)} edges) from train view {ids[0]} "
        f"at {SCENE_HW}x{SCENE_HW}: {pv_s:.2f} s with its gradient, "
        f"{paths['primary_visibility']['closest_hit']} K3 launches, "
        f"{int(res_k3['valid'].sum())} valid edge samples; index/valid/value equal to the "
        f"plain closest hit's {same}; d sum(value w)/d verts on the card against the CPU "
        f"({cpu_s:.1f} s): max |diff| {g_err:.3e} of a largest {g_scale:.3e} (tol 1e-5 of it)")
    if not all(same.values()) or paths["primary_visibility"]["closest_hit"] != 2:
        faults.append(f"primary_visibility: {same}, launches {paths['primary_visibility']}")
    if not (g_err <= 1e-5 * g_scale and g_scale > 0):
        faults.append(f"primary_visibility gradient: {g_err:.3e} of {g_scale:.3e}")
    del k3_scene
    torch.cuda.empty_cache()

    # 5. render-orbit at --size 256 (K1), a band of view 0 against the CPU's f32 render
    size = 256
    imgs, paths["render_orbit"], secs = run(
        ["render-orbit", "--cfg", cfg_path, "--ckpt", ckpt1, "--output", "orbit",
         "--n-views", str(TOOL_ORBIT_VIEWS), "--size", str(size)])
    step, params, _ = load_jax_checkpoint(ckpt1)
    f32_cfg = dict(BENCH_CFG, mixed_precision=False, sdf_mixed_precision=False,
                   fused_sdf_value=False)
    focal = 0.5 * size / np.tan(0.5 * 0.65)
    K = np.array([[focal, 0, size / 2], [0, focal, size / 2], [0, 0, 1]], np.float32)
    batch, _, _ = construct_ray_batch({"imgs": np.zeros((1, size, size, 3), np.float32),
                                       "Ks": K[None],
                                       "poses": cli.orbit_pose(0, TOOL_ORBIT_VIEWS, 2.2,
                                                               0.4)[None]})
    band = slice(size * size // 2, size * size // 2 + 1024)  # rows 128-131: one chunk
    want_band = imgs[0].reshape(-1, 3)[band]

    def render_band(device):
        r = ShapeRenderer(f32_cfg, device=device)
        load_jax_params(r, params, PARAM_KEYS)
        cur = {k: torch.as_tensor(np.ascontiguousarray(batch[k][band]), device=device)
               for k in ("rays_o", "rays_d", "near", "far", "human_poses")}
        with torch.no_grad():
            rgb = r.render(cur["rays_o"], cur["rays_d"], cur["near"], cur["far"],
                           cur["human_poses"], step, cos_anneal_ratio=1.0,
                           perturb_overwrite=0.0, is_train=False, with_inter=False)["ray_rgb"]
        return rgb.float().cpu().numpy(), r

    t0 = time.perf_counter()
    cpu_band, cpu_r = render_band("cpu")
    cpu_band_s = time.perf_counter() - t0
    card_band, _ = render_band(dev)
    k1_err = float(np.abs(want_band - cpu_band).max())
    f32_err = float(np.abs(card_band - cpu_band).max())
    out["render_orbit"] = dict(
        s=secs, s_per_view=secs / TOOL_ORBIT_VIEWS, views=TOOL_ORBIT_VIEWS, size=size,
        launches=paths["render_orbit"],
        k1_per_view=paths["render_orbit"]["chain_fwd"] / TOOL_ORBIT_VIEWS,
        k1_vs_cpu_f32_max_abs=k1_err, k1_vs_cpu_f32_mean_abs=float(
            np.abs(want_band - cpu_band).mean()), card_f32_vs_cpu_f32_max_abs=f32_err,
        cpu_band_s=cpu_band_s, finite=bool(np.isfinite(imgs).all()))
    log(f"render-orbit: {TOOL_ORBIT_VIEWS} views of {size}x{size} in {secs:.2f} s "
        f"({secs / TOOL_ORBIT_VIEWS:.2f} s a view), {paths['render_orbit']['chain_fwd']} K1 "
        f"launches; rows 128-131 of view 0 against the CPU's plain f32 render "
        f"({cpu_band_s:.1f} s): K1 (bf16) max |diff| {k1_err:.2e} (tol {ORBIT_TOL}: bf16 "
        f"heads and positions), mean {out['render_orbit']['k1_vs_cpu_f32_mean_abs']:.5f}; "
        f"the card's plain f32 render max |diff| {f32_err:.2e} (tol {ORBIT_F32_TOL})")
    if not (paths["render_orbit"]["chain_fwd"] > 0 and np.isfinite(imgs).all()
            and k1_err <= ORBIT_TOL and f32_err <= ORBIT_F32_TOL):
        faults.append(f"render-orbit: {out['render_orbit']}")

    # sphere_trace of the same SDF: K1 at 256x256, and card against CPU at 64x64
    card_r = ShapeRenderer(BENCH_CFG, device=dev)
    load_jax_params(card_r, params, PARAM_KEYS)
    o_all = torch.as_tensor(batch["rays_o"], device=dev)
    d_all = torch.as_tensor(batch["rays_d"], device=dev)
    fm.reset_launches()
    t0 = time.perf_counter()
    st = sphere_trace(card_r.sdf, o_all, d_all)
    torch.cuda.synchronize()
    paths["sphere_trace"] = dict(fm.launches)
    st_s = time.perf_counter() - t0
    small = construct_ray_batch({"imgs": np.zeros((1, 64, 64, 3), np.float32),
                                 "Ks": (np.diag([0.25, 0.25, 1.0]) @ K)[None].astype(np.float32),
                                 "poses": cli.orbit_pose(0, TOOL_ORBIT_VIEWS, 2.2, 0.4)[None]})[0]
    so, sd = small["rays_o"], small["rays_d"]
    runs = {}
    for what, fn, device in (("k1", card_r.sdf, dev), ("card_f32", None, dev),
                             ("cpu_f32", cpu_r.sdf, "cpu")):
        if fn is None:
            r = ShapeRenderer(f32_cfg, device=dev)
            load_jax_params(r, params, PARAM_KEYS)
            fn = r.sdf
        res = sphere_trace(fn, torch.as_tensor(so, device=device),
                           torch.as_tensor(sd, device=device))
        runs[what] = (res.hit.cpu(), res.depth.cpu(), res.iterations)
    hit_c, depth_c, it_c = runs["cpu_f32"]

    def versus(what):
        hit, depth, it = runs[what]
        both = hit & hit_c
        return dict(iterations=it, hits=int(hit.sum()), hit_differs=int((hit != hit_c).sum()),
                    depth_max_abs=float((depth - depth_c)[both].abs().max()) if both.any()
                    else None)

    out["sphere_trace"] = dict(s=st_s, iterations=st.iterations, hits=int(st.hit.sum()),
                               rays=len(o_all), launches=paths["sphere_trace"],
                               cpu_64=dict(iterations=it_c, hits=int(hit_c.sum())),
                               k1_64=versus("k1"), card_f32_64=versus("card_f32"))
    log(f"sphere_trace of the stage-1 SDF (K1) over view 0 at {size}x{size}: {st.iterations} "
        f"iterations, {int(st.hit.sum())} hits of {len(o_all)} in {st_s:.2f} s, "
        f"{paths['sphere_trace']['chain_fwd']} K1 launches; at 64x64 the CPU (f32) "
        f"{it_c} iterations and {int(hit_c.sum())} hits, against it K1 "
        f"{out['sphere_trace']['k1_64']} and the card's plain f32 "
        f"{out['sphere_trace']['card_f32_64']}")
    if paths["sphere_trace"]["chain_fwd"] != st.iterations + 1 or int(hit_c.sum()) == 0:
        faults.append(f"sphere_trace: {out['sphere_trace']}")
    f32 = out["sphere_trace"]["card_f32_64"]
    if f32["hit_differs"] > 0.01 * len(so) or not (f32["depth_max_abs"] or 0) <= 1e-4:
        faults.append(f"sphere_trace: the card's f32 march is off the CPU's: {f32}")
    del card_r, cpu_r
    torch.cuda.empty_cache()

    # 6. synth-scene --colmap --shell, the silhouette prior, its hull, its masks; relight
    root, _, secs = run(["synth-scene", "--output", os.path.join(ds, "nested_real"),
                         "--colmap", "--shell", "--n-train", str(TOOL_SYNTH_VIEWS)])
    out["synth_scene"] = dict(s=secs, views=TOOL_SYNTH_VIEWS)
    real_cfg = write_cfg("real.yaml", dict(BENCH_CFG, name="nested_real",
                                           database_name="custom/nested_real/128",
                                           dataset_dir=ds, is_nerf=False))
    (prior, nv, nf), _, prior_s = run(["silhouette-prior", "--cfg", real_cfg])
    (hull, hv, hf), _, hull_s = run(["hull-mesh", "--input", prior])
    mdir, paths["render_mask_prior"], rm_s = run(["render-mask", "--cfg", real_cfg,
                                                  "--mesh_path", prior])
    cap = parse_database_name("custom/nested_real/128/rawmask", ds)
    cover = [float(cap.get_mask(i).mean()) for i in cap.get_img_ids()]
    out["capture"] = dict(synth_s=secs, prior_s=prior_s, prior_verts=nv, prior_faces=nf,
                          hull_s=hull_s, hull_faces=hf, render_mask_s=rm_s,
                          launches=paths["render_mask_prior"], coverage=cover)
    log(f"synth-scene --colmap --shell: {TOOL_SYNTH_VIEWS} views of 200x264 in {secs:.2f} s; "
        f"silhouette-prior {nv} verts / {nf} faces in {prior_s:.2f} s; hull-mesh {hv} / {hf} "
        f"in {hull_s:.2f} s; render-mask on the prior through the capture database in "
        f"{rm_s:.2f} s, {paths['render_mask_prior']['closest_hit']} K3 launches, coverage "
        f"{min(cover):.3f}-{max(cover):.3f}")
    if not (paths["render_mask_prior"]["closest_hit"] > 0 and all(0 < x < 1 for x in cover)
            and (hv, hf) == (nv, nf)):
        faults.append(f"the capture tools: {out['capture']}")
    mats, _, secs = run(["relight", "--cfg", cfg_path, "--ckpt", ckpt1,
                                        "--mesh", outer_mesh, "--output", "materials"])
    shapes = {k: list(v.shape) for k, v in mats.items()}
    out["relight"] = dict(s=secs, shapes=shapes)
    log(f"relight of the remeshed mesh's {len(verts)} vertices: {secs:.2f} s, {shapes}")
    if shapes != {"metallic": [len(verts), 1], "roughness": [len(verts), 1],
                  "albedo": [len(verts), 3]} or not all(
            np.isfinite(v).all() and (v >= 0).all() and (v <= 1).all() for v in mats.values()):
        faults.append(f"relight: {shapes}")
    if faults:
        raise AssertionError("the tools phase: " + "; ".join(faults))
    return paths, out


# ---------------------------------------------------------------------------
# phase_parallel: data parallelism (nunerf_tpu_torch/parallel/)

PARALLEL_STEPS = 3
PARALLEL_LR = 5e-4
PARALLEL_LIMIT = 300.0   # seconds the two spawned ranks may take
# the f32 twins of BENCH_CFG and STAGE2_CFG: no bf16 anywhere in the step
PARALLEL_F32_S1 = dict(BENCH_CFG, mixed_precision=False, sdf_mixed_precision=False)
PARALLEL_F32_S2 = dict(STAGE2_CFG, stage1_cfg=PARALLEL_F32_S1, mixed_precision=False,
                       sdf_mixed_precision=False)
# the two-rank runs: name -> (stage, stage-1 config, stage-2 config)
PARALLEL_RUNS = {"s1": ("s1", BENCH_CFG, STAGE2_CFG), "s2": ("s2", BENCH_CFG, STAGE2_CFG),
                 "s1_f32": ("s1", PARALLEL_F32_S1, PARALLEL_F32_S2),
                 "s2_f32": ("s2", PARALLEL_F32_S1, PARALLEL_F32_S2)}
# the parameters after the steps, of each tensor's update norm, by stage.
# Adam divides each gradient element by its own running magnitude, so
# elements whose gradient is rounding noise (in f32 too) step either way: on
# an H100 80GB HBM3 (700 W) the two-rank runs read up to 0.134 in stage 1
# (0.054 in f32) and 0.031 in stage 2, the naive control 0.32 and 0.078
PARALLEL_NORM_TOL = {"s1": 0.2, "s2": 0.05}


def parallel_run(name, dev, mesh, scene, naive=False):
    """``parallel_steps`` of the run ``name`` of ``PARALLEL_RUNS``."""
    kind, s1_cfg, s2_cfg = PARALLEL_RUNS[name]
    return parallel_steps(kind, dev, mesh, scene, PARALLEL_STEPS, s1_cfg, s2_cfg, naive)


def parallel_steps(kind, dev, mesh, scene, n_steps=PARALLEL_STEPS, s1_cfg=None,
                   s2_cfg=None, naive=False):
    """``n_steps`` Adam steps from seeded weights on this rank's rows of the
    full batch under ``mesh`` (``None``: one process, the whole batch):
    stage 1 (``kind`` "s1") at step 25000, or the zero-thickness stage 2
    ("s2") at step 1000 through ``scene``.  Launch counts are set to 0 just
    before the steps and read just after.  The configurations default to
    ``BENCH_CFG`` and ``STAGE2_CFG``.  ``naive``: the control of a naive
    port, each rank's own loss on its rows (the renderer keeps its
    one-process mesh) with the gradients averaged over ``mesh``."""
    from nunerf_tpu_torch.models.stage1 import ShapeRenderer
    from nunerf_tpu_torch.models.stage2 import Stage2Renderer
    from nunerf_tpu_torch.ops import fused_mlp as fm
    from nunerf_tpu_torch.ops import ray_intersect as ri
    from nunerf_tpu_torch.parallel.mesh import shard_batch
    from nunerf_tpu_torch.train.trainer import TrainStep

    s1_cfg = BENCH_CFG if s1_cfg is None else s1_cfg
    s2_cfg = STAGE2_CFG if s2_cfg is None else s2_cfg

    if kind == "s1":
        renderer, step = ShapeRenderer(s1_cfg, device=dev, seed=0), 25000
        batch = batch_for(s1_cfg, dev)
    else:
        stage1 = ShapeRenderer(s2_cfg["stage1_cfg"], device=dev, seed=0)
        renderer, step = Stage2Renderer(s2_cfg, scene, stage1, device=dev, seed=1), 1000
        batch = stage2_batch(s2_cfg["train_ray_num"], dev)
    frozen = [p.detach().clone() for p in renderer.parameters() if not p.requires_grad]
    if mesh is not None and not naive:  # else the renderer's one-process mesh
        renderer.mesh = mesh
    mesh = renderer.mesh if mesh is None else mesh
    batch = shard_batch(batch, mesh)
    train = TrainStep(renderer, PARALLEL_LR)
    init = {n: p.detach().cpu().clone() for n, p in renderer.named_parameters()
            if p.requires_grad}
    reduce_ms, collectives = [], [0]
    if mesh.distributed:
        reduce = train.reduce_grads
        count = mesh.all_reduce_

        def timed_reduce(m):
            # events on the stream: no host synchronisation inside the step
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            reduce(m)
            e1.record()
            reduce_ms.append((e0, e1))

        def counted(x):
            collectives[0] += 1
            return count(x)

        train.reduce_grads, mesh.all_reduce_ = timed_reduce, counted
    torch.cuda.reset_peak_memory_stats()
    ri.reset_launches()
    fm.reset_launches()
    terms, times, grads0 = [], [], None
    try:
        for i in range(n_steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t = train.compute_grads(batch, step)
            if naive:
                train.reduce_grads(mesh)
            if i == 0:  # the first step's gradients: the same weights everywhere
                grads0 = {n: p.grad.detach().cpu().clone()
                          for n, p in renderer.named_parameters() if p.requires_grad}
            train.apply()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
            terms.append({k: float(torch.as_tensor(v).detach()) for k, v in t.items()})
    finally:
        if mesh.distributed:
            del mesh.all_reduce_
    reduce_ms = [e0.elapsed_time(e1) for e0, e1 in reduce_ms]
    launches = dict(ri.launches, **fm.launches)
    still = [p for p in renderer.parameters() if not p.requires_grad]
    if not all(torch.equal(a, b.detach()) for a, b in zip(frozen, still)):
        raise AssertionError(f"{kind}: a frozen parameter changed")
    return dict(terms=terms, step_ms=times, reduce_ms=reduce_ms,
                grad_bytes=4 * sum(p.numel() for p in train.params),
                collectives_per_step=collectives[0] / n_steps,
                launches=launches, peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                rays=int(batch["rays_o"].shape[0]), init=init, grads0=grads0,
                params={n: p.detach().cpu().clone() for n, p in renderer.named_parameters()
                        if p.requires_grad})


def parallel_shares(got, ref, grad_tol):
    """How far ``got``'s steps are from ``ref``'s: the loss terms at every
    step as shares of the card's small-check tolerances (loss_total 1e-2
    relative, each term 5e-2 of itself plus 1e-3 of loss_total; a value that
    is not finite counts as infinitely far), the first step's gradients (the
    same weights on both sides) as shares of ``grad_tol`` of each tensor's
    largest magnitude, and each parameter tensor after the steps as a share
    of its update norm; the worst of each, with its name."""
    equal = (got["terms"] == ref["terms"]
             and all(torch.equal(got["params"][n], p) for n, p in ref["params"].items()))
    grads, terms, params = [], [], []
    for n, g in ref["grads0"].items():
        scale = float(g.abs().max())
        err = float((got["grads0"][n] - g).abs().max())
        grads.append((err / (grad_tol * scale) if scale > 0 else float(err > 0), n))
    for i, (g, r) in enumerate(zip(got["terms"], ref["terms"])):
        total = abs(r["loss_total"])
        for k, v in r.items():
            tol = 1e-2 * abs(v) if k == "loss_total" else 5e-2 * abs(v) + 1e-3 * total
            err = abs(g[k] - v) if math.isfinite(g[k]) else math.inf
            terms.append((err / tol if tol > 0 else (math.inf if err > 0 else 0.0),
                          f"step {i} {k}"))
    for n, p in ref["params"].items():
        d = got["params"][n] - p
        upd = float(torch.linalg.norm(p - ref["init"][n]))
        params.append((float(torch.linalg.norm(d)) / upd if upd > 0
                       else float(d.abs().max() > 0), n))
    (gs, gn), (ts, tn), (ps, pn) = (max(x, key=lambda e: e[0], default=(0.0, None))
                                    for x in (grads, terms, params))
    return dict(bit_equal=equal, worst_grad_share=gs, worst_grad=gn, worst_term_share=ts,
                worst_term=tn, worst_param_norm_ratio=ps, worst_param=pn)


def parallel_agreement(what, got, ref, grad_tol, norm_tol=None):
    """``parallel_shares`` of ``got`` against ``ref``, held: the terms and
    the first step's gradients within their tolerances and, where
    ``norm_tol`` is given, every parameter tensor within ``norm_tol`` of its
    update norm (reported in any case).  Returns the shares."""
    sh = parallel_shares(got, ref, grad_tol)
    for key in ("term", "grad"):
        if not sh[f"worst_{key}_share"] <= 1.0:
            raise AssertionError(f"{what}: {key} {sh[f'worst_{key}']} off by "
                                 f"{sh[f'worst_{key}_share']:.3g} of its tolerance")
    if norm_tol is not None and not sh["worst_param_norm_ratio"] <= norm_tol:
        raise AssertionError(f"{what}: parameter {sh['worst_param']} off by "
                             f"{sh['worst_param_norm_ratio']:.3g} of its update norm "
                             f"(tol {norm_tol})")
    log(f"{what}: {'bit-equal' if sh['bit_equal'] else 'not bit-equal'}; terms at "
        f"{sh['worst_term_share']:.3g} of their tolerance, first-step gradients at "
        f"{sh['worst_grad_share']:.3g} of theirs ({grad_tol}; {sh['worst_grad']}), "
        f"parameters {sh['worst_param_norm_ratio']:.4g} of an update norm at most "
        f"({sh['worst_param']}; tol {norm_tol if norm_tol is not None else 'none'})")
    return dict(sh, param_norm_tol=norm_tol)


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _parallel_rank(rank, world, init_method, out_dir, dev, verts, tris):
    """One of the ranks that share the card over gloo (spawned)."""
    import os
    import pickle
    import traceback

    try:
        import torch.distributed as dist

        from nunerf_tpu_torch.parallel.mesh import make_mesh
        from nunerf_tpu_torch.parallel.multihost import init_multihost
        from nunerf_tpu_torch.tracing.scene import Scene

        t0 = time.perf_counter()
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index or 0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        init_multihost(init_method, world, rank, backend="gloo")
        try:
            mesh = make_mesh(world, device=dev)
            scene = Scene((verts, tris), device=dev)
            res = {"ready_s": time.perf_counter() - t0}
            for name in PARALLEL_RUNS:
                res[name] = parallel_run(name, dev, mesh, scene)
                res[f"{name}_naive"] = parallel_run(name, dev, mesh, scene, naive=True)
        finally:
            dist.destroy_process_group()
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        sys.exit(1)


def spawn_ranks(world, dev, verts, tris, limit=PARALLEL_LIMIT):
    """Run ``_parallel_rank`` in ``world`` spawned processes joined over gloo
    on this card; each rank's result.  A rank that fails or outlives
    ``limit`` fails the phase, and every rank is stopped."""
    import multiprocessing as mp
    import os
    import pickle
    import shutil
    import tempfile

    out_dir = tempfile.mkdtemp(prefix="nunerf_ranks_")
    init_method = f"file://{os.path.join(out_dir, 'rendezvous')}"
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_parallel_rank,
                         args=(r, world, init_method, out_dir, dev, verts, tris))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = time.perf_counter() + limit
        for p in procs:
            p.join(max(0.0, deadline - time.perf_counter()))
        errors = []
        for r, p in enumerate(procs):
            err = os.path.join(out_dir, f"rank{r}.err")
            if p.is_alive():
                errors.append(f"rank {r} still running after {limit:.0f} s")
            elif os.path.exists(err):
                errors.append(f"rank {r}:\n" + open(err).read())
            elif p.exitcode != 0:
                errors.append(f"rank {r} exited with {p.exitcode}")
        if errors:
            raise AssertionError("phase_parallel: " + "\n".join(errors))
        out = []
        for r in range(world):
            with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        shutil.rmtree(out_dir, ignore_errors=True)


def phase_parallel(scene, verts, tris, dev):
    """Data parallelism: the full-width stage-1 step at 25000 and stage-2
    step at 1000, ``PARALLEL_STEPS`` each, (a) in one process; (b) through
    the mesh at world size 1 on ``nccl`` (every collective runs), bit-equal
    to (a); (c) in two ranks spawned on this one card over ``gloo``
    (``nccl`` refuses two ranks on one device), 512 of the 1024 rays each,
    the ranks bit-equal to each other, and held to (a) by
    ``parallel_agreement``: the loss terms, the first step's gradients at
    the backward tolerance of the route (bf16, and the f32 twins at 1e-4)
    and the parameters after the steps (``PARALLEL_NORM_TOL``).  A naive
    control on the same ranks (each rank's own loss, the gradients averaged)
    must fail one of those gates.  K1 and K3 must launch on each rank (paths
    ``parallel_s1``, ``parallel_s2`` and their ``_f32`` twins).  Two ranks on one card
    measure correctness and the overhead of the collectives, not scaling."""
    import os

    import torch.distributed as dist

    from nunerf_tpu_torch.parallel.mesh import make_mesh

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    t_phase = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(1)
        if not mesh.distributed:
            raise AssertionError(f"world size 1: mesh {mesh}")
        # one process, mesh, mesh, one process: the overhead read in turns
        ref, ws1, ws1b, ref2 = ({k: parallel_run(k, dev, m, scene) for k in ("s1", "s2")}
                                for m in (None, mesh, mesh, None))
    finally:
        dist.destroy_process_group()
    res = {"ws1_nccl": {}, "gloo_2_ranks": {}}
    for k in ("s1", "s2"):
        agree = parallel_agreement(f"parallel {k}: world size 1 on nccl against one process",
                                   ws1[k], ref[k], CHAIN_TOL[("bwd", "bfloat16")])
        if not agree["bit_equal"]:
            raise AssertionError(f"parallel {k}: world size 1 on nccl is not bit-equal "
                                 "to one process")
        r = ws1[k]
        res["ws1_nccl"][k] = dict(
            agree, step_ms=[r["step_ms"], ws1b[k]["step_ms"]],
            plain_step_ms=[ref[k]["step_ms"], ref2[k]["step_ms"]],
            allreduce_ms=r["reduce_ms"] + ws1b[k]["reduce_ms"],
            allreduce_bytes=r["grad_bytes"],
            collectives_per_step=r["collectives_per_step"], peak_gib=r["peak_gib"],
            plain_peak_gib=ref[k]["peak_gib"])
        log(f"parallel {k} world size 1 on nccl: step ms {r['step_ms']}, "
            f"{ws1b[k]['step_ms']} (one process {ref[k]['step_ms']}, {ref2[k]['step_ms']}), "
            f"gradient all-reduce {res['ws1_nccl'][k]['allreduce_ms']} ms of "
            f"{r['grad_bytes']} bytes, {r['collectives_per_step']:.0f} all-reduces a step, "
            f"peak {r['peak_gib']:.2f} GiB (one process {ref[k]['peak_gib']:.2f})")
    for k in ("s1_f32", "s2_f32"):
        ref[k] = parallel_run(k, dev, None, scene)

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn_ranks(2, dev, verts, tris)
    spawn_s = time.perf_counter() - t0
    paths = {}
    for k in PARALLEL_RUNS:
        stage = PARALLEL_RUNS[k][0]
        counter = "chain_fwd" if stage == "s1" else "closest_hit"
        path = f"parallel_{k}"
        got = [r[k] for r in ranks]
        for name, p in got[0]["params"].items():
            if not torch.equal(p, got[1]["params"][name]):
                raise AssertionError(f"parallel {k}: ranks differ in {name}")
        if got[0]["terms"] != got[1]["terms"]:
            raise AssertionError(f"parallel {k}: ranks differ in their loss terms")
        if [g["rays"] for g in got] != [ref[k]["rays"] // 2] * 2:
            raise AssertionError(f"parallel {k}: rays a rank {[g['rays'] for g in got]}")
        for r, g in enumerate(got):
            if not g["launches"].get(counter, 0) > 0:
                raise AssertionError(f"path {path}: rank {r} launched {counter} no time")
        grad_tol = CHAIN_TOL[("bwd", "float32" if k.endswith("_f32") else "bfloat16")]
        norm_tol = PARALLEL_NORM_TOL[stage]
        agree = parallel_agreement(
            f"parallel {k}: two ranks over gloo against one process", got[0], ref[k],
            grad_tol, norm_tol)
        # the gates must tell the global loss from each rank's own
        naive = parallel_shares(ranks[0][f"{k}_naive"], ref[k], grad_tol)
        log(f"parallel {k}: the naive control (each rank's own loss, the gradients "
            f"averaged): first-step gradients at {naive['worst_grad_share']:.3g} of their "
            f"tolerance ({naive['worst_grad']}), terms at {naive['worst_term_share']:.3g} "
            f"({naive['worst_term']}), parameters {naive['worst_param_norm_ratio']:.4g} of "
            f"an update norm ({naive['worst_param']}; tol {norm_tol})")
        if not (naive["worst_grad_share"] > 1 or naive["worst_term_share"] > 1
                or naive["worst_param_norm_ratio"] > norm_tol):
            raise AssertionError(f"parallel {k}: the naive control passes every gate")
        paths[path] = {c: sum(g["launches"][c] for g in got) for c in got[0]["launches"]}
        res["gloo_2_ranks"][k] = dict(
            agree, naive_control=naive, rank_step_ms=[g["step_ms"] for g in got],
            plain_step_ms=ref[k]["step_ms"],
            allreduce_ms=[g["reduce_ms"] for g in got], allreduce_bytes=got[0]["grad_bytes"],
            collectives_per_step=got[0]["collectives_per_step"],
            peak_gib=[g["peak_gib"] for g in got],
            launches_by_rank=[g["launches"] for g in got])
        for r, g in enumerate(got):
            log(f"parallel {k} rank {r} of 2 (gloo, one card): {g['rays']} rays, step ms "
                f"{g['step_ms']}, gradient all-reduce {g['reduce_ms']} ms of "
                f"{g['grad_bytes']} bytes, {g['collectives_per_step']:.0f} all-reduces a "
                f"step, peak {g['peak_gib']:.2f} GiB, launches {g['launches']}")
    res["ranks_ready_s"] = [r["ready_s"] for r in ranks]
    res["spawn_s"] = spawn_s
    res["seconds"] = time.perf_counter() - t_phase
    log(f"parallel: two ranks share one card ({card_line()}): they measure correctness "
        f"and the collectives' overhead, not scaling; ranks ready after "
        f"{res['ranks_ready_s']} s, the spawn {spawn_s:.1f} s, the phase "
        f"{res['seconds']:.1f} s")
    return paths, res


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    # --parent DIR: also time the parent tree's K1 (DIR holds its package)
    parent = sys.argv[sys.argv.index("--parent") + 1] if "--parent" in sys.argv else None
    dev = torch.device("cuda")
    card = card_line()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off for f32 matmuls and convolutions; torch", torch.__version__,
        "cuda", torch.version.cuda)
    t_start = time.perf_counter()

    from nunerf_tpu_torch.models.stage1 import ShapeRenderer
    from nunerf_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    libs = cuda_build.build_all()
    log(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")

    from nunerf_tpu_torch.tracing.scene import Scene

    t0 = time.perf_counter()
    verts, tris = lumpy_sphere_mesh(MESH_RESOLUTION)
    march_s = time.perf_counter() - t0
    scene = Scene((verts, tris), device=dev)
    log(f"outer mesh: {len(tris)} triangles, {len(verts)} vertices, marched natively at "
        f"{MESH_RESOLUTION}^3 in {march_s:.2f} s; scene built in "
        f"{time.perf_counter() - t0 - march_s:.2f} s")
    if not 80000 <= len(tris) <= 120000:
        raise AssertionError(f"{len(tris)} triangles: outside the 80,000-120,000 "
                             "that stage 2 traces")

    renderer = ShapeRenderer(BENCH_CFG, device=dev, seed=0)
    rec = phase_kernels(renderer, dev, parent)
    rec.update(phase_kernels_jac(renderer, dev))
    path_checks = phase_path_checks(dev)
    chain_passes = phase_chain_passes(dev, parent)
    phase_kernels_odd(renderer, dev)
    del renderer
    head_shapes = phase_kernels_heads(dev)
    rec["K3"] = phase_kernel_k3(scene, dev)
    res_dense = phase_dense_rounding(dev)
    phase_small_check(dev)
    phase_small_check_stage2(dev)
    phase_small_check_shell(dev)
    # every main path: counters set to 0 just before, read just after
    paths = {}
    paths["stage1"], res = phase_main_path(dev)
    paths["stage2"], res2 = phase_main_path_stage2(scene, dev)
    paths["A"], res_a = phase_main_path(dev, "fused_sdf")
    paths["B"], res_b = phase_main_path_stage2(scene, dev, fused_sdf=True)
    paths["C"], res_c = phase_main_path(dev, "fused_mlp")
    par_paths, res_par = phase_parallel(scene, verts, tris, dev)
    paths.update(par_paths)
    import os
    import shutil
    import tempfile

    work = tempfile.mkdtemp(prefix="nunerf_smoke_")
    cwd = os.getcwd()
    try:
        os.chdir(work)  # validation images and meshes go under ./data
        trainer_paths, res_t, ckpt1 = phase_trainer(dev, verts, tris, res[0]["step_ms"],
                                                    work)
        paths.update(trainer_paths)
        paths["extract_s1"], res_x, outer_mesh = phase_extract(dev, ckpt1)
        paths["shell"], res_shell = phase_main_path_shell(outer_mesh, dev)
        pipe_paths, res_pipe = phase_shell_pipeline(dev, work, ckpt1, outer_mesh)
        paths.update(pipe_paths)
        paths["pipeline_front"], res_leg = phase_pipeline(
            dev, work, os.path.join(work, "model", SHELL_CFG["name"], "model.ckpt"))
        paths["pipeline_stage2"], res_leg_stage2 = phase_pipeline_stage2(dev, work)
        paths["pipeline_res1024"], res_leg_res1024 = phase_pipeline_res1024(dev, work)
        paths["pipeline_shell"], res_leg_shell = phase_pipeline_shell(dev, work)
        paths["pipeline_real"], res_leg_real = phase_pipeline_real(dev, work)
        tool_paths, res_tools = phase_tools(dev, work, ckpt1, res_x["extract_s1"]["mesh"],
                                            outer_mesh)
        paths.update(tool_paths)
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    for path, counter in (("trainer_s1", "chain_fwd"), ("trainer_s1", "chain_bwd"),
                          ("trainer_s2", "closest_hit"),
                          ("extract_s1", "chain_fwd"), ("extract_s2", "chain_fwd"),
                          ("shell", "closest_hit"), ("trainer_shell", "closest_hit"),
                          ("A", "chain_jac_fwd"), ("A", "chain_jac_bwd"),
                          ("B", "chain_jac_fwd"), ("B", "chain_jac_bwd"),
                          ("C", "chain_fwd"), ("C", "chain_bwd"),
                          ("stage1", "chain_fwd"), ("stage1", "chain_bwd"),
                          ("stage2", "closest_hit"), ("B", "closest_hit"),
                          ("render_mask", "closest_hit"), ("postprocess_outer", "closest_hit"),
                          ("primary_visibility", "closest_hit"),
                          ("render_mask_prior", "closest_hit"),
                          ("render_orbit", "chain_fwd"), ("sphere_trace", "chain_fwd"),
                          ("parallel_s1", "chain_fwd"), ("parallel_s2", "closest_hit"),
                          ("parallel_s1_f32", "chain_fwd"),
                          ("parallel_s2_f32", "closest_hit"),
                          ("pipeline_front", "chain_fwd"), ("pipeline_front", "chain_bwd"),
                          ("pipeline_shell", "chain_fwd"), ("pipeline_shell", "chain_bwd"),
                          ("pipeline_shell", "closest_hit"),
                          ("pipeline_stage2", "chain_fwd"), ("pipeline_stage2", "closest_hit"),
                          ("pipeline_real", "chain_fwd"), ("pipeline_real", "chain_bwd"),
                          ("pipeline_real", "closest_hit"),
                          ("pipeline_res1024", "chain_fwd"),
                          ("pipeline_res1024", "closest_hit")):
        if not paths[path].get(counter, 0) > 0:
            raise AssertionError(f"path {path} launched {counter} no time")

    names = {"K1": ("chain_fwd", "chain-MLP forward (fused_chain_mlp fwd; "
                                 "chain_fwd_wgmma_kernel)"),
             "K2": ("chain_bwd", "chain-MLP backward (fused_chain_mlp VJP; "
                                 "chain_fwd_wgmma_kernel, chain_bwd_wgmma_kernel<BW_DATA, "
                                 "split>, chain_dw_wgmma_kernel)"),
             "K3": ("closest_hit", "ray/triangle closest hit (ray_mesh_closest_hit)"),
             "K4": ("chain_jac_fwd", "chain-MLP value + Jacobian of channel 0 "
                                     "(chain_mlp_with_grad0 fwd; chain_fwd_wgmma_kernel, "
                                     "chain_bwd_wgmma_kernel<BW_JDOWN>)"),
             "K5": ("chain_jac_bwd", "backward of K4 from (gy, gj) "
                                     "(chain_mlp_with_grad0 VJP; chain_fwd_wgmma_kernel, "
                                     "chain_bwd_wgmma_kernel<BW_JDOWN, BW_JUP, BW_DATA>, "
                                     "chain_dw_wgmma_kernel)")}
    # beside the contract's keys, only numbers this run measured or counted:
    # the bounds of other shapes and other ray counts stay in the log
    # K1 at the extraction sweep's chunk, beside its main shape
    # K3 at tool scale: render-mask's chunk on the raw 512^3 mesh
    tool = res_tools["render_mask"]
    rec["K3"]["tool_scale"] = {k: tool[k] for k in (
        "triangles", "tiles", "groups", "chunk", "ms_chunk", "ms_chunk_top", "ms_view",
        "ms_view_one_call", "bound_ms_chunk", "bound_by", "bound_ms_chunk_two_level",
        "bound_by_two_level", "device_ms_by_kernel", "k3_rays_per_s", "plain_hit_differs")}
    # K3 on the raw 1024^3 mesh (the res1024 leg's), K1 over its grid
    rec["K3"]["raw_mesh_1024"] = {k: v for k, v in res_leg_res1024["k3"].items()
                                  if k != "device_ms_by_kernel"}
    rec["K1"]["sweep_1024"] = dict(
        launches=res_leg_res1024["by_command"]["extract-mesh-stage1"]["chain_fwd"],
        sweep_s=res_leg_res1024["extract"]["sweep_s"], points=1024 ** 3)
    chunk = res_x["k1_chunk"]
    rec["K1"].update({f"{k}_n{chunk['n']}": chunk[k]
                      for k in ("ms", "plain_ms", "bound_ms", "rel_err")})
    measured = (f"ms_n{chunk['n']}", f"plain_ms_n{chunk['n']}", f"bound_ms_n{chunk['n']}",
                f"rel_err_n{chunk['n']}",
                "max_rel_err", "tol", "data_pass_dx_err", "data_pass_gz_ulps",
                "kernel", "device_ms", "share", "by_shape",
                "split_probe_f32_units", "scratch_gib", "brute_ms", "culled_ms",
                "culled_rounds", "box_pairs_passed", "tri_pairs_tested", "ms_r131072",
                "box_pairs_passed_r131072", "tri_pairs_tested_r131072", "mode", "ms_exact",
                "ms_exact_r131072", "brute_sweep_agreement", "culled_descent_agreement",
                "brute_sweep_agreement_r131072", "adversarial_agreement_tile8",
                "adversarial_agreement_tile32", "tool_scale", "raw_mesh_1024", "sweep_1024",
                "bound_ms_two_level",
                "bound_by_two_level", "groups", "device_ms_by_kernel", "bound_ms_r131072",
                "bound_ms_two_level_r131072", "device_ms_by_kernel_r131072")
    kernels = []
    for k in ("K1", "K2", "K3", "K4", "K5"):
        counter, desc = names[k]
        r = rec[k]
        extra = {x: r[x] for x in measured if x in r}
        by_path = {p: c.get(counter, 0) for p, c in paths.items()}
        if k in ("K2", "K4", "K5"):
            extra["by_pass"] = {c: v for c, v in chain_passes.items() if c.startswith(k)}
        if k == "K2":
            extra["path_checks"] = path_checks
        if k in ("K1", "K2"):
            extra["other_shapes"] = [
                {x: h[x] for x in ("shape", "k1_ms", "module_fwd_ms", "k2_ms",
                                   "module_fwd_bwd_ms", "fwd_rel_err", "bwd_rel_err")}
                for h in head_shapes]
        # library_ms: no single PyTorch call computes a whole chain, its
        # backward, a Jacobian with its double backward, or a closest hit
        kernels.append({"name": f"{k} {desc}", "route": "cuda", "source": SOURCE[k],
                        "replaces": REPLACES[k], "launches": sum(by_path.values()),
                        "launches_by_path": by_path,
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": None,
                        "shape": r["shape"], **extra})

    def step_summary(r):
        return {k: r[k] for k in ("step_ms", "rays_per_s", "peak_gib")}

    summary = {"card": card,
               "step_ms": {str(s): v["step_ms"] for s, v in res.items()},
               "rays_per_s": {str(s): v["rays_per_s"] for s, v in res.items()},
               "stage2_step_ms": res2["step_ms"],
               "stage2_rays_per_s": res2["rays_per_s"],
               "stage2_peak_gib": res2["peak_gib"],
               "stage2_triangles": len(tris),
               "bf16_dense": res_dense,
               "path_A_stage1_fused_sdf": step_summary(res_a[25000]),
               "path_B_stage2_fused_sdf": step_summary(res_b),
               "path_C_stage1_fused_mlp": dict(
                   step_summary(res_c[25000]),
                   launches_per_step=res_c[25000]["launches_per_step"]),
               "trainer": res_t,
               "extract": res_x,
               "shell_step": res_shell,
               "shell_pipeline": res_pipe,
               "pipeline_front": res_leg,
               "pipeline_shell": res_leg_shell,
               "pipeline_stage2": res_leg_stage2,
               "pipeline_real": res_leg_real,
               "pipeline_res1024": res_leg_res1024,
               "tools": res_tools,
               "parallel": res_par,
               "seconds": time.perf_counter() - t_start}
    log(json.dumps(summary))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
