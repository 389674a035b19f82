"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. device: CUDA required; prints the card's name and power limit; TF32 off
     for f32 matmuls and convolutions (the plain versions run in full f32);
  2. build: every ``nunerf_tpu_torch/csrc/*.cu``, one ``nvcc`` each, in
     parallel;
  3. kernels: K1 (chain forward), K2 (chain backward), K3 (ray/triangle
     closest hit), K4 (chain value + Jacobian of channel 0) and K5 (its
     backward) against their plain PyTorch versions at the main paths'
     shapes, with times after warm-up (CUDA events) beside each kernel's
     bound; K1/K2 also at a shading head's shape (259 inputs) and at the
     NeRF++ trunk's, beside the plain modules; K1, K2, K4 and K5 at the shapes
     that can break a tiled MMA (N = 1, 63, 65, 1000; inputs of 39, 84, 131,
     259 and 512; the 217-deep layer; last layers of 1, 3, 64 and 257 with
     no activation, a relu or a softplus), f32 and bf16; K2's bf16 data pass
     also against f32 products of its own stashes, and on one-layer probes
     whose dx is the f32 weights to the last bit; K3, tile-culled over the
     scene's index, on the full-width mesh at 1024, 5000 and 131,072 rays
     (its pair counts and the bound of its culled work beside the brute
     sweep's), beside the port's brute sweep and tile-culled descent, and on
     an adversarial box mesh;
  4. correctness: a small stage-1 step and a small stage-2 step on the card
     (kernels on) against the same steps on the CPU (plain versions), plain
     and with the ``fused_sdf`` / ``fused_mlp`` gates on;
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
     trunk and every shading head).

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

# the port's copy of bench.py's BENCH_CFG (the full-width stage-1 step)
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

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 without
# them, HBM3 bandwidth
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

SOURCE = {"K1": "nunerf_tpu_torch/csrc/fused_mlp.cu",
          "K2": "nunerf_tpu_torch/csrc/fused_mlp.cu",
          "K3": "nunerf_tpu_torch/csrc/ray_intersect.cu",
          "K4": "nunerf_tpu_torch/csrc/fused_mlp.cu",
          "K5": "nunerf_tpu_torch/csrc/fused_mlp.cu"}
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
    rn = cfg["train_ray_num"]
    rs = np.random.RandomState(0)
    origins = np.tile(np.array([[0.0, 0.0, -2.5]], np.float32), (rn, 1))
    dirs = rs.randn(rn, 3).astype(np.float32) * 0.3 - origins
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    b = {"rays_o": origins, "rays_d": dirs.astype(np.float32),
         "near": np.full((rn, 1), 0.8, np.float32),
         "far": np.full((rn, 1), 4.5, np.float32),
         "rgbs": rs.rand(rn, 3).astype(np.float32),
         "masks": np.ones((rn,), np.float32)}
    return {k: torch.as_tensor(v, device=dev) for k, v in b.items()}


def lumpy_sphere_mesh(resolution):
    """The outer mesh stage 2 traces: a lumpy sphere (radius 0.5 +- 0.05)
    marched with the port's ``extract_geometry``."""
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


def phase_kernels(renderer, dev):
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
    """The least time of the culled work this run's rays needed, and what
    bounds it: every (ray, tile) box test and every ray-triangle pair swept
    (the kernel's own counts) at the f32 peak without tensor cores, against
    the rays, the index and the outputs (t, index, hit) moved once."""
    n_tiles = index.box.shape[0]
    flops = rn * n_tiles * ri.OPS_PER_BOX + int(stats[1]) * ri.OPS_PER_PAIR
    nbytes = 24 * rn + 40 * index.v0.shape[0] + 24 * n_tiles + 9 * rn
    return bound_ms(flops, nbytes, "float32")


def phase_kernel_k3(scene, dev):
    """K3, tile-culled over the scene's index, against its plain version on
    the full-width mesh: exact ``t``, index and ``hit`` (the kernel multiplies
    and adds without FMA contraction, one rounding an operation as the plain
    version) at R = 1024 and 5000, on a fixed 8,192-ray subset of R =
    131,072 (a ray's answer does not depend on the other rays), and on an
    adversarial box mesh; the kernel's lists against the plain box test; the
    pairs it tested and the bound of that culled work beside the brute
    sweep's."""
    from nunerf_tpu_torch.ops import ray_intersect as ri
    from nunerf_tpu_torch.tracing import intersect as ti
    from nunerf_tpu_torch.tracing.probes import adversarial_rays, box_mesh

    n_tris = len(scene.tris_np)
    tri = (scene.v0, scene.e1, scene.e2)
    index = scene.kernel_index
    # the tile index the scene would build with the kernel off, to time the
    # culled descent beside K3
    cull_tile, group = ti.auto_tile_params(n_tris)
    descent_index = ti.build_tile_index(scene.verts_np, scene.tris_np, tile=cull_tile,
                                        group=group, device=dev)
    rec = None
    for rn in (1024, 5000, 131072):
        ro, rd, kind = intersect_rays(rn, rn, dev)
        stats = torch.zeros(2, dtype=torch.int64, device=dev)
        t, idx, hit = ri.closest_hit_cuda(ro, rd, index, stats=stats)
        torch.cuda.synchronize()
        sub = (torch.arange(rn, device=dev) if rn <= 5000 else
               torch.as_tensor(np.random.RandomState(5).choice(rn, 8192, replace=False),
                               device=dev))
        rt, ridx, rhit = ri.closest_hit_reference(ro[sub], rd[sub], *tri)
        kind = torch.as_tensor(kind, device=dev)
        share = [float(hit[kind == j].double().mean()) for j in range(3)]
        same = (torch.equal(t[sub], rt) and torch.equal(idx[sub], ridx)
                and torch.equal(hit[sub], rhit))
        err = float((t[sub] - rt).abs().max())
        pairs, tests = int(stats[0]), int(stats[1])
        log(f"K3 culled closest hit R={rn} T={n_tris} ({index.box.shape[0]} tiles of "
            f"{index.tile}): {len(sub)} rays held, hit share outside/inside/away "
            f"{share[0]:.3f}/{share[1]:.3f}/{share[2]:.3f}, max |t - plain| {err:.1e}, "
            f"index and hit {'equal' if same else 'DIFFER'} (held exactly); (ray, tile) "
            f"pairs passed {pairs} ({pairs / rn:.1f} a ray), ray-triangle pairs tested "
            f"{tests} ({tests / rn:.0f} a ray, brute {n_tris})")
        if not same:
            bad = (int((idx[sub] != ridx).sum()), int((hit[sub] != rhit).sum()),
                   int((t[sub] != rt).sum()))
            raise AssertionError(f"K3 disagrees with its plain version: {bad} "
                                 "(index, hit, t) rays differ")
        if not (share[0] > 0.9 and bool(hit[kind == 1].all())
                and not bool(hit[kind == 2].any())):
            raise AssertionError(f"K3 hit shares {share}: expected hits from outside "
                                 "and inside, none pointing away")
        if not (bool((idx[~hit] == 0).all()) and bool((t[~hit] == ri.MISS_T).all())):
            raise AssertionError("K3 missed lanes do not carry (MISS_T, 0)")
        if rn == 5000:
            cand = ri.cull_candidates_cuda(ro, rd, index)
            plain = ri.cull_candidates_reference(ro, rd, index)
            torch.cuda.synchronize()
            if (plain & ~cand).any() or int(cand.sum()) != pairs:
                raise AssertionError("K3's lists miss a pair of the plain box test, or "
                                     "its count disagrees with them")
            log(f"K3 R={rn}: the kernel's lists hold all {int(plain.sum())} pairs of the "
                f"plain box test ({int(cand.sum())} listed)")
        if rn == 1024:
            # the brute sweep and the culled descent answer the same query
            # with a barycentric tolerance: equal t wherever all agree on the hit
            brute = ti.ray_mesh_intersect(ro, rd, *tri, tile=scene.tile)
            rounds = []
            culled = ti.ray_mesh_intersect_culled(ro, rd, descent_index, group=group,
                                                  rounds_out=rounds)
            both = hit & brute.hit & culled.hit
            for name, other in (("brute sweep", brute), ("culled descent", culled)):
                if int((other.hit != hit).sum()) > rn // 500:
                    raise AssertionError(f"{name} and K3 disagree on hit for "
                                         f"{int((other.hit != hit).sum())} of {rn} rays")
                if not torch.allclose(other.t[both], t[both], rtol=1e-5):
                    raise AssertionError(f"{name} and K3 disagree on t")
        if rn in (1024, 131072):
            ms = cuda_ms(lambda: ri.closest_hit_cuda(ro, rd, index), 20)
            plain_ms = cuda_ms(lambda: ri.closest_hit_reference(ro, rd, *tri), 2) \
                if rn == 1024 else None
            # the brute sweep's bound: every pair at 46 f32 ops a pair, the
            # mesh's own triangles and the rays read once
            brute_b, _ = bound_ms(rn * n_tris * ri.OPS_PER_PAIR,
                                  4 * (6 * rn + 9 * n_tris) + 9 * rn, "float32")
            b, by = k3_bound(ri, index, rn, stats)
            log(f"K3 R={rn}: {ms:.4f} ms, bound of the culled work {b:.4f} ms ({by}), "
                f"bound of the brute sweep {brute_b:.4f} ms"
                + (f", plain {plain_ms:.1f} ms" if plain_ms is not None else ""))
            if rn == 1024:
                brute_ms = cuda_ms(lambda: ti.ray_mesh_intersect(ro, rd, *tri, tile=scene.tile), 2)
                culled_ms = cuda_ms(lambda: ti.ray_mesh_intersect_culled(
                    ro, rd, descent_index, group=group), 2)
                log(f"K3 R={rn}: port's brute sweep {brute_ms:.1f} ms, culled descent "
                    f"{culled_ms:.1f} ms ({rounds[0]} rounds, one host sync each)")
                rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
                           box_pairs_passed=pairs, tri_pairs_tested=tests,
                           brute_ms=brute_ms, culled_ms=culled_ms, culled_rounds=rounds[0],
                           shape=f"R={rn} rays x T={n_tris} triangles, f32, tile-culled "
                                 f"({index.box.shape[0]} tiles of {index.tile})")
            else:
                rec.update(ms_r131072=ms, box_pairs_passed_r131072=pairs,
                           tri_pairs_tested_r131072=tests)

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
        got = ri.closest_hit_cuda(o, d, bindex)
        torch.cuda.synchronize()
        ref = ri.closest_hit_reference(o, d, *btri)
        if not all(torch.equal(a, r) for a, r in zip(got, ref)):
            raise AssertionError(f"K3 disagrees with its plain version on the "
                                 f"adversarial box (tile {tile})")
        log(f"K3 adversarial box ({len(tris)} triangles, tiles of {tile}): {len(o)} rays, "
            f"{int(got[2].sum())} hits, t, index and hit equal (held exactly)")
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
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
    scene = Scene((verts, tris), device=dev)
    log(f"outer mesh: {len(tris)} triangles, {len(verts)} vertices, marched at "
        f"{MESH_RESOLUTION}^3 in {time.perf_counter() - t0:.1f} s")
    if not 80000 <= len(tris) <= 120000:
        raise AssertionError(f"{len(tris)} triangles: outside the 80,000-120,000 "
                             "that stage 2 traces")

    renderer = ShapeRenderer(BENCH_CFG, device=dev, seed=0)
    rec = phase_kernels(renderer, dev)
    rec.update(phase_kernels_jac(renderer, dev))
    phase_kernels_odd(renderer, dev)
    del renderer
    head_shapes = phase_kernels_heads(dev)
    rec["K3"] = phase_kernel_k3(scene, dev)
    phase_small_check(dev)
    phase_small_check_stage2(dev)
    # every main path: counters set to 0 just before, read just after
    paths = {}
    paths["stage1"], res = phase_main_path(dev)
    paths["stage2"], res2 = phase_main_path_stage2(scene, dev)
    paths["A"], res_a = phase_main_path(dev, "fused_sdf")
    paths["B"], res_b = phase_main_path_stage2(scene, dev, fused_sdf=True)
    paths["C"], res_c = phase_main_path(dev, "fused_mlp")
    for path, counter in (("A", "chain_jac_fwd"), ("A", "chain_jac_bwd"),
                          ("B", "chain_jac_fwd"), ("B", "chain_jac_bwd"),
                          ("C", "chain_fwd"), ("C", "chain_bwd"),
                          ("stage1", "chain_fwd"), ("stage1", "chain_bwd"),
                          ("stage2", "closest_hit"), ("B", "closest_hit")):
        if not paths[path].get(counter, 0) > 0:
            raise AssertionError(f"path {path} launched {counter} no time")

    names = {"K1": ("chain_fwd", "chain-MLP forward (fused_chain_mlp fwd)"),
             "K2": ("chain_bwd", "chain-MLP backward (fused_chain_mlp VJP)"),
             "K3": ("closest_hit", "ray/triangle closest hit (ray_mesh_closest_hit)"),
             "K4": ("chain_jac_fwd", "chain-MLP value + Jacobian of channel 0 "
                                     "(chain_mlp_with_grad0 fwd)"),
             "K5": ("chain_jac_bwd", "backward of K4 from (gy, gj) "
                                     "(chain_mlp_with_grad0 VJP)")}
    # beside the contract's keys, only numbers this run measured or counted:
    # the bounds of other shapes and other ray counts stay in the log
    measured = ("max_rel_err", "tol", "data_pass_dx_err", "data_pass_gz_ulps",
                "split_probe_f32_units", "scratch_gib", "brute_ms", "culled_ms",
                "culled_rounds", "box_pairs_passed", "tri_pairs_tested", "ms_r131072",
                "box_pairs_passed_r131072", "tri_pairs_tested_r131072")
    kernels = []
    for k in ("K1", "K2", "K3", "K4", "K5"):
        counter, desc = names[k]
        r = rec[k]
        extra = {x: r[x] for x in measured if x in r}
        by_path = {p: c.get(counter, 0) for p, c in paths.items()}
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
               "path_A_stage1_fused_sdf": step_summary(res_a[25000]),
               "path_B_stage2_fused_sdf": step_summary(res_b),
               "path_C_stage1_fused_mlp": dict(
                   step_summary(res_c[25000]),
                   launches_per_step=res_c[25000]["launches_per_step"]),
               "seconds": time.perf_counter() - t_start}
    log(json.dumps(summary))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
