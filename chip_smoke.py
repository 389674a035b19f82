"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. device: CUDA required; prints the card's name and power limit; TF32 off
     for f32 matmuls and convolutions (the plain versions run in full f32);
  2. build: every ``nunerf_tpu_torch/csrc/*.cu``, one ``nvcc`` each, in
     parallel;
  3. kernels: K1 (chain forward), K2 (chain backward) and K3 (ray/triangle
     closest hit) against their plain PyTorch versions at the main path's
     shapes, with times after warm-up (CUDA events) beside each kernel's
     bound; K3 on the full-width mesh, beside the port's brute sweep and
     tile-culled descent on the same rays;
  4. correctness: a small stage-1 step and a small stage-2 step on the card
     (kernels on) against the same steps on the CPU (plain versions);
  5. the main paths, each with the launch counters set to 0 just before and
     read just after: the stage-1 training step at ``BENCH_CFG``'s full
     width (1024 rays, 64+64 SDF samples, 8x256 SDF and NeRF++), a few Adam
     steps at step 0 (init-SDF regulariser on: K1 and K2) and at step 25000
     (occlusion loss on: K1); and the stage-2 zero-thickness training step
     at ``STAGE2_CFG``'s full width (1024 rays, 256 samples on each outside
     segment, 64 + 2x32 inside the glass, 3 bounces through a mesh of about
     10^5 triangles, frozen stage-1 weights): 3 K3 launches a step.

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
          "K3": "nunerf_tpu_torch/csrc/ray_intersect.cu"}
REPLACES = {"K1": "nunerf_tpu/ops/fused_mlp.py:168",        # _fwd_kernel
            "K2": "nunerf_tpu/ops/fused_mlp.py:199",        # _make_bwd_kernel
            "K3": "nunerf_tpu/ops/pallas_intersect.py:33"}  # _mt_kernel


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

    # tolerances, relative to the plain output's largest magnitude: f32 sums
    # in another order (1e-5 fwd, 1e-4 bwd); bf16 roundings of hidden
    # activations and cotangents that flip with the sum order (1e-2, 3e-2)
    tol = {("fwd", "float32"): 1e-5, ("fwd", "bfloat16"): 1e-2,
           ("bwd", "float32"): 1e-4, ("bwd", "bfloat16"): 3e-2}
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
            ms = cuda_ms(lambda: fm.chain_bwd_cuda(spec, x, g, flat), 5)
            plain = cuda_ms(plain_grads, 5)
            nbytes = 4 * (2 * x.numel() + g.numel()) + 2 * chain_bytes(spec, 0)
            b, by = bound_ms(3 * fm.chain_flops(spec, n), nbytes, spec.compute_dtype)
            rec["K2"] = dict(max_abs_err=max(float((a - r).abs().max())
                                             for a, r in zip((dx,) + dflat, ref)),
                             max_rel_err=max(errs), tol=t,
                             ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                             shape=f"SDF value-only chain, N={n}, bf16")
            log(f"K2 N={n} bf16: {ms:.3f} ms, plain (autograd fwd+bwd) "
                f"{plain:.3f} ms, bound {b:.4f} ms ({by})")
    return rec


def phase_kernel_k3(scene, dev):
    """K3 against its plain version on the full-width mesh: exact ``t``,
    index and ``hit`` (the kernel multiplies and adds without FMA
    contraction, one rounding an operation as the plain version)."""
    from nunerf_tpu_torch.ops import ray_intersect as ri
    from nunerf_tpu_torch.tracing import intersect as ti

    n_tris = len(scene.tris_np)
    tri = (scene.v0, scene.e1, scene.e2)
    # the tile index the scene would build with the kernel off, to time the
    # culled descent beside K3
    cull_tile, group = ti.auto_tile_params(n_tris)
    index = ti.build_tile_index(scene.verts_np, scene.tris_np, tile=cull_tile,
                                group=group, device=dev)
    rec = None
    for rn in (1024, 5000):
        ro, rd, kind = intersect_rays(rn, rn, dev)
        t, idx, hit = ri.closest_hit_cuda(ro, rd, *tri)
        torch.cuda.synchronize()
        rt, ridx, rhit = ri.closest_hit_reference(ro, rd, *tri)
        kind = torch.as_tensor(kind, device=dev)
        share = [float(hit[kind == j].double().mean()) for j in range(3)]
        same = torch.equal(t, rt) and torch.equal(idx, ridx) and torch.equal(hit, rhit)
        err = float((t - rt).abs().max())
        log(f"K3 closest hit R={rn} T={n_tris}: hit share outside/inside/away "
            f"{share[0]:.3f}/{share[1]:.3f}/{share[2]:.3f}, max |t - plain| {err:.1e}, "
            f"index and hit {'equal' if same else 'DIFFER'} (held exactly)")
        if not same:
            bad = int((idx != ridx).sum()), int((hit != rhit).sum()), int((t != rt).sum())
            raise AssertionError(f"K3 disagrees with its plain version: {bad} "
                                 "(index, hit, t) rays differ")
        if not (share[0] > 0.9 and bool(hit[kind == 1].all())
                and not bool(hit[kind == 2].any())):
            raise AssertionError(f"K3 hit shares {share}: expected hits from outside "
                                 "and inside, none pointing away")
        if not (bool((idx[~hit] == 0).all()) and bool((t[~hit] == ri.MISS_T).all())):
            raise AssertionError("K3 missed lanes do not carry (MISS_T, 0)")
        # the brute sweep and the culled descent answer the same query with a
        # barycentric tolerance: equal t wherever all agree on the hit
        brute = ti.ray_mesh_intersect(ro, rd, *tri, tile=scene.tile)
        rounds = []
        culled = ti.ray_mesh_intersect_culled(ro, rd, index, group=group,
                                              rounds_out=rounds)
        both = hit & brute.hit & culled.hit
        for name, other in (("brute sweep", brute), ("culled descent", culled)):
            if int((other.hit != hit).sum()) > rn // 500:
                raise AssertionError(f"{name} and K3 disagree on hit for "
                                     f"{int((other.hit != hit).sum())} of {rn} rays")
            if not torch.allclose(other.t[both], t[both], rtol=1e-5):
                raise AssertionError(f"{name} and K3 disagree on t")
        if rn == 1024:
            ms = cuda_ms(lambda: ri.closest_hit_cuda(ro, rd, *tri), 20)
            plain = cuda_ms(lambda: ri.closest_hit_reference(ro, rd, *tri), 2)
            brute_ms = cuda_ms(lambda: ti.ray_mesh_intersect(ro, rd, *tri, tile=scene.tile), 2)
            culled_ms = cuda_ms(lambda: ti.ray_mesh_intersect_culled(
                ro, rd, index, group=group), 2)
            # pairs x the kernel's f32 operations a pair against the f32
            # peak without tensor cores; rays and triangles read once, three
            # outputs (t, index, hit) written once
            flops = rn * n_tris * ri.OPS_PER_PAIR
            nbytes = 4 * (6 * rn + 9 * n_tris) + 9 * rn  # the mesh's own triangles
            b, by = bound_ms(flops, nbytes, "float32")
            rec = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                       brute_ms=brute_ms, culled_ms=culled_ms, culled_rounds=rounds[0],
                       shape=f"R={rn} rays x T={n_tris} triangles, f32")
            log(f"K3 R={rn}: {ms:.3f} ms, plain {plain:.1f} ms, brute sweep "
                f"{brute_ms:.1f} ms, culled descent {culled_ms:.1f} ms "
                f"({rounds[0]} rounds, one host sync each), bound {b:.4f} ms ({by})")
    return rec


def phase_small_check(dev):
    """The small step on the card (kernels on) against the CPU (plain)."""
    from nunerf_tpu_torch.models.stage1 import ShapeRenderer
    from nunerf_tpu_torch.train.trainer import TrainStep

    for step in (0, 25000):
        terms = {}
        for d in (dev, torch.device("cpu")):
            r = ShapeRenderer(SMALL_CFG, device=d, seed=3)
            if step == 0:
                with torch.no_grad():  # SDF about |x| - 1.2: init reg "large" live
                    r.sdf_net.layers()[-1].b[0] -= 0.7
            terms[d.type] = TrainStep(r)(batch_for(SMALL_CFG, d), step)
            if r.fused_sdf_value != (d.type == "cuda"):
                raise AssertionError("the fused SDF gate does not follow the device")
        # the card's SDF sweeps and occlusion march run the bf16 chain, so
        # sample positions and the march's hits move slightly: loss_total
        # agrees to 1e-2 relative, each term to 5e-2 of itself plus 1e-3 of
        # loss_total (the occlusion term is the most sensitive)
        total = float(terms["cpu"]["loss_total"])
        for k, v in terms["cpu"].items():
            a, b = float(terms["cuda"][k]), float(v)
            tol = 1e-2 * abs(b) if k == "loss_total" else 5e-2 * abs(b) + 1e-3 * abs(total)
            if not (math.isfinite(a) and abs(a - b) <= tol):
                raise AssertionError(f"step {step} {k}: card {a} vs cpu {b}")
        log(f"small step {step}: card loss_total {float(terms['cuda']['loss_total']):.6f}"
            f" vs cpu {float(terms['cpu']['loss_total']):.6f} ok")


def phase_small_check_stage2(dev):
    """A small stage-2 step on the card (closest hit by K3) against the same
    step on the CPU (closest hit by the brute sweep), f32 on both."""
    from nunerf_tpu_torch.models.stage1 import ShapeRenderer
    from nunerf_tpu_torch.models.stage2 import Stage2Renderer
    from nunerf_tpu_torch.ops import ray_intersect as ri
    from nunerf_tpu_torch.tracing.mesh_ops import extract_geometry
    from nunerf_tpu_torch.tracing.scene import Scene
    from nunerf_tpu_torch.train.trainer import TrainStep

    mesh = extract_geometry(lambda p: np.linalg.norm(p, axis=-1) - 0.5, resolution=16)
    terms = {}
    for d in (dev, torch.device("cpu")):
        scene = Scene(mesh, tile=512, device=d)
        if scene.use_kernel != (d.type == "cuda"):
            raise AssertionError("the closest-hit kernel gate does not follow the device")
        s1 = ShapeRenderer(SMALL_CFG, device=d, seed=3)
        r = Stage2Renderer(SMALL_S2_CFG, scene, s1, device=d, seed=4)
        before = dict(ri.launches)
        terms[d.type] = TrainStep(r, 5e-4)(stage2_batch(16, d), 10)
        n = ri.launches["closest_hit"] - before["closest_hit"]
        if n != (3 if d.type == "cuda" else 0):
            raise AssertionError(f"{n} K3 launches in a small step on {d.type}")
    # f32 on both sides and no bf16: the card orders its sums differently, and
    # a sample position or an edge ray can move with it, so loss_total agrees
    # to 1e-3 relative and each term to 1e-2 of itself plus 1e-3 of loss_total
    total = float(terms["cpu"]["loss_total"])
    for k, v in terms["cpu"].items():
        a, b = float(terms["cuda"][k]), float(v)
        tol = 1e-3 * abs(b) if k == "loss_total" else 1e-2 * abs(b) + 1e-3 * abs(total)
        if not (math.isfinite(a) and abs(a - b) <= tol):
            raise AssertionError(f"stage-2 small step {k}: card {a} vs cpu {b}")
    log(f"small stage-2 step ({len(mesh[1])} triangles): card loss_total "
        f"{float(terms['cuda']['loss_total']):.6f} vs cpu {total:.6f} ok")


def phase_main_path_stage2(scene, dev):
    """A few stage-2 training steps at full width through the entry points."""
    from nunerf_tpu_torch.models.stage1 import ShapeRenderer
    from nunerf_tpu_torch.models.stage2 import Stage2Renderer
    from nunerf_tpu_torch.ops import fused_mlp as fm
    from nunerf_tpu_torch.ops import ray_intersect as ri
    from nunerf_tpu_torch.train.trainer import TrainStep

    stage1 = ShapeRenderer(BENCH_CFG, device=dev, seed=0)
    renderer = Stage2Renderer(STAGE2_CFG, scene, stage1, device=dev, seed=1)
    del stage1
    if not scene.use_kernel:
        raise AssertionError("the closest-hit kernel is off on the card")
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
            raise AssertionError(f"stage-2 step: non-finite {bad}")
    launches = dict(ri.launches)
    chain = dict(fm.launches)

    steady = times[1:]
    ms = 1e3 * sum(steady) / len(steady)
    log(f"stage-2 main path: {n_steps} steps, steady {ms:.1f} ms/step "
        f"({rn / (ms / 1e3):.0f} rays/s), first {1e3 * times[0]:.1f} ms, loss_total "
        f"{float(terms['loss_total']):.5f}, ior_glass {float(terms['ior_glass']):.4f}, "
        f"launches {launches} (chain kernels {chain}), peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    if launches != {"closest_hit": 3 * n_steps}:
        raise AssertionError(f"K3 launches {launches}, expected {3 * n_steps} "
                             "(one a bounce, three bounces a step)")
    if any(chain.values()):
        raise AssertionError(f"the stage-2 step launched chain kernels: {chain}")
    for n, p in renderer.stage1.named_parameters():
        if p.grad is not None or not torch.equal(frozen[n], p.detach()):
            raise AssertionError(f"frozen stage-1 parameter {n} changed")
    for n in watched:
        if torch.equal(watch[n], params[n].detach()):
            raise AssertionError(f"trainable parameter {n} did not change")
    return launches, dict(step_ms=ms, rays_per_s=rn / (ms / 1e3),
                          first_step_ms=1e3 * times[0],
                          loss_total=float(terms["loss_total"]))


def phase_main_path(dev):
    from nunerf_tpu_torch.models.stage1 import ShapeRenderer
    from nunerf_tpu_torch.ops import fused_mlp as fm
    from nunerf_tpu_torch.train.trainer import TrainStep

    renderer = ShapeRenderer(BENCH_CFG, device=dev, seed=0)
    if not renderer.fused_sdf_value:
        raise AssertionError("the fused SDF value path is off on the card")
    train = TrainStep(renderer, 5e-4)
    batch = batch_for(BENCH_CFG, dev)
    watch = {n: p.detach().clone() for n, p in renderer.named_parameters()
             if n in ("sdf_net.lin0.v", "sdf_net.lin8.b", "outer_nerf.pts_0.kernel",
                      "color_net.albedo.out.v", "var_net.variance")}
    rn = BENCH_CFG["train_ray_num"]
    n0, n1 = 3, 6
    res = {}

    fm.reset_launches()
    phase_counts = {}
    for step, n_steps in ((0, n0), (25000, n1)):
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
                raise AssertionError(f"step {step}: non-finite {bad}")
        phase_counts[step] = {k: fm.launches[k] - before[k] for k in before}
        steady = times[1:]
        ms = 1e3 * sum(steady) / len(steady)
        res[step] = dict(step_ms=ms, rays_per_s=rn / (ms / 1e3),
                         first_step_ms=1e3 * times[0],
                         loss_total=float(terms["loss_total"]),
                         terms={k: float(v) for k, v in terms.items()})
        log(f"main path step {step}: {n_steps} steps, steady {ms:.1f} ms/step "
            f"({rn / (ms / 1e3):.0f} rays/s), first {1e3 * times[0]:.1f} ms, "
            f"loss_total {float(terms['loss_total']):.5f}, launches "
            f"{phase_counts[step]}")
    launches = dict(fm.launches)

    want = {0: {"chain_fwd": 5 * n0, "chain_bwd": n0},
            25000: {"chain_fwd": 6 * n1, "chain_bwd": 0}}
    if phase_counts != want:
        raise AssertionError(f"launch counts {phase_counts}, expected {want}")
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
    del renderer
    rec["K3"] = phase_kernel_k3(scene, dev)
    phase_small_check(dev)
    phase_small_check_stage2(dev)
    launches, res = phase_main_path(dev)
    launches2, res2 = phase_main_path_stage2(scene, dev)
    launches.update(launches2)

    names = {"K1": ("chain_fwd", "chain-MLP forward (fused_chain_mlp fwd)"),
             "K2": ("chain_bwd", "chain-MLP backward (fused_chain_mlp VJP)"),
             "K3": ("closest_hit", "ray/triangle closest hit (ray_mesh_closest_hit)")}
    kernels = []
    for k in ("K1", "K2", "K3"):
        counter, desc = names[k]
        r = rec[k]
        extra = {x: r[x] for x in ("max_rel_err", "tol", "brute_ms", "culled_ms",
                                   "culled_rounds") if x in r}
        kernels.append({"name": f"{k} {desc}", "route": "cuda", "source": SOURCE[k],
                        "replaces": REPLACES[k], "launches": launches[counter],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": None,
                        "shape": r["shape"], **extra})
    summary = {"card": card,
               "step_ms": {str(s): v["step_ms"] for s, v in res.items()},
               "rays_per_s": {str(s): v["rays_per_s"] for s, v in res.items()},
               "stage2_step_ms": res2["step_ms"],
               "stage2_rays_per_s": res2["rays_per_s"],
               "stage2_triangles": len(tris),
               "seconds": time.perf_counter() - t_start}
    log(json.dumps(summary))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
