"""Where the time of the chain kernels (K1, K2, K4, K5) goes, on one GPU.

    python3 tools/prof_chain_kernels.py [--variants | --split-faults | --paths] [--n 131072]

Without ``--variants``: each wrapper at the SDF chain's full width (and K1 at
a 259-input head), bf16, random weights from a seed; CUDA-event time of the
whole call (packing, padding and the sums of partials included) and, from
``torch.profiler``, the device time of every kernel the call launches.

With ``--variants``: builds ``csrc/fused_mlp.cu`` with one piece of the
bf16 route compiled out at a time by the source's ``-DPROF_NO_*`` switches
(such a build computes nothing right and is only timed), and with other
ring depths, one ``nvcc`` each, all started together, into
``nunerf_tpu_torch/build/variants/``; then times K1, K4, K5 and K2 through
each.  The switches act on every pass of the route alike: K1's forward
(``chain_fwd_wgmma_kernel``, also pass 1 of K2, K4 and K5), the backward
walks (``chain_bwd_wgmma_kernel``: the data pass, the J-pass and its
reverse) and the dW GEMM (``chain_dw_wgmma_kernel``): their ``wgmma``
products (``-DPROF_NO_WGMMA``), their bulk copies, L2 prefetches and TMA
boxes (``-DPROF_NO_BULK``), the ring's depth (``-DWG_MAXST``), the
epilogues' activation math (``-DPROF_NO_ACT``), and all three at once (the
skeleton: loads, stores, barriers).  What a piece costs is the base time
less the time without it; if the pieces' costs add up to the whole,
nothing overlaps.

With ``--paths``: records the row counts and chains K2 is called with on
the stage-1 paths (``BENCH_CFG`` at step 0, where the init-SDF regulariser
runs K2, and path C, ``fused_mlp``, at step 25000: the NeRF++ trunk and the
shading heads), each call's own inputs kept, then times every distinct
(chain, rows) call as above, whole call and each kernel it launches.

With ``--split-faults``: builds the source as it is and with a fault planted
in K2's bf16 data pass (``-DPROF_SPLIT_SKIP``: the ``lo`` or the ``mid`` piece
of the f32 ``W^T``'s split left out), and runs each build through the card's
two checks of the split: dx and the rounded gz against f32 products of the
kernel's own stashes (``data_pass_errors``; limits 1e-5 and one bf16 unit) at
the SDF value chain, the head and a 512-wide input, and the one-layer probes
(``split_probe_units``; limit one unit of the last place).  A check that
passes a faulty build cannot see that fault.
"""

import argparse
import math
import os
import subprocess
import sys

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from nunerf_tpu_torch.ops import cuda_build  # noqa: E402
from nunerf_tpu_torch.ops import fused_mlp as fm  # noqa: E402

# the SDF chain without its last layer, and the 259-input shading head
from chip_smoke import SDF_CHAIN as SDF, head_chain  # noqa: E402

HEAD = head_chain(259, 3)

# -D flags of csrc/fused_mlp.cu: a piece compiled out, or another pipeline shape
VARIANTS = {"base": [],
            "no wgmma": ["-DPROF_NO_WGMMA"],
            "no bulk copies": ["-DPROF_NO_BULK"],
            "ring of 2": ["-DWG_MAXST=2"],
            "ring of 3": ["-DWG_MAXST=3"],
            "no activation math": ["-DPROF_NO_ACT"],
            "skeleton": ["-DPROF_NO_WGMMA", "-DPROF_NO_BULK", "-DPROF_NO_ACT"]}

# -D flags of the planted faults: a piece of K2's split left out
FAULTS = {"sound": [], "no lo": ["-DPROF_SPLIT_SKIP=2"], "no mid": ["-DPROF_SPLIT_SKIP=1"]}
WIDE = ((512, 256, 256, 64), ("relu",) * 3, (False,) * 3, (1.0,) * 3)
PROBES = ((39, 1), (39, 257), (84, 256), (259, 3), (512, 512))


def make_chain(dims, acts, skip, scales, dev, gen):
    spec = fm.ChainSpec(dims, acts, skip, scales, "bfloat16")
    flat = [(torch.randn(s, generator=gen) / math.sqrt(s[0])).to(dev)
            for s in fm.flat_weight_shapes(spec)]
    flat += [(torch.randn((1, d), generator=gen) * 0.1).to(dev) for d in dims[1:]]
    return spec, flat


def cuda_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def by_kernel(what, fn, reps):
    ms = cuda_ms(fn, reps)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = sorted(((e.key, e.device_time_total / reps, e.count / reps)
                   for e in prof.key_averages() if e.device_time_total > 0),
                  key=lambda r: -r[1])
    print(f"== {what}: {ms:.3f} ms a call; device time of its kernels "
          f"{sum(r[1] for r in rows) / 1e3:.3f} ms")
    for key, us, count in rows[:8]:
        print(f"   {us / 1e3:8.3f} ms  x{count:5.1f}  {key[:88]}")


def path_calls(dev):
    """``{(dims, n): (spec, x, g, flat, count)}`` of the K2 calls of one
    stage-1 step at step 0 (plain) and one at step 25000 with ``fused_mlp``:
    the first call of each chain and row count kept with its inputs."""
    from nunerf_tpu_torch.bench import BENCH_CFG, synthetic_batch
    from nunerf_tpu_torch.models.stage1 import ShapeRenderer
    from nunerf_tpu_torch.train.trainer import TrainStep

    calls, orig = {}, fm.chain_bwd_cuda

    def record(spec, x, g, flat, keep=None):
        key = (spec.dims, x.shape[0])
        if key in calls:
            calls[key][-1] += 1
        else:
            calls[key] = [spec, x.detach().clone(), g.detach().clone(),
                          [f.detach().clone() for f in flat], 1]
        return orig(spec, x, g, flat, keep)

    fm.chain_bwd_cuda = record
    try:
        for step, gate in ((0, None), (25000, "fused_mlp")):
            cfg = dict(BENCH_CFG, **({gate: True} if gate else {}))
            train = TrainStep(ShapeRenderer(cfg, device=dev, seed=0), 5e-4)
            train(synthetic_batch(cfg["train_ray_num"], dev), step)
            torch.cuda.synchronize()
            print(f"step {step} gate {gate}: K2 calls so far "
                  f"{sum(c[-1] for c in calls.values())}")
    finally:
        fm.chain_bwd_cuda = orig
    return calls


def build_variants(variants):
    """{name: library path} of the builds of ``variants`` ({name: -D flags})."""
    src = os.path.join(cuda_build.CSRC_DIR, "fused_mlp.cu")
    out_dir = os.path.join(cuda_build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    flags = [a for a in cuda_build.NVCC_FLAGS if a not in ("-Xptxas", "-v")]
    procs, libs = {}, {}
    for i, (name, defs) in enumerate(variants.items()):
        libs[name] = os.path.join(out_dir, f"variant_{i}.so")
        procs[name] = subprocess.Popen(
            [cuda_build.find_nvcc(), *defs, *flags, "-o", libs[name], src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name!r}:\n{out[-3000:]}")
    return libs


def split_checks(cases, dev):
    """The two checks of K2's split on the library loaded now: per case, the
    data pass's (dx error, gz units); per probe, its units."""
    out = []
    for what, spec, x, g, flat in cases:
        kept = {}
        dx, _ = fm.chain_bwd_cuda(spec, x, g, flat, keep=kept)
        torch.cuda.synchronize()
        dx_err, ulps = fm.data_pass_errors(spec, g, flat, kept, dx)
        out.append(f"{what}: dx {dx_err:.2e}, gz {ulps:.2f} units")
    for k, m in PROBES:
        spec, x, g, flat = fm.split_probe(k, m, 1000, seed=k + m, device=dev)
        dx, _ = fm.chain_bwd_cuda(spec, x, g, flat)
        torch.cuda.synchronize()
        out.append(f"probe {k}->{m}: {fm.split_probe_units(g, flat, dx):.0f} units")
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--split-faults", action="store_true")
    ap.add_argument("--paths", action="store_true")
    ap.add_argument("--n", type=int, default=131072)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("prof_chain_kernels: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    gen = torch.Generator(device="cpu").manual_seed(0)
    n = args.n
    dims, acts, skip, scales = SDF
    val = make_chain(dims + (1,), acts, skip, scales, dev, gen)
    full = make_chain(dims + (257,), acts, skip, scales, dev, gen)
    head = make_chain(*HEAD, dev, gen)
    x = (torch.randn((n, 39), generator=gen) * 0.5).to(dev)
    xh = torch.randn((n, 259), generator=gen).to(dev)
    gy = torch.randn((n, 257), generator=gen).to(dev)
    gj = torch.randn((n, 39), generator=gen).to(dev)
    half = n // 2
    g1 = torch.randn((half, 1), generator=gen).to(dev)
    gh = torch.randn((n, 3), generator=gen).to(dev)
    xhalf = x[:half].contiguous()
    calls = {
        "K1 value": (lambda: fm.chain_fwd_cuda(val[0], x, val[1]), 10),
        "K1 head": (lambda: fm.chain_fwd_cuda(head[0], xh, head[1]), 10),
        "K4": (lambda: fm.chain_jac_fwd_cuda(full[0], x, full[1]), 5),
        "K5": (lambda: fm.chain_jac_bwd_cuda(full[0], x, gy, gj, full[1]), 3),
        f"K2 value, N={half}": (lambda: fm.chain_bwd_cuda(val[0], xhalf, g1, val[1]), 3),
        "K2 head": (lambda: fm.chain_bwd_cuda(head[0], xh, gh, head[1]), 3),
    }
    if args.paths:
        for (dims, rows), (spec, xp, gp, fp, count) in path_calls(dev).items():
            by_kernel(f"K2 {dims} {spec.compute_dtype}, N={rows} (x{count} a step)",
                      lambda: fm.chain_bwd_cuda(spec, xp, gp, fp), 5)
        return 0
    if args.split_faults:
        torch.backends.cuda.matmul.allow_tf32 = False
        wide = make_chain(*WIDE, dev, gen)
        cases = [(f"SDF value N={half}", val[0], xhalf, g1, val[1]),
                 (f"head N={n}", head[0], xh, gh, head[1]),
                 ("512-wide input N=1000", wide[0],
                  torch.randn((1000, 512), generator=gen).to(dev),
                  torch.randn((1000, 64), generator=gen).to(dev), wide[1])]
        for name, lib in build_variants(FAULTS).items():
            cuda_build.load_from("fused_mlp", lib)
            print(f"{name:8s} " + "; ".join(split_checks(cases, dev)), flush=True)
        return 0
    if not args.variants:
        for what, (fn, reps) in calls.items():
            by_kernel(f"{what}, N={n}, bf16" if "N=" not in what else what, fn, reps)
        return 0
    for name, lib in build_variants(VARIANTS).items():
        # the wrappers load the library by name: hand them this build
        cuda_build.load_from("fused_mlp", lib)
        print(f"{name:20s} " + "   ".join(f"{what} {cuda_ms(fn, reps):.3f} ms"
                                           for what, (fn, reps) in calls.items()), flush=True)
        for what in ("K5", f"K2 value, N={half}"):
            by_kernel(f"{name}: {what}", *calls[what])
    return 0


if __name__ == "__main__":
    sys.exit(main())
