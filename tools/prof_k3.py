"""K3, the tile-culled closest hit, at several tile sizes, on one GPU.

    python3 tools/prof_k3.py [--tiles 32 64 128] [--rays 1024 131072]

Marches ``chip_smoke.py``'s outer mesh (the lumpy sphere at 128^3, about
117k triangles), builds K3's culling index at each tile size, and for each
ray count (``chip_smoke.py``'s rays: a third from outside, a third from
inside, a third pointing away) prints the CUDA-event time of a call after
warm-up, the (ray, tile) pairs whose box test passed and the ray-triangle
pairs swept (the kernel's counts), the bound of that culled work, the brute
sweep's bound, and the device time of K3's kernels, in all and each
(``torch.profiler``): the wall time of a call at 1024 rays is mostly its
wrapper and launches, so tile sizes are compared by device time.  Every answer is checked against the plain version on
up to 8,192 of the rays.
"""

import argparse
import os
import subprocess
import sys

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (MESH_RESOLUTION, bound_ms, cuda_ms, intersect_rays,  # noqa: E402
                        k3_bound, lumpy_sphere_mesh)
from nunerf_tpu_torch.ops import ray_intersect as ri  # noqa: E402
from nunerf_tpu_torch.tracing.intersect import pad_triangles  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiles", type=int, nargs="+", default=[32, 64, 128])
    ap.add_argument("--rays", type=int, nargs="+", default=[1024, 131072])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("prof_k3: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    verts, tris = lumpy_sphere_mesh(MESH_RESOLUTION)
    tri = [torch.as_tensor(a, device=dev) for a in pad_triangles(verts, tris, 1024)]
    n_tris = len(tris)
    for rn in args.rays:
        ro, rd, _ = intersect_rays(rn, rn, dev)
        sub = torch.as_tensor(np.random.RandomState(5).choice(rn, min(rn, 8192), replace=False),
                              device=dev)
        ref = ri.closest_hit_reference(ro[sub], rd[sub], *tri)
        brute, _ = bound_ms(rn * n_tris * ri.OPS_PER_PAIR, 4 * (6 * rn + 9 * n_tris) + 9 * rn,
                            "float32")
        for tile in args.tiles:
            index = ri.build_cull_index(*tri, tile=tile)
            stats = torch.zeros(2, dtype=torch.int64, device=dev)
            got = ri.closest_hit_cuda(ro, rd, index, stats=stats)
            torch.cuda.synchronize()
            same = all(torch.equal(a[sub], b) for a, b in zip(got, ref))
            ms = cuda_ms(lambda: ri.closest_hit_cuda(ro, rd, index), 20)
            b, by = k3_bound(ri, index, rn, stats)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    ri.closest_hit_cuda(ro, rd, index)
                torch.cuda.synchronize()
            kern = {e.key: e.device_time_total / 5e3 for e in prof.key_averages()
                    if e.key.startswith("k3_") or "k3_" in e.key}
            print(f"R={rn} tile={tile} ({index.box.shape[0]} tiles): {ms:.4f} ms, "
                  f"pairs passed {int(stats[0]) / rn:.1f} a ray, triangles swept "
                  f"{int(stats[1]) / rn:.0f} a ray (brute {n_tris}), culled bound {b:.4f} ms "
                  f"({by}), brute bound {brute:.4f} ms, exact {same}; device time "
                  f"{sum(kern.values()):.4f} ms: "
                  + ", ".join(f"{k.split('(')[0]} {v:.4f} ms" for k, v in kern.items()),
                  flush=True)
            if not same:
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
