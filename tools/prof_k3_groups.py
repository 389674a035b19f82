"""K3 over its two-level index at several group and tile sizes, on one GPU.

    python3 tools/prof_k3_groups.py [--groups 8 16 32] [--tiles 64]
                                    [--resolution 384] [--rays 1024 131072]

Two meshes: ``chip_smoke.py``'s outer mesh (the lumpy sphere marched at
128^3, about 117k triangles), with ``chip_smoke.py``'s rays (a third from
outside, a third from inside, a third pointing away) at each of ``--rays``;
and the same sphere marched at ``--resolution`` (about 1.1 M triangles at
384, the size of ``render-mask``'s raw 512^3 mesh), with the 65,536 rays
through the middle of an 800x800 view from 2.5 units away (the chunk
``render-mask`` launches, in its pixel order).  For each tile and group size
it builds the index and prints the CUDA-event time of a call after warm-up,
the device time by kernel (``torch.profiler``), the flat and the two-level
bounds (``chip_smoke.k3_bound``, ``k3_bound_two_level``) and the pair
counts, and holds ``t``, index and ``hit`` bit-equal to the plain version on
a sample of the rays (exits 1 where they differ).  The card's name and power
limit come first.
"""

import argparse
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (MESH_RESOLUTION, cuda_ms, intersect_rays, k3_bound,  # noqa: E402
                        k3_bound_two_level, k3_device_split, lumpy_sphere_mesh)
from nunerf_tpu_torch.ops import ray_intersect as ri  # noqa: E402
from nunerf_tpu_torch.tracing.intersect import pad_triangles  # noqa: E402


def view_chunk(n, hw=800, dist=2.5, fov=0.6911112070083618):
    """The ``n`` rays through the middle of an ``hw`` x ``hw`` pinhole view
    of the origin from ``dist`` along +z (tilted a little), row by row."""
    focal = 0.5 * hw / np.tan(0.5 * fov)
    pix = np.arange(hw * hw // 2 - n // 2, hw * hw // 2 + n // 2)
    i, j = (pix % hw).astype(np.float32), (pix // hw).astype(np.float32)
    d = np.stack([(i - 0.5 * hw) / focal, -(j - 0.5 * hw) / focal, -np.ones_like(i)], -1)
    c, s = np.cos(0.3), np.sin(0.3)
    rot = np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)
    d = d @ rot.T
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.broadcast_to(rot @ np.array([0, 0, dist], np.float32), d.shape)
    return (np.ascontiguousarray(o, dtype=np.float32), np.ascontiguousarray(d, dtype=np.float32))


def run(label, tri, ro, rd, tiles, groups, n_check):
    rn = ro.shape[0]
    sub = torch.as_tensor(np.random.RandomState(5).choice(rn, min(rn, n_check), replace=False),
                          device=ro.device)
    ref = ri.closest_hit_reference(ro[sub], rd[sub], *tri, tol=ri.BARY_TOL)
    ok = True
    for tile in tiles:
        for group in groups:
            index = ri.build_cull_index(*tri, tile=tile, group=group)
            stats = torch.zeros(2, dtype=torch.int64, device=ro.device)
            got = ri.closest_hit_cuda(ro, rd, index, stats=stats, tol=ri.BARY_TOL)
            torch.cuda.synchronize()
            same = all(torch.equal(a[sub], b) for a, b in zip(got, ref))
            ms = cuda_ms(lambda: ri.closest_hit_cuda(ro, rd, index, tol=ri.BARY_TOL), 20)
            b, by = k3_bound(ri, index, rn, stats)
            b2, by2, tile_tests = k3_bound_two_level(ri, index, ro, rd, stats)
            split = k3_device_split(lambda: ri.closest_hit_cuda(ro, rd, index, tol=ri.BARY_TOL))
            print(f"{label} R={rn} tile={tile} group={group} ({index.box.shape[0]} tiles, "
                  f"{index.gbox.shape[0]} groups): {ms:.4f} ms, device "
                  + ", ".join(f"{k} {v:.4f} ms" for k, v in split.items())
                  + f"; flat bound {b:.4f} ms ({by}), two-level bound {b2:.4f} ms ({by2}); "
                  f"tile tests {tile_tests / rn:.1f} a ray, tiles passed "
                  f"{int(stats[0]) / rn:.2f} a ray, triangles swept {int(stats[1]) / rn:.0f} "
                  f"a ray; bit-equal on {len(sub)} rays: {same}", flush=True)
            ok = ok and same
    return ok


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--groups", type=int, nargs="+", default=[8, 16, 32])
    ap.add_argument("--tiles", type=int, nargs="+", default=[64])
    ap.add_argument("--resolution", type=int, default=384)
    ap.add_argument("--rays", type=int, nargs="+", default=[1024, 131072])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("prof_k3_groups: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    ok = True
    verts, tris = lumpy_sphere_mesh(MESH_RESOLUTION)
    tri = [torch.as_tensor(a, device=dev) for a in pad_triangles(verts, tris, 1024)]
    for rn in args.rays:
        ro, rd, _ = intersect_rays(rn, rn, dev)
        ok = run(f"mesh {len(tris)}", tri, ro, rd, args.tiles, args.groups, 8192) and ok
    verts, tris = lumpy_sphere_mesh(args.resolution)
    tri = [torch.as_tensor(a, device=dev) for a in pad_triangles(verts, tris, 1024)]
    ro, rd = (torch.as_tensor(a, device=dev) for a in view_chunk(65536))
    ok = run(f"mesh {len(tris)}, view chunk", tri, ro, rd, args.tiles, args.groups, 2048) and ok
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
