"""K3 against the tolerant brute sweep, on one GPU: how many rays disagree.

    python3 tools/k3_tol_counts.py [--rays 1024 131072]

The port's brute sweep (``tracing/intersect.py:ray_mesh_intersect``) accepts
a hit at barycentrics down to -1e-6, as the JAX package's default closest
hit does; K3 has an exact mode (no tolerance, as the Pallas kernel) and a
tolerant one.  On ``chip_smoke.py``'s outer mesh (the lumpy sphere marched at
128^3, about 117k triangles) and rays, and on the adversarial rays of
``tracing/probes.py`` through a box mesh's edges and vertices, this counts,
for each mode the kernel offers: the rays whose ``hit`` differs from the
sweep's, the rays whose index differs where both hit, and of those the ties
(the sweep's own ``t`` for K3's triangle equals the sweep's chosen ``t`` within
rtol 1e-6: a shared edge reached at the same depth).  It also times K3 in each
mode (CUDA events after warm-up).  Prints one JSON line last.
"""

import argparse
import inspect
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import MESH_RESOLUTION, cuda_ms, intersect_rays, lumpy_sphere_mesh  # noqa: E402
from nunerf_tpu_torch.ops import ray_intersect as ri  # noqa: E402
from nunerf_tpu_torch.tracing import intersect as ti  # noqa: E402
from nunerf_tpu_torch.tracing.probes import adversarial_rays, box_mesh  # noqa: E402

CHUNK = 8192  # rays a call of the brute sweep


def modes():
    """{name: keyword arguments of closest_hit_cuda} the kernel offers."""
    if "tol" in inspect.signature(ri.closest_hit_cuda).parameters:
        return {"exact": {"tol": 0.0}, "tolerant": {"tol": 1e-6}}
    return {"exact": {}}


def sweep(ro, rd, v0, e1, e2, tile):
    parts = [ti.ray_mesh_intersect(ro[i:i + CHUNK], rd[i:i + CHUNK], v0, e1, e2, tile=tile)
             for i in range(0, ro.shape[0], CHUNK)]
    return ti.Hit(*(torch.cat(x) for x in zip(*parts)))


def counts(got, ref, ro, rd, v0, e1, e2):
    t, idx, hit = got
    both = hit & ref.hit
    differ = both & (idx != ref.tri_idx)
    # the sweep's own t for K3's triangle, where the indices differ
    i = idx[differ].long()
    t_k = ti._mt_per_ray(ro[differ], rd[differ], v0[i][:, None], e1[i][:, None],
                         e2[i][:, None])[:, 0]
    t_s = ref.t[differ]
    ties = (t_k - t_s).abs() <= 1e-6 * t_s.abs()
    rel = (t - ref.t).abs() / ref.t.abs()
    t_off = both & (rel > 1e-6)
    return {"rays": int(t.shape[0]), "hit_differs": int((hit != ref.hit).sum()),
            "k3_only": int((hit & ~ref.hit).sum()), "sweep_only": int((~hit & ref.hit).sum()),
            "index_differs": int(differ.sum()), "ties": int(ties.sum()),
            "t_off_rtol_1e-6": int(t_off.sum()),
            "t_rel_max": float(rel[both].max()) if bool(both.any()) else 0.0}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rays", type=int, nargs="+", default=[1024, 131072])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k3_tol_counts: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    verts, tris = lumpy_sphere_mesh(MESH_RESOLUTION)
    v0, e1, e2 = (torch.as_tensor(a, device=dev) for a in ti.pad_triangles(verts, tris, 1024))
    index = ri.build_cull_index(v0, e1, e2)
    out = {"card": card, "triangles": len(tris), "mesh": {}, "adversarial": {}, "ms": {}}
    for rn in args.rays:
        ro, rd, _ = intersect_rays(rn, rn, dev)
        ref = sweep(ro, rd, v0, e1, e2, 1024)
        for name, kw in modes().items():
            got = ri.closest_hit_cuda(ro, rd, index, **kw)
            torch.cuda.synchronize()
            c = counts(got, ref, ro, rd, v0, e1, e2)
            out["mesh"][f"{name} R={rn}"] = c
            ms = cuda_ms(lambda: ri.closest_hit_cuda(ro, rd, index, **kw), 20)
            out["ms"][f"{name} R={rn}"] = ms
            print(f"K3 {name} R={rn}: {c}, {ms:.4f} ms", flush=True)
    verts_b, tris_b = box_mesh()
    tv = verts_b[tris_b]
    btri = [torch.as_tensor(a, device=dev)
            for a in (tv[:, 0], tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0])]
    for tile in (8, 32):
        bindex = ri.build_cull_index(*btri, tile=tile)
        o, d = (torch.as_tensor(a, device=dev)
                for a in adversarial_rays(verts_b, bindex.box.cpu().numpy()))
        ref = ti.ray_mesh_intersect(o, d, *btri, tile=len(tris_b))
        for name, kw in modes().items():
            c = counts(ri.closest_hit_cuda(o, d, bindex, **kw), ref, o, d, *btri)
            out["adversarial"][f"{name} tile={tile}"] = c
            print(f"K3 {name} adversarial box, tiles of {tile}: {c}", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
