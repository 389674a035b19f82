"""The port's native mesh operations against their numpy versions: what a
user of the numpy versions would get instead.

    python3 tools/mesh_ops_counts.py [--resolutions 64 128]

The native library (``nunerf_tpu_torch/native/meshops.cpp``) is the JAX
package's default, and the port's default since it has its copy; the numpy
versions (``native=False``) cluster the remesh on another grid
(``round(v / cell)`` against ``floor((v - min_corner) / cell)`` in
first-seen order) and sum the curvature in f64 against f32.  On
``chip_smoke.py``'s lumpy sphere at each resolution this prints: whether the
two extractions are bit-equal, and their host seconds; the remesh's vertex
and triangle counts of each; on the marched mesh and on the native remesh,
the vertices whose curvature differs by more than 1e-3 and by more than 1,
those whose sign differs, and those whose sign differs after the 10 and 20
smoothing iterations that the stage-2 scenes apply.  Host (CPU) only; one
JSON line last.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from nunerf_tpu_torch.tracing import mesh_ops as pm  # noqa: E402


def lumpy(p):
    r = np.linalg.norm(p, axis=-1)
    return r - (0.5 + 0.05 * np.sin(7 * p[..., 0]) * np.cos(7 * p[..., 1]))


def curvature_counts(verts, tris):
    _, cn = pm.vertex_normals_curvature(verts, tris)
    _, cp = pm.vertex_normals_curvature(verts, tris, native=False)
    d = np.abs(cn - cp)
    out = {"vertices": len(verts), "differ_1e-3": int((d > 1e-3).sum()),
           "differ_1": int((d > 1).sum()), "max_diff": float(d.max()),
           "sign_differs": int((np.sign(cn) != np.sign(cp)).sum())}
    for it in (10, 20):
        sn = pm.smooth_vertex_scalar(cn, tris, it)
        sp = pm.smooth_vertex_scalar(cp, tris, it)
        out[f"sign_differs_smoothed_{it}"] = int((np.sign(sn) != np.sign(sp)).sum())
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--resolutions", type=int, nargs="+", default=[64, 128])
    args = ap.parse_args()
    pm.extract_geometry(lumpy, resolution=8)  # builds the library first
    rows = []
    for res in args.resolutions:
        t0 = time.perf_counter()
        vn, tn = pm.extract_geometry(lumpy, resolution=res)
        t_native = time.perf_counter() - t0
        t0 = time.perf_counter()
        vp, tp = pm.extract_geometry(lumpy, resolution=res, native=False)
        t_numpy = time.perf_counter() - t0
        rn_v, rn_t = pm.isotropic_remesh(vn, tn)
        rp_v, rp_t = pm.isotropic_remesh(vn, tn, native=False)
        row = {"resolution": res, "verts": len(vn), "tris": len(tn),
               "extraction_bit_equal": bool(np.array_equal(vn, vp) and np.array_equal(tn, tp)),
               "extract_native_s": t_native, "extract_numpy_s": t_numpy,
               "remesh_native": [len(rn_v), len(rn_t)], "remesh_numpy": [len(rp_v), len(rp_t)],
               "curvature_marched": curvature_counts(vn, tn),
               "curvature_remeshed": curvature_counts(rn_v, rn_t)}
        rows.append(row)
        print(f"{res}^3: {len(vn)} verts / {len(tn)} tris, extraction bit-equal "
              f"{row['extraction_bit_equal']} ({t_native:.2f} s native, {t_numpy:.2f} s "
              f"numpy); remesh native {row['remesh_native']}, numpy {row['remesh_numpy']}; "
              f"curvature, marched {row['curvature_marched']}; remeshed "
              f"{row['curvature_remeshed']}", flush=True)
    print(json.dumps({"host": "cpu", "rows": rows}))


if __name__ == "__main__":
    main()
