"""Command-line entry points of the port; counterpart of
``nunerf_tpu/cli.py`` (reference ``run_training.py``,
``extract_mesh_stage1.py``, ``extract_mesh_stage2.py``,
``postprocess_stage2_mesh.py``), with the same arguments, output paths and
printed lines:

    python -m nunerf_tpu_torch.cli train --cfg configs/shape/nerf/nested.yaml
    python -m nunerf_tpu_torch.cli extract-mesh-stage1 --cfg ... --resolution 512
    python -m nunerf_tpu_torch.cli extract-mesh-stage2 --cfg ... --resolution 256
    python -m nunerf_tpu_torch.cli postprocess-stage2 --input in.ply --outer outer.ply
    python -m nunerf_tpu_torch.cli eval-geometry --mesh pred.ply --gt gt.npy
    python -m nunerf_tpu_torch.cli eval-images --cfg ... --split test

Every subcommand runs on the card unless it is given ``--device cpu``, and
wraps a library function of the same name.  In the extractions
(``extract_mesh_stage1``, ``extract_mesh_stage2``) the SDF is swept in
chunks of 2^21 points on the device (K1 on the card), the grid is marched by
the native library and the stage-1 mesh is remeshed.  They read the port's
checkpoints and the JAX package's (``convert.load_jax_checkpoint``).

Not ported yet (ROADMAP.md section 1, items 6-7): ``render-mask``,
``mask-erosion``, ``postprocess-outer``, ``hull-mesh``, ``silhouette-prior``,
``render-orbit``, ``synth-scene``, ``relight``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

SWEEP_CHUNK = 2 ** 21


def _checkpoint(cfg, ckpt):
    """(step, params) of ``ckpt``, by default the run's last checkpoint."""
    from nunerf_tpu_torch.convert import load_jax_checkpoint

    path = ckpt or os.path.join("data/model", cfg["name"], "model.ckpt")
    step, params, _ = load_jax_checkpoint(path)
    return step, params


def _extract(fn, dev, resolution):
    """The mesh of ``fn``'s zero level set on a ``resolution``^3 grid, with
    ``fn`` evaluated on the device in chunks of ``SWEEP_CHUNK`` points, and
    the seconds of each part of ``extract_geometry``."""
    import torch

    from nunerf_tpu_torch.tracing.mesh_ops import extract_geometry

    def query(pts):
        out = np.empty(len(pts), np.float32)
        with torch.no_grad():
            for i in range(0, len(pts), SWEEP_CHUNK):
                p = torch.as_tensor(np.ascontiguousarray(pts[i:i + SWEEP_CHUNK]),
                                    device=dev)
                out[i:i + SWEEP_CHUNK] = fn(p).float().cpu().numpy()
        return out

    times = {}
    verts, tris = extract_geometry(query, resolution=resolution, bound=1.0,
                                   threshold=0.0, outside_val=1.0, times=times)
    return verts, tris, times


def extract_mesh_stage1(cfg, ckpt=None, resolution=1024, tag=None, device="cuda"):
    """extract_mesh_stage1.py:15-59: the stage-1 SDF marched on a
    ``resolution``^3 grid, written as ``data/meshes/{name}-{step}[_tag].ply``
    with its remeshed ``..._simplified.ply``.  The SDF is
    ``ShapeRenderer.sdf``: K1 on the card unless ``cfg`` sets
    ``fused_sdf_value`` false.  Returns the paths, the triangle counts and
    the seconds of each part."""
    from nunerf_tpu_torch.convert import load_jax_params
    from nunerf_tpu_torch.device import resolve_device
    from nunerf_tpu_torch.models.stage1 import PARAM_KEYS, ShapeRenderer
    from nunerf_tpu_torch.tracing.mesh_ops import isotropic_remesh, save_ply

    dev = resolve_device(device)
    renderer = ShapeRenderer(cfg, device=dev)
    step, params = _checkpoint(cfg, ckpt)
    load_jax_params(renderer, params, PARAM_KEYS)
    verts, tris, times = _extract(lambda p: renderer.sdf(p)[..., 0], dev, resolution)
    os.makedirs("data/meshes", exist_ok=True)
    tag = f"_{tag}" if tag else ""
    out = f"data/meshes/{cfg['name']}-{step}{tag}.ply"
    simplified = f"data/meshes/{cfg['name']}-{step}{tag}_simplified.ply"
    # The reference flips faces before export (extract_mesh_stage1.py:44)
    # because PyMCubes winds them inward; the marching-tetrahedra extraction
    # already winds them outward, which the stage-2 refraction relies on.
    t0 = time.perf_counter()
    save_ply(out, verts, tris)
    times["write_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    verts_s, tris_s = isotropic_remesh(verts, tris)
    times["remesh_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    save_ply(simplified, verts_s, tris_s)
    times["write_s"] += time.perf_counter() - t0
    print(f"wrote {out} ({verts.shape[0]} verts) + simplified")
    return dict(mesh=out, simplified=simplified, step=step, verts=len(verts),
                tris=len(tris), tris_simplified=len(tris_s), **times)


def extract_mesh_stage2(cfg, ckpt=None, resolution=256, device="cuda"):
    """extract_mesh_stage2.py:39-58: the inner SDF where the frozen outer
    SDF is negative, written as ``data/meshes/{name}-{step}-inner.ply``.
    Both SDFs go through K1 on the card.  Returns the path, the counts and
    the seconds of each part."""
    import torch

    from nunerf_tpu_torch.convert import load_jax_params
    from nunerf_tpu_torch.device import resolve_device
    from nunerf_tpu_torch.models import build_renderer
    from nunerf_tpu_torch.models.stage2 import tree_keys
    from nunerf_tpu_torch.tracing.mesh_ops import save_ply

    dev = resolve_device(device)
    renderer = build_renderer(cfg, device=dev)  # zero-thickness or shell
    step, params = _checkpoint(cfg, ckpt)
    load_jax_params(renderer, params, tree_keys())

    def inner_in_outer(p):
        inner = renderer.inner_sdf_value(p)[..., 0].float()
        outer = renderer.stage1_sdf(p)[..., 0].float()
        return torch.where(outer < 0, inner, torch.ones_like(inner))

    verts, tris, times = _extract(inner_in_outer, dev, resolution)
    os.makedirs("data/meshes", exist_ok=True)
    out = f"data/meshes/{cfg['name']}-{step}-inner.ply"
    t0 = time.perf_counter()
    save_ply(out, verts, tris)  # extraction winds outward (see stage 1)
    times["write_s"] = time.perf_counter() - t0
    print(f"wrote {out} ({verts.shape[0]} verts)")
    return dict(mesh=out, step=step, verts=len(verts), tris=len(tris), **times)


def largest_component(n_verts, tris):
    """The faces of the largest face-connected component (faces sharing a
    vertex are connected); no faces in, no faces out."""
    if len(tris) == 0:
        return tris
    import scipy.sparse as sp
    import scipy.sparse.csgraph as csg

    f = np.arange(len(tris))
    rows = np.concatenate([tris[:, 0], tris[:, 1], tris[:, 2]])
    cols = np.concatenate([f, f, f])
    m = sp.coo_matrix((np.ones(len(rows), np.int8), (rows, cols)),
                      shape=(n_verts, len(tris)))
    _, labels = csg.connected_components((m.T @ m) > 0, directed=False)
    return tris[labels == np.bincount(labels).argmax()]


def postprocess_stage2(input, outer, output=None, threshold=0.055,
                       largest=False, device="cuda"):
    """postprocess_stage2_mesh.py:9-26: drop the inner faces within
    ``threshold`` of the outer mesh; ``largest`` then keeps the largest
    face-connected component (drops the thin fog shells a hardening floor
    leaves).  Returns (output path, faces kept)."""
    from nunerf_tpu_torch.tracing.mesh_ops import load_ply, save_ply
    from nunerf_tpu_torch.tracing.scene import Scene

    verts, tris = load_ply(input)
    scene = Scene(outer, device=device)
    d = scene.unsigned_distance(verts[tris].mean(1))
    keep = d > threshold
    tris = tris[keep]
    n_dist = len(tris)
    if largest:
        # guarded: the JAX command fails on zero kept faces (ROADMAP.md 3.4)
        tris = largest_component(len(verts), tris)
    path = output or input.replace(".ply", "_post.ply")
    save_ply(path, verts, tris)
    print(f"kept {len(tris)}/{len(keep)} faces"
          + (f" (distance filter: {n_dist})" if largest else ""))
    return path, len(tris)


def sample_surface(path, n):
    """``n`` points of a ``.ply`` surface by area, or of a ``.npy`` point
    set, from seed 0 (the JAX ``eval-geometry``'s draw)."""
    from nunerf_tpu_torch.tracing.mesh_ops import load_ply

    if path.endswith(".npy"):
        pts = np.load(path).astype(np.float32)
        rs = np.random.RandomState(0)
        return pts[rs.choice(len(pts), min(n, len(pts)), replace=False)]
    verts, tris = load_ply(path)
    if len(tris) == 0:
        return np.zeros((0, 3), np.float32)
    v0, v1, v2 = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]
    area = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=-1)
    p = area / max(area.sum(), 1e-12)
    rs = np.random.RandomState(0)
    fi = rs.choice(len(tris), n, p=p)
    u, v = rs.rand(n, 1), rs.rand(n, 1)
    flip = (u + v) > 1
    u = np.where(flip, 1 - u, u)
    v = np.where(flip, 1 - v, v)
    return v0[fi] + u * (v1[fi] - v0[fi]) + v * (v2[fi] - v0[fi])


def eval_geometry(mesh, gt, n_samples=100000, device="cuda"):
    """The symmetric chamfer between two surfaces; the printed JSON as a
    dict."""
    from nunerf_tpu_torch.ops.chamfer import chamfer_distance

    a = sample_surface(mesh, n_samples)
    b = sample_surface(gt, n_samples)
    if len(a) == 0 or len(b) == 0:
        # an empty mesh (postprocess dropped every face) is a result
        rec = {"chamfer": None, "pred_to_gt": None, "gt_to_pred": None,
               "error": f"empty surface: pred={len(a)} gt={len(b)}"}
    else:
        d1, d2 = chamfer_distance(a, b, device=device)
        rec = {"chamfer": float(d1) + float(d2), "pred_to_gt": float(d1),
               "gt_to_pred": float(d2)}
    print(json.dumps(rec))
    return rec


def eval_images(cfg, ckpt=None, split="validation", device="cuda"):
    """Render every view of ``split`` and write a per-view PSNR/SSIM table
    with its means to ``data/eval/{name}/eval_{split}.json`` (reference:
    dataset/database.py:667-679, train/train_valid.py:19-53).  Returns the
    record."""
    from nunerf_tpu_torch.convert import load_jax_params
    from nunerf_tpu_torch.data.database import NeRFSyntheticDatabase, get_database_split
    from nunerf_tpu_torch.data.ray_store import build_imgs_info
    from nunerf_tpu_torch.train.metrics import compute_psnr, compute_ssim
    from nunerf_tpu_torch.train.trainer import Trainer, load_checkpoint

    trainer = Trainer(cfg, device=device)
    name = cfg["name"]
    ckpt = ckpt or os.path.join("data/model", name, "model_best.ckpt")
    step = 0
    if os.path.exists(ckpt):
        step, params, _, _ = load_checkpoint(ckpt)
        load_jax_params(trainer.renderer, params, trainer.tree_top)
    else:
        print(f"WARNING: no checkpoint at {ckpt}; evaluating the init")

    split_db = trainer.database
    if split == "test" and cfg["database_name"].startswith("nerf/"):
        # blender scenes: the training database keeps every testskip-th test
        # frame; the full evaluation reloads the test frames with no skip
        split_db = NeRFSyntheticDatabase(cfg["database_name"],
                                         cfg.get("dataset_dir", "./datasets"), testskip=1)
        _, test_ids = split_db.train_test_split()
    else:
        _, test_ids = get_database_split(split_db, split)
    rows = []
    for vid in test_ids:
        info = build_imgs_info(split_db, [vid], with_mask=True)
        outputs, h, w = trainer.render_image(info, step)
        gt, pr = outputs["gt_rgb"], outputs["ray_rgb"]
        if "tir_mask" in outputs:
            # stage 2 scores TIR-masked pixels out of both images
            # (reference test_step, renderer_zerothick.py:1248-1250)
            tm = outputs["tir_mask"].reshape(-1, 1)
            gt, pr = gt * tm, pr * tm
        psnr = float(compute_psnr(gt, pr))
        ssim = float(compute_ssim(gt.reshape(h, w, 3), pr.reshape(h, w, 3)))
        rows.append({"view": str(vid), "psnr": psnr, "ssim": ssim})
        print(f"view {vid:>6}  psnr {psnr:7.3f}  ssim {ssim:.4f}")
    trainer.logger.close()

    mean_psnr = float(np.mean([r["psnr"] for r in rows]))
    mean_ssim = float(np.mean([r["ssim"] for r in rows]))
    print(f"split '{split}' ({len(rows)} views)  "
          f"mean psnr {mean_psnr:.3f}  mean ssim {mean_ssim:.4f}")
    out_dir = os.path.join("data", "eval", name)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"eval_{split}.json")
    rec = {"step": int(step), "split": split, "views": rows,
           "mean_psnr": mean_psnr, "mean_ssim": mean_ssim}
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"wrote {path}")
    return rec


# ---------------------------------------------------------------------------
# subcommands
# ---------------------------------------------------------------------------

def _load(args):
    from nunerf_tpu_torch.config import load_cfg
    return load_cfg(args.cfg)


def cmd_train(args):
    from nunerf_tpu_torch.train.trainer import Trainer

    # zero_thickness selects the renderer (run_training.py:16-20); both
    # stages share one Trainer
    trainer = Trainer(_load(args), device=args.device)
    best = trainer.run()
    trainer.logger.close()
    return best


def cmd_extract_mesh_stage1(args):
    return extract_mesh_stage1(_load(args), args.ckpt, args.resolution, args.tag,
                               args.device)


def cmd_extract_mesh_stage2(args):
    return extract_mesh_stage2(_load(args), args.ckpt, args.resolution, args.device)


def cmd_postprocess_stage2(args):
    return postprocess_stage2(args.input, args.outer, args.output, args.threshold,
                              args.largest_component, args.device)


def cmd_eval_geometry(args):
    return eval_geometry(args.mesh, args.gt, args.n_samples, args.device)


def cmd_eval_images(args):
    return eval_images(_load(args), args.ckpt, args.split, args.device)


def main(argv=None):
    """Runs one subcommand; returns what its library function returns."""
    p = argparse.ArgumentParser(prog="nunerf_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--device", default="cuda",
                        help="torch device; 'cpu' runs the plain versions")

    def add(name, fn):
        sp = sub.add_parser(name, parents=[common])
        sp.set_defaults(fn=fn)
        return sp

    sp = add("train", cmd_train)
    sp.add_argument("--cfg", required=True)

    sp = add("extract-mesh-stage1", cmd_extract_mesh_stage1)
    sp.add_argument("--cfg", required=True)
    sp.add_argument("--resolution", type=int, default=1024)
    sp.add_argument("--ckpt", default=None)
    sp.add_argument("--tag", default=None,
                    help="suffix for the output mesh name (keeps a res-1024 "
                         "extraction from clobbering the training mesh)")

    sp = add("extract-mesh-stage2", cmd_extract_mesh_stage2)
    sp.add_argument("--cfg", required=True)
    sp.add_argument("--resolution", type=int, default=256)
    sp.add_argument("--ckpt", default=None)

    sp = add("postprocess-stage2", cmd_postprocess_stage2)
    sp.add_argument("--input", required=True)
    sp.add_argument("--outer", required=True)
    sp.add_argument("--output", default=None)
    sp.add_argument("--threshold", type=float, default=0.055)
    sp.add_argument("--largest-component", action="store_true",
                    help="additionally keep only the largest face-connected "
                         "component (drops inv_s-floor fog shells)")

    sp = add("eval-geometry", cmd_eval_geometry)
    sp.add_argument("--mesh", required=True)
    sp.add_argument("--gt", required=True)
    sp.add_argument("--n-samples", type=int, default=100000)

    sp = add("eval-images", cmd_eval_images)
    sp.add_argument("--cfg", required=True)
    sp.add_argument("--ckpt", default=None)
    sp.add_argument("--split", default="validation", choices=["validation", "test"],
                    help="which split to evaluate every view of "
                         "(reference: dataset/database.py:667-679)")

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
