"""Command-line entry points of the port; counterpart of
``nunerf_tpu/cli.py`` (reference ``run_training.py``,
``extract_mesh_stage1.py``, ``extract_mesh_stage2.py``, ``render_mask.py``,
``mask_erosion.py``, ``postprocess_stage2_mesh.py``, ``relight.py``), with
the same fourteen subcommands, arguments, output paths and printed lines:

    python -m nunerf_tpu_torch.cli train --cfg configs/shape/nerf/nested.yaml
    python -m nunerf_tpu_torch.cli extract-mesh-stage1 --cfg ... --resolution 512
    python -m nunerf_tpu_torch.cli extract-mesh-stage2 --cfg ... --resolution 256
    python -m nunerf_tpu_torch.cli render-mask --cfg ... --mesh_path mesh.ply
    python -m nunerf_tpu_torch.cli mask-erosion --cfg ... [--erosion 15]
    python -m nunerf_tpu_torch.cli postprocess-stage2 --input in.ply --outer outer.ply
    python -m nunerf_tpu_torch.cli postprocess-outer --input mesh.ply [--smooth 20]
    python -m nunerf_tpu_torch.cli hull-mesh --input mesh.ply
    python -m nunerf_tpu_torch.cli silhouette-prior --cfg ...
    python -m nunerf_tpu_torch.cli eval-geometry --mesh pred.ply --gt gt.npy
    python -m nunerf_tpu_torch.cli eval-images --cfg ... --split test
    python -m nunerf_tpu_torch.cli render-orbit --cfg ... [--n-views 12 --size 256]
    python -m nunerf_tpu_torch.cli synth-scene --output ./datasets/nested [--colmap --shell]
    python -m nunerf_tpu_torch.cli relight --cfg ... --ckpt model.ckpt --mesh mesh.ply

Every subcommand runs on the card unless it is given ``--device cpu``, and
wraps a library function of the same name.  In the extractions
(``extract_mesh_stage1``, ``extract_mesh_stage2``) the SDF is swept in
chunks of 2^21 points on the device (K1 on the card), the grid is marched by
the native library and the stage-1 mesh is remeshed; ``render_orbit``
renders through ``ShapeRenderer.nvs`` (K1's value-only sweeps on the card).
``render_mask`` and ``postprocess_outer`` trace through ``Scene`` (K3 on the
card).  They read the port's checkpoints and the JAX package's
(``convert.load_jax_checkpoint``).  The port's masks are PNG, not JPEG
(``tools/render_mask.py``).

``train`` and ``eval-images`` run data-parallel when ``torchrun`` started
them: every process joins the group (``nccl``, each on ``cuda:LOCAL_RANK``;
``gloo`` with ``--device cpu``) and renders its share of each ray batch;
rank 0 writes and prints.  On N cards:

    torchrun --nproc_per_node=N -m nunerf_tpu_torch.cli train --cfg ...

With ``NUNERF_LAUNCH_LOG=PATH`` in the environment, a subcommand that
returns writes to PATH the launch counts of this process's kernels
(``fused_mlp.launches``, ``ray_intersect.launches``) and the card's peak
allocated bytes (null on the CPU), as one JSON object: how the leg runner
reads what a ``train`` child ran.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import numpy as np

SWEEP_CHUNK = 2 ** 21
LAUNCH_LOG = "NUNERF_LAUNCH_LOG"


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
    record.  Under a process group every rank renders its share of each
    chunk; rank 0 prints and writes."""
    from nunerf_tpu_torch.convert import load_jax_params
    from nunerf_tpu_torch.data.database import NeRFSyntheticDatabase, get_database_split
    from nunerf_tpu_torch.data.ray_store import build_imgs_info
    from nunerf_tpu_torch.train.metrics import compute_psnr, compute_ssim
    from nunerf_tpu_torch.train.trainer import Trainer

    trainer = Trainer(cfg, device=device)
    say = print if trainer.writes else (lambda *a, **k: None)
    name = cfg["name"]
    ckpt = ckpt or os.path.join("data/model", name, "model_best.ckpt")
    step = 0
    if trainer.mesh.from_rank0(os.path.exists(ckpt)):  # rank 0's file decides
        step, params = trainer.read_checkpoint(ckpt)[:2]
        load_jax_params(trainer.renderer, params, trainer.tree_top)
    else:
        say(f"WARNING: no checkpoint at {ckpt}; evaluating the init")

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
        say(f"view {vid:>6}  psnr {psnr:7.3f}  ssim {ssim:.4f}")
    trainer.logger.close()

    mean_psnr = float(np.mean([r["psnr"] for r in rows]))
    mean_ssim = float(np.mean([r["ssim"] for r in rows]))
    say(f"split '{split}' ({len(rows)} views)  "
        f"mean psnr {mean_psnr:.3f}  mean ssim {mean_ssim:.4f}")
    rec = {"step": int(step), "split": split, "views": rows,
           "mean_psnr": mean_psnr, "mean_ssim": mean_ssim}
    if trainer.writes:
        out_dir = os.path.join("data", "eval", name)
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"eval_{split}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"wrote {path}")
    return rec


def render_mask(cfg, mesh_path, device="cuda"):
    """render_mask.py: a hit mask of the outer mesh for every view of the
    config's database (PNG, under ``<scene>/mask/``).  Returns the
    directory."""
    from nunerf_tpu_torch.tools.render_mask import render_masks

    return render_masks(cfg, mesh_path, device=device)


def mask_erosion(cfg, erosion=15, device="cuda"):
    """mask_erosion.py:29-35: the masks eroded and united with their
    complement (PNG, under ``<scene>/mask_erosion/``).  Returns the
    directory."""
    from nunerf_tpu_torch.tools.render_mask import erode_masks

    return erode_masks(cfg, erosion=erosion, device=device)


def postprocess_outer(input, output=None, views=64, radius=2.0, smooth=0, device="cuda"):
    """Keep the outside-visible surface of a stage-1 mesh
    (``tools/outer_filter.py``), then ``smooth`` Taubin iterations.  Returns
    (output path, stats)."""
    from nunerf_tpu_torch.tools.outer_filter import filter_outer, taubin_smooth
    from nunerf_tpu_torch.tracing.mesh_ops import load_ply, save_ply

    verts, tris = load_ply(input)
    v2, t2, stats = filter_outer(verts, tris, n_views=views, radius=radius, device=device)
    if smooth > 0:
        v2 = taubin_smooth(v2, t2, iters=smooth)
        stats["smooth_iters"] = smooth
    out = output or input.replace(".ply", "_outer.ply")
    save_ply(out, v2, t2)
    print(f"outer filter: {stats} -> {out}")
    return out, stats


def hull_mesh(input, output=None):
    """The convex hull of a mesh's vertices (the bootstrap mask prior).
    Returns (output path, vertices, faces)."""
    from nunerf_tpu_torch.tools.outer_filter import convex_hull_mesh
    from nunerf_tpu_torch.tracing.mesh_ops import load_ply, save_ply

    verts, _ = load_ply(input)
    hv, ht = convex_hull_mesh(verts)
    out = output or input.replace(".ply", "_hull.ply")
    save_ply(out, hv, ht)
    print(f"hull: {len(verts)} verts -> {len(hv)} verts / {len(ht)} faces -> {out}")
    return out, len(hv), len(ht)


def silhouette_prior(cfg, output=None, knn=5, thresh=2.0):
    """The convex hull of the density-filtered COLMAP object cloud, the
    bootstrap silhouette prior of real captures.  Returns (output path,
    vertices, faces)."""
    from nunerf_tpu_torch.data.database import parse_database_name
    from nunerf_tpu_torch.tools.outer_filter import density_filtered_hull
    from nunerf_tpu_torch.tracing.mesh_ops import save_ply

    db = parse_database_name(cfg["database_name"], cfg["dataset_dir"])
    if not hasattr(db, "ref_points"):
        raise SystemExit("silhouette-prior needs a COLMAP-style database "
                         "with an object point cloud")
    hv, ht = density_filtered_hull(db.ref_points, k=knn, thresh=thresh)
    out = output or os.path.join("data/meshes", f"{cfg['name']}_silhouette.ply")
    # guarded: a bare file name has no directory to make (ROADMAP.md 3.4)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    save_ply(out, hv, ht)
    print(f"silhouette prior: {len(db.ref_points)} cloud pts -> hull "
          f"{len(hv)} verts / {len(ht)} faces -> {out}")
    return out, len(hv), len(ht)


def relight(cfg, ckpt, mesh, output="data/materials", device="cuda"):
    """relight.py: per-vertex metallic, roughness and albedo of ``mesh`` from
    the stage-1 SDF's features and the shader's material heads, in chunks
    of 8192 vertices, as ``.npy`` under ``output``.  Returns {name: array}."""
    import torch

    from nunerf_tpu_torch.convert import load_jax_params
    from nunerf_tpu_torch.device import resolve_device
    from nunerf_tpu_torch.models.stage1 import PARAM_KEYS, ShapeRenderer
    from nunerf_tpu_torch.tracing.mesh_ops import load_ply

    dev = resolve_device(device)
    renderer = ShapeRenderer(cfg, device=dev)
    _, params = _checkpoint(cfg, ckpt)
    load_jax_params(renderer, params, PARAM_KEYS)
    verts, _ = load_ply(mesh)
    out = {"metallic": [], "roughness": [], "albedo": []}
    with torch.no_grad():
        for i in range(0, len(verts), 8192):
            chunk = torch.as_tensor(np.asarray(verts[i:i + 8192], np.float32), device=dev)
            feats = renderer.sdf_net(chunk)[:, 1:]
            for k, v in zip(out, renderer.color_net.predict_materials(chunk, feats)):
                out[k].append(v.float().cpu().numpy())
    os.makedirs(output, exist_ok=True)
    arrays = {k: np.concatenate(v, 0) for k, v in out.items()}
    for k, v in arrays.items():
        np.save(os.path.join(output, f"{k}.npy"), v)
    print(f"materials written to {output}")
    return arrays


def opencv_w2c(c2w):
    """The OpenCV world->cam pose [3,4] (``nvs``, ``primary_visibility``) of
    an OpenGL cam->world pose: flip y and z, then invert."""
    c2w = np.asarray(c2w, np.float64)
    R = (c2w[:3, :3] @ np.diag([1.0, -1.0, -1.0])).T
    return np.concatenate([R, (-R @ c2w[:3, 3])[:, None]], -1).astype(np.float32)


def orbit_pose(k, n_views, radius, elevation):
    """The OpenCV world->cam pose [3,4] of view ``k`` of ``n_views`` on a
    circular orbit of ``radius`` at ``elevation``, looking at the origin."""
    from nunerf_tpu_torch.tools.synth_nested import _look_at

    phi = 2 * np.pi * k / n_views
    pos = radius * np.array([np.cos(phi) * np.cos(elevation),
                             np.sin(phi) * np.cos(elevation), np.sin(elevation)])
    return opencv_w2c(_look_at(pos))


def render_orbit(cfg, ckpt=None, output="data/orbit", n_views=12, size=256, radius=2.2,
                 elevation=0.4, fov=0.65, device="cuda"):
    """Headless novel views on a circular orbit (the reference viewer's
    capability, raytracing/renderer.py:195-443, as a batch tool), written as
    ``orbit_<k>.png``.  Returns the images, [n_views, size, size, 3] in
    [0, 1]."""
    from nunerf_tpu_torch.convert import load_jax_params
    from nunerf_tpu_torch.data.image_io import imwrite
    from nunerf_tpu_torch.device import resolve_device
    from nunerf_tpu_torch.models.stage1 import PARAM_KEYS, ShapeRenderer

    dev = resolve_device(device)
    renderer = ShapeRenderer(cfg, device=dev)
    step, params = _checkpoint(
        cfg, ckpt or os.path.join("data/model", cfg["name"], "model_best.ckpt"))
    load_jax_params(renderer, params, PARAM_KEYS)
    h = w = size
    focal = 0.5 * w / np.tan(0.5 * fov)
    K = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]], np.float32)
    os.makedirs(output, exist_ok=True)
    imgs = []
    for k in range(n_views):
        img = renderer.nvs(orbit_pose(k, n_views, radius, elevation), K, h, w, step=step)
        imwrite(os.path.join(output, f"orbit_{k:03d}.png"),
                (np.clip(img, 0, 1) * 255).astype(np.uint8))
        imgs.append(img)
    print(f"wrote {n_views} views to {output}")
    return np.stack(imgs)


def synth_scene(output="./datasets/nested", n_train=48, n_test=8, size=128, shell=False,
                colmap=False):
    """The synthetic nested-glass scene (``tools/synth_nested.py``): the
    Blender layout, or with ``colmap`` the capture layout.  Returns its
    root."""
    from nunerf_tpu_torch.tools.synth_nested import make_colmap_scene, make_nested_scene

    if colmap:
        root = make_colmap_scene(output, n_views=n_train, shell=shell)
    else:
        root = make_nested_scene(output, n_train=n_train, n_test=n_test, h=size, w=size,
                                 shell=shell)
    print(f"wrote nested-glass scene to {root}")
    return root


# ---------------------------------------------------------------------------
# subcommands
# ---------------------------------------------------------------------------

def _load(args):
    from nunerf_tpu_torch.config import load_cfg
    return load_cfg(args.cfg)


def _steps(text):
    """'2500,5000' -> [2500, 5000]; '' -> []."""
    return [int(s) for s in (text or "").split(",") if s.strip()]


@contextlib.contextmanager
def _torchrun_group(device):
    """This process's device; inside ``torchrun``, after joining its group
    (left again on exit): ``nccl`` on ``cuda:LOCAL_RANK``, ``gloo`` on the
    CPU."""
    from nunerf_tpu_torch.parallel.multihost import (init_multihost,
                                                     launched_by_torchrun,
                                                     local_device)

    if not launched_by_torchrun():
        yield device
        return
    import torch.distributed as dist

    dev = local_device(device)
    init_multihost(backend="nccl" if dev.type == "cuda" else "gloo")
    try:
        yield dev
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def cmd_train(args):
    from nunerf_tpu_torch.train.trainer import Trainer

    # zero_thickness selects the renderer (run_training.py:16-20); both
    # stages share one Trainer
    with _torchrun_group(args.device) as device:
        trainer = Trainer(_load(args), device=device, keep=_steps(args.keep))
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
    with _torchrun_group(args.device) as device:
        return eval_images(_load(args), args.ckpt, args.split, device)


def cmd_render_mask(args):
    return render_mask(_load(args), args.mesh_path, args.device)


def cmd_mask_erosion(args):
    return mask_erosion(_load(args), args.erosion, args.device)


def cmd_postprocess_outer(args):
    return postprocess_outer(args.input, args.output, args.views, args.radius, args.smooth,
                             args.device)


def cmd_hull_mesh(args):
    return hull_mesh(args.input, args.output)


def cmd_silhouette_prior(args):
    return silhouette_prior(_load(args), args.output, args.knn, args.thresh)


def cmd_relight(args):
    return relight(_load(args), args.ckpt, args.mesh, args.output, args.device)


def cmd_render_orbit(args):
    return render_orbit(_load(args), args.ckpt, args.output, args.n_views, args.size,
                        args.radius, args.elevation, args.fov, args.device)


def cmd_synth_scene(args):
    return synth_scene(args.output, args.n_train, args.n_test, args.size, args.shell,
                       args.colmap)


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
    sp.add_argument("--keep", default="",
                    help="steps, comma-separated, at which to also write the parameters "
                         "alone to model_<step>.ckpt.gz")

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

    sp = add("render-mask", cmd_render_mask)
    sp.add_argument("--cfg", required=True)
    sp.add_argument("--mesh_path", required=True)

    sp = add("mask-erosion", cmd_mask_erosion)
    sp.add_argument("--cfg", required=True)
    sp.add_argument("--erosion", type=int, default=15)

    sp = add("hull-mesh", cmd_hull_mesh)
    sp.add_argument("--input", required=True)
    sp.add_argument("--output", default=None)

    sp = add("silhouette-prior", cmd_silhouette_prior)
    sp.add_argument("--cfg", required=True)
    sp.add_argument("--output", default=None)
    sp.add_argument("--knn", type=int, default=5)
    sp.add_argument("--thresh", type=float, default=2.0)

    sp = add("postprocess-outer", cmd_postprocess_outer)
    sp.add_argument("--input", required=True)
    sp.add_argument("--output", default=None)
    sp.add_argument("--views", type=int, default=64)
    sp.add_argument("--radius", type=float, default=2.0)
    sp.add_argument("--smooth", type=int, default=0,
                    help="Taubin smoothing iterations on the filtered mesh")

    sp = add("render-orbit", cmd_render_orbit)
    sp.add_argument("--cfg", required=True)
    sp.add_argument("--ckpt", default=None)
    sp.add_argument("--output", default="data/orbit")
    sp.add_argument("--n-views", type=int, default=12)
    sp.add_argument("--size", type=int, default=256)
    sp.add_argument("--radius", type=float, default=2.2)
    sp.add_argument("--elevation", type=float, default=0.4)
    sp.add_argument("--fov", type=float, default=0.65)

    sp = add("synth-scene", cmd_synth_scene)
    sp.add_argument("--output", default="./datasets/nested")
    sp.add_argument("--n-train", type=int, default=48)
    sp.add_argument("--n-test", type=int, default=8)
    sp.add_argument("--size", type=int, default=128)
    sp.add_argument("--shell", action="store_true",
                    help="hollow-glass (thick shell) variant")
    sp.add_argument("--colmap", action="store_true",
                    help="capture-style layout: COLMAP model + full frames "
                         "+ object point cloud (CustomDatabase, real path)")

    sp = add("relight", cmd_relight)
    sp.add_argument("--cfg", required=True)
    sp.add_argument("--ckpt", required=True)
    sp.add_argument("--mesh", required=True)
    sp.add_argument("--output", default="data/materials")

    args = p.parse_args(argv)
    out = args.fn(args)
    if os.environ.get(LAUNCH_LOG):
        write_launch_log(os.environ[LAUNCH_LOG])
    return out


def write_launch_log(path):
    """This process's kernel launch counts and the card's peak allocated
    bytes (None without CUDA), as JSON to ``path``."""
    import torch

    from nunerf_tpu_torch.ops import fused_mlp as fm
    from nunerf_tpu_torch.ops import ray_intersect as ri

    peak = torch.cuda.max_memory_allocated() if torch.cuda.is_available() else None
    with open(path, "w") as f:
        json.dump({"launches": dict(fm.launches, **ri.launches),
                   "max_memory_allocated": peak}, f)


if __name__ == "__main__":
    main()
