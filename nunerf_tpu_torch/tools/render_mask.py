"""The mask pipeline: a hit mask of the outer mesh for every train view, then
its erosion; counterpart of ``nunerf_tpu/tools/render_mask.py`` (reference
``render_mask.py`` -> ``utils/render_mask_synthetic.py:10-76`` /
``render_mask_real.py``, then ``mask_erosion.py:29-35``).

The masks are PNG (``data/image_io.py``), not the JAX package's JPEG: the
machine with the card has no OpenCV, and PNG keeps a {0, 255} mask exact.
``render_masks`` writes ``<scene>/mask/<image name less its extension>.png``,
``erode_masks`` writes ``<scene>/mask_erosion/<same>.png``, where both
databases look first (``data/database.py`` ``get_mask``).

The hit mask is ``Scene.intersect(...).hit``: K3 on the card.  The erosion
runs on the device as a max-pool of the negated mask (``erode``); its plain
twin is a numpy minimum filter (``erode_reference``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from nunerf_tpu_torch.config import STAGE1_DEFAULTS, merge_cfg
from nunerf_tpu_torch.data import image_io
from nunerf_tpu_torch.data.database import parse_database_name
from nunerf_tpu_torch.data.ray_store import (build_imgs_info, construct_nerf_ray_batch,
                                             construct_ray_batch)
from nunerf_tpu_torch.device import resolve_device
from nunerf_tpu_torch.tracing.scene import Scene

# rays a closest-hit call: K3 takes any number of rays in one launch, so a
# larger chunk saves only wrapper calls (a view of 800x800 in 10 calls or in
# one differs by a tenth of a millisecond on the H100), while the chunk
# bounds the plain versions' temporaries ([chunk, 256] per triangle tile on
# the CPU, [chunk, tiles] in the culled descent)
CHUNK = 65536


def view_rays(db, img_id, is_nerf: bool):
    """(rays_o, rays_d, h, w) of every pixel of one view, numpy f32."""
    info = build_imgs_info(db, [img_id], with_mask=False)
    batch, h, w = construct_nerf_ray_batch(info) if is_nerf else construct_ray_batch(info)
    return batch["rays_o"], batch["rays_d"], h, w


def hit_mask(scene: Scene, rays_o, rays_d, h: int, w: int, chunk: int = CHUNK):
    """{0, 255} uint8 [h, w]: the closest hit of each pixel's ray."""
    o = torch.as_tensor(np.ascontiguousarray(rays_o), device=scene.device)
    d = torch.as_tensor(np.ascontiguousarray(rays_d), device=scene.device)
    hits = [scene.intersect(o[i0:i0 + chunk], d[i0:i0 + chunk]).hit
            for i0 in range(0, h * w, chunk)]
    return (torch.cat(hits).reshape(h, w).to(torch.uint8) * 255).cpu().numpy()


def mask_path(root: str, sub: str, image_name: str) -> str:
    """``root/sub/<image_name less its extension>.png``."""
    rel = os.path.splitext(image_name)[0] + ".png"
    return os.path.normpath(os.path.join(root, sub, rel))


def render_masks(cfg: dict, mesh_path: str, chunk: int = CHUNK, device="cuda"):
    """A hit mask of ``mesh_path`` for every view of the config's database,
    written to ``<scene>/mask/``.  Returns that directory."""
    dev = resolve_device(device)
    cfg = merge_cfg(STAGE1_DEFAULTS, cfg)
    db = parse_database_name(cfg["database_name"], cfg["dataset_dir"])
    scene = Scene(mesh_path, device=dev)
    img_ids = db.get_img_ids()
    out_dir = os.path.join(db.root, "mask")
    os.makedirs(out_dir, exist_ok=True)
    for img_id in img_ids:
        o, d, h, w = view_rays(db, img_id, cfg["is_nerf"])
        out_fp = mask_path(db.root, "mask", db.get_image_name(img_id))
        os.makedirs(os.path.dirname(out_fp), exist_ok=True)
        image_io.imwrite(out_fp, hit_mask(scene, o, d, h, w, chunk))
    print(f"wrote {len(img_ids)} masks to {out_dir}")
    return out_dir


def erode(mask: np.ndarray, erosion: int, device) -> np.ndarray:
    """``cv2.erode(mask, ones((erosion, erosion)))`` (its default anchor and
    border: the window covers ``-(k//2) .. k-1-k//2``, outside pixels never
    win) on ``device``, as the max-pool of the negated mask."""
    m = torch.as_tensor(mask, device=device).to(torch.float32)[None, None]
    k = erosion
    out = -torch.nn.functional.max_pool2d(-m, k, stride=1, padding=k // 2)
    return out[0, 0, :mask.shape[0], :mask.shape[1]].to(torch.uint8).cpu().numpy()


def erode_reference(mask: np.ndarray, erosion: int) -> np.ndarray:
    """The plain twin of ``erode``: a numpy minimum filter over the same
    window, the border padded with the largest value."""
    k = erosion
    big = np.iinfo(mask.dtype).max
    padded = np.pad(mask, ((k // 2, k - 1 - k // 2),) * 2, constant_values=big)
    return np.lib.stride_tricks.sliding_window_view(padded, (k, k)).min(axis=(2, 3))


def eroded_mask(mask: np.ndarray, erosion: int, device) -> np.ndarray:
    """mask_erosion.py:29-35: the eroded interior plus everything the mask
    excluded (the outer boundary ring is dropped)."""
    eroded = erode(mask, erosion, device)
    return np.clip(eroded.astype(np.int32) + (255 - mask.astype(np.int32)),
                   0, 255).astype(np.uint8)


def erode_masks(cfg: dict, erosion: int = 15, device="cuda"):
    """Every PNG mask under ``<scene>/mask/`` eroded into
    ``<scene>/mask_erosion/`` at the same relative path.  Returns that
    directory."""
    dev = resolve_device(device)
    cfg = merge_cfg(STAGE1_DEFAULTS, cfg)
    db = parse_database_name(cfg["database_name"], cfg["dataset_dir"])
    mask_dir = os.path.join(db.root, "mask")
    out_dir = os.path.join(db.root, "mask_erosion")
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for dirpath, _, fnames in os.walk(mask_dir):
        for fname in sorted(fnames):
            if not fname.lower().endswith(".png"):
                continue
            fp = os.path.join(dirpath, fname)
            m = image_io.imread(fp)
            if m.ndim == 3:
                m = m[..., 0]
            out_fp = os.path.join(out_dir, os.path.relpath(fp, mask_dir))
            os.makedirs(os.path.dirname(out_fp), exist_ok=True)
            image_io.imwrite(out_fp, eroded_mask(m, erosion, dev))
            n += 1
    print(f"wrote {n} eroded masks to {out_dir}")
    return out_dir
