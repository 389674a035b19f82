"""Metrics: PSNR / SSIM and validation image dumps.

Reference: ``network/metrics.py`` (PSNR :12-18, SSIM :62, composite debug
image dumps :41-131).  SSIM is our own implementation of the standard Wang et
al. windowed SSIM (the reference calls skimage) in numpy.

The port's copy of ``nunerf_tpu/train/metrics.py``: the Gaussian window is
``data/image_io.gaussian_blur`` (float64, as there), and validation images
are written as ``.png`` in place of ``.jpg``, since the port writes PNG
without OpenCV.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from nunerf_tpu_torch.data.image_io import gaussian_blur, imwrite


def compute_psnr(img_gt: np.ndarray, img_pr: np.ndarray) -> float:
    """metrics.py:12-18: images in [0,1] -> psnr on 0-255 scale."""
    img_gt = np.asarray(img_gt, np.float32).reshape(-1, 3) * 255
    img_pr = np.asarray(img_pr, np.float32).reshape(-1, 3) * 255
    mse = np.mean((img_gt - img_pr) ** 2) + 1e-10
    return float(10 * np.log10(255**2 / mse))


def compute_ssim(img_gt: np.ndarray, img_pr: np.ndarray) -> float:
    """Gaussian-windowed SSIM, data_range=1, averaged over channels."""
    img_gt = np.asarray(img_gt, np.float64)
    img_pr = np.asarray(img_pr, np.float64)
    if img_gt.ndim == 2:
        img_gt, img_pr = img_gt[..., None], img_pr[..., None]
    c1, c2 = (0.01) ** 2, (0.03) ** 2
    vals = []
    for c in range(img_gt.shape[-1]):
        x, y = img_gt[..., c], img_pr[..., c]
        mu_x = gaussian_blur(x, 11, 1.5)
        mu_y = gaussian_blur(y, 11, 1.5)
        sxx = gaussian_blur(x * x, 11, 1.5) - mu_x**2
        syy = gaussian_blur(y * y, 11, 1.5) - mu_y**2
        sxy = gaussian_blur(x * y, 11, 1.5) - mu_x * mu_y
        ssim_map = (((2 * mu_x * mu_y + c1) * (2 * sxy + c2))
                    / ((mu_x**2 + mu_y**2 + c1) * (sxx + syy + c2)))
        vals.append(ssim_map.mean())
    return float(np.mean(vals))


def concat_images_list(*imgs: np.ndarray, vert: bool = False) -> np.ndarray:
    """utils/draw_utils.py:187 behavior: concat with padding to max size."""
    imgs = [i if i.ndim == 3 else np.repeat(i[..., None], 3, -1) for i in imgs]
    imgs = [np.clip(i * 255 if i.dtype != np.uint8 else i, 0, 255).astype(np.uint8)
            for i in imgs]
    axis = 0 if vert else 1
    other = 1 if vert else 0
    m = max(i.shape[other] for i in imgs)
    padded = []
    for i in imgs:
        pad = m - i.shape[other]
        if pad > 0:
            pw = [(0, pad) if a == other else (0, 0) for a in range(3)]
            i = np.pad(i, pw)
        padded.append(i)
    return np.concatenate(padded, axis=axis)


def dump_validation_images(outputs: Dict[str, np.ndarray], h: int, w: int,
                           out_dir: str, model_name: str, step: int, index: int):
    """metrics.py:41-131 — composite gt/pred/normal + material channels."""
    os.makedirs(out_dir, exist_ok=True)

    def get(key, ch=3):
        v = np.asarray(outputs[key]).reshape(h, w, -1)
        if v.shape[-1] == 1:
            v = np.repeat(v, 3, -1)
        return np.clip(v, 0, 1)

    rows: List[np.ndarray] = []
    row1 = [get("gt_rgb"), get("ray_rgb")]
    if "normal" in outputs:
        row1.append(get("normal"))
    rows.append(concat_images_list(*row1))
    mat_keys = [k for k in ("diffuse_color", "specular_color", "diffuse_albedo",
                            "diffuse_light", "specular_light", "refraction_light",
                            "transmission_weight", "roughness", "occ_prob")
                if k in outputs]
    if mat_keys:
        rows.append(concat_images_list(*[get(k) for k in mat_keys[:5]]))
    img = concat_images_list(*rows, vert=True)
    path = os.path.join(out_dir, f"{model_name}-step{step}-idx{index}.png")
    imwrite(path, img)
    return path


name2key_metrics = {"psnr": compute_psnr}
