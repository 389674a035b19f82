"""Ray synthesis on the device: the per-step ray batch computed from compact
per-image tables; counterpart of ``nunerf_tpu/data/device_rays.py``.

The reference precomputes every ray of every training image as float tensors
and slices per step (``network/renderer.py:204-214,467-470``): at 100
blender views that is 64M rays x 96 B, about 6 GB resident.  Here the device
store is the images (uint8), masks (uint8) and per-image pose/K tables, about
25x smaller; rays are synthesised from the selected flat pixel indices with a
handful of gathers and operations a ray.

``sample_rays(store, idx)`` reproduces ``construct_ray_batch`` /
``construct_nerf_ray_batch`` rows (tests/test_torch_port_data.py).

Differences of form from the JAX package: the store's tensors lie on the
device it was built for, except ``aux`` (is_nerf, near, far), which the host
reads, so that ``sample_rays`` computes only the camera convention it needs
and never waits for the device; indices are int64 (a 100-view 800x800 store
has 64M rays); the 3x3 products are written out as multiplies and sums, so
that they stay in f32 whatever the matmul precision.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from nunerf_tpu_torch.data.ray_store import get_human_coordinate_poses


def build_compact_store(info: Dict[str, np.ndarray], is_nerf: bool,
                        fixed_camera: bool = False, near: float = 0.8,
                        far: float = 4.5, device="cpu") -> Dict[str, torch.Tensor]:
    """Compact tables from ``build_imgs_info`` output, on ``device``.

    Keys: rgbs (imn,h,w,3 u8), masks (imn,h,w u8), poses / human_poses
    (imn,3,4 f32), Ks_inv (imn,3,3 f32), and ``aux`` [is_nerf, near, far]
    (f32, on the host).  Images go over one at a time, so the host holds one
    image's bytes beside ``info``."""
    imgs, Ks, poses = info["imgs"], info["Ks"], info["poses"]
    dev = torch.device(device)

    def to_u8(a):
        out = torch.empty(a.shape, dtype=torch.uint8, device=dev)
        for i in range(a.shape[0]):
            out[i] = torch.as_tensor(np.clip(a[i] * 255.0 + 0.5, 0, 255).astype(np.uint8))
        return out

    if is_nerf:
        # blender poses are already the "human" frame slot
        # (renderer.py:391 returns poses[idxs])
        human = poses.astype(np.float32)
    else:
        human = get_human_coordinate_poses(poses, fixed_camera)
    store = {
        "rgbs": to_u8(imgs),
        "poses": torch.as_tensor(poses.astype(np.float32), device=dev),
        "Ks_inv": torch.as_tensor(np.linalg.inv(Ks).astype(np.float32), device=dev),
        "human_poses": torch.as_tensor(human, device=dev),
        "aux": torch.tensor([float(is_nerf), near, far], dtype=torch.float32),
    }
    if "masks" in info:
        store["masks"] = to_u8(info["masks"])
    return store


def num_rays(store: Dict[str, torch.Tensor]) -> int:
    imn, h, w = store["rgbs"].shape[:3]
    return imn * h * w


def sample_rays(store: Dict[str, torch.Tensor], idx: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
    """The standard ray batch for flat ray indices ``idx`` [R] (row-major
    over image, then y, then x), on the store's device."""
    imn, h, w = store["rgbs"].shape[:3]
    is_nerf, near, far = store["aux"].tolist()
    idx = idx.to(device=store["rgbs"].device, dtype=torch.int64)

    img = idx // (h * w)
    pix = idx % (h * w)
    py = pix // w
    px = pix % w

    rgbs = store["rgbs"][img, py, px].to(torch.float32) / 255.0
    poses = store["poses"][img]  # [R,3,4]
    R_mat, t = poses[:, :, :3], poses[:, :, 3]
    xf = px.to(torch.float32)
    yf = py.to(torch.float32)
    ones = torch.ones_like(xf)

    if is_nerf > 0.5:
        # blender convention (construct_nerf_ray_batch): c2w OpenGL pose; the
        # whole dataset shares K (renderer.py:244)
        K0_inv = store["Ks_inv"][0]
        fx, fy = 1.0 / K0_inv[0, 0], 1.0 / K0_inv[1, 1]
        cx, cy = -K0_inv[0, 2] * fx, -K0_inv[1, 2] * fy
        dirs = torch.stack([(xf - cx) / fx, -(yf - cy) / fy, -ones], -1)
        d = torch.sum(R_mat * dirs[:, None, :], -1)  # R @ d
        d = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-8)
        o = t
        near_t = torch.full_like(xf[:, None], near)
        far_t = torch.full_like(xf[:, None], far)
    else:
        # NeRO convention (construct_ray_batch): w2c pose, +0.5 pixel centers
        coords = torch.stack([xf + 0.5, yf + 0.5, ones], -1)
        dirs = torch.sum(store["Ks_inv"][img] * coords[:, None, :], -1)  # K^-1 @ c
        d = torch.sum(R_mat * dirs[:, :, None], 1)  # R^T @ d
        d = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-8)
        o = -torch.sum(R_mat * t[:, :, None], 1)  # -R^T t
        mid = -torch.sum(o * d, -1, keepdim=True)
        near_t = torch.clamp(mid - 1.0, min=1e-3)
        far_t = mid + 1.0

    batch = {"rays_o": o, "rays_d": d, "near": near_t, "far": far_t,
             "rgbs": rgbs, "human_poses": store["human_poses"][img]}
    if "masks" in store:
        batch["masks"] = store["masks"][img, py, px].to(torch.float32) / 255.0
    return batch
