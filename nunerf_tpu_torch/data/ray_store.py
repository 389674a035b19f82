"""Ray-batch construction and the host-side ray store.

Covers both camera conventions of the reference:

* NeRO/COLMAP convention (``network/renderer.py:216-237,364-382``): database
  poses are world->cam ``[R|t]``; pixel dirs via ``K^-1 @ [x+.5, y+.5, 1]``;
  near/far from the unit-sphere intersection; per-ray "human poses" (a camera
  frame with flattened z used by the human_light shader term,
  ``renderer.py:346-362``).
* NeRF/blender convention (``renderer.py:239-271,384-391``): database poses
  are cam->world OpenGL ``[R|t]``; dirs ``[(i-cx)/fx, -(j-cy)/fy, -1]``;
  fixed near/far ``[0.8, 4.5]``.

Unlike the reference (which shuffles one giant precomputed tensor on host and
slices + H2D-copies every step, ``renderer.py:210-214,467-470``), the batch
dict built here is uploaded to device once; per-step selection happens on the
device (see ``train/trainer.py``).

The port's copy of ``nunerf_tpu/data/ray_store.py`` (numpy, on the host).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from nunerf_tpu_torch.data.database import BaseDatabase


def color_map_forward(img: np.ndarray) -> np.ndarray:
    """uint8 [0,255] -> float32 [0,1] (utils/base_utils.py:497-505)."""
    if img.dtype == np.uint8:
        return img.astype(np.float32) / 255.0
    if img.dtype == np.uint16:
        return img.astype(np.float32) / 65535.0
    return img.astype(np.float32)


def build_imgs_info(database: BaseDatabase, img_ids, with_mask: bool = True
                    ) -> Dict[str, np.ndarray]:
    """Stack images/Ks/poses (+masks) for a list of views
    (reference ``network/renderer.py:24-57``), channels-last float32."""
    imgs = np.stack([color_map_forward(np.asarray(database.get_image(i)))
                     for i in img_ids], 0)[..., :3]
    Ks = np.stack([np.asarray(database.get_K(i), np.float32)
                   for i in img_ids], 0)
    poses = np.stack([np.asarray(database.get_pose(i), np.float32)
                      for i in img_ids], 0)
    info = {"imgs": imgs.astype(np.float32), "Ks": Ks, "poses": poses}
    if with_mask:
        h, w = imgs.shape[1:3]
        masks = []
        for i in img_ids:
            m = database.get_mask(i)
            if m is None:
                m = np.ones((h, w), np.float32)
            m = np.asarray(m, np.float32)
            if m.ndim == 3:
                m = m[..., 0]
            masks.append(m)
        info["masks"] = np.stack(masks, 0).astype(np.float32)
    return info


def near_far_from_sphere(rays_o: np.ndarray, rays_d: np.ndarray
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """renderer.py:337-344: [mid-1, mid+1] around the closest approach to the
    origin (rays_d unit-norm), near clamped to 1e-3."""
    a = np.sum(rays_d ** 2, -1, keepdims=True)
    b = 2.0 * np.sum(rays_o * rays_d, -1, keepdims=True)
    mid = 0.5 * (-b) / a
    near = np.maximum(mid - 1.0, 1e-3)
    far = mid + 1.0
    return near.astype(np.float32), far.astype(np.float32)


def get_human_coordinate_poses(poses: np.ndarray, fixed_camera: bool = False
                               ) -> np.ndarray:
    """renderer.py:346-362: per-view world->"human" frame whose y points down
    gravity and whose z is the camera forward flattened to the ground plane."""
    pn = poses.shape[0]
    R, t = poses[:, :, :3], poses[:, :, 3:]
    cam_cen = (-np.transpose(R, (0, 2, 1)) @ t)[..., 0]  # pn,3
    if not fixed_camera:
        cam_cen = cam_cen.copy()
        cam_cen[..., 2] = 0
    Y = np.zeros((pn, 3), np.float32)
    Y[:, 2] = -1.0
    Z = poses[:, 2, :3].copy()
    Z[:, 2] = 0
    Z = Z / np.maximum(np.linalg.norm(Z, axis=-1, keepdims=True), 1e-8)
    X = np.cross(Y, Z)
    Rh = np.stack([X, Y, Z], 1)  # pn,3,3
    th = -Rh @ cam_cen[:, :, None]
    return np.concatenate([Rh, th], -1).astype(np.float32)


def construct_ray_batch(info: Dict[str, np.ndarray],
                        fixed_camera: bool = False
                        ) -> Tuple[Dict[str, np.ndarray], int, int]:
    """NeRO-convention full ray batch (renderer.py:216-237 + :364-382).

    Returns ({rays_o, rays_d, near, far, rgbs, human_poses[, masks]}, h, w)
    with rn = imn*h*w rows, everything float32.
    """
    imgs, Ks, poses = info["imgs"], info["Ks"], info["poses"]
    imn, h, w = imgs.shape[:3]
    x, y = np.meshgrid(np.arange(w, dtype=np.float32),
                       np.arange(h, dtype=np.float32))
    coords = np.stack([x + 0.5, y + 0.5, np.ones_like(x)], -1).reshape(-1, 3)

    K_inv = np.linalg.inv(Ks)  # imn,3,3
    dirs = np.einsum("nij,pj->npi", K_inv, coords)  # imn,hw,3 (cam frame)
    R = poses[:, :, :3]
    rays_d = np.einsum("nji,npj->npi", R, dirs)  # R^T @ d -> world
    rays_o = (-np.transpose(R, (0, 2, 1)) @ poses[:, :, 3:])[..., 0]  # imn,3
    rays_o = np.broadcast_to(rays_o[:, None, :], rays_d.shape)
    rays_d = rays_d / np.maximum(
        np.linalg.norm(rays_d, axis=-1, keepdims=True), 1e-8)

    rn = imn * h * w
    rays_o = rays_o.reshape(rn, 3).astype(np.float32)
    rays_d = rays_d.reshape(rn, 3).astype(np.float32)
    near, far = near_far_from_sphere(rays_o, rays_d)
    human = get_human_coordinate_poses(poses, fixed_camera)  # imn,3,4
    human = np.repeat(human, h * w, axis=0)

    batch = {
        "rays_o": rays_o,
        "rays_d": rays_d,
        "near": near,
        "far": far,
        "rgbs": imgs.reshape(rn, 3).astype(np.float32),
        "human_poses": human,
    }
    if "masks" in info:
        batch["masks"] = info["masks"].reshape(rn).astype(np.float32)
    return batch, h, w


def construct_nerf_ray_batch(info: Dict[str, np.ndarray],
                             near: float = 0.8, far: float = 4.5
                             ) -> Tuple[Dict[str, np.ndarray], int, int]:
    """Blender-convention full ray batch (renderer.py:239-271 + :384-391):
    poses are cam->world OpenGL [R|t]; fixed near/far."""
    imgs, Ks, poses = info["imgs"], info["Ks"], info["poses"]
    imn, h, w = imgs.shape[:3]
    K = Ks[0]
    x, y = np.meshgrid(np.arange(w, dtype=np.float32),
                       np.arange(h, dtype=np.float32))
    dirs = np.stack([(x - K[0, 2]) / K[0, 0], -(y - K[1, 2]) / K[1, 1],
                     -np.ones_like(x)], -1).reshape(-1, 3)  # hw,3

    R = poses[:, :3, :3]
    rays_d = np.einsum("nij,pj->npi", R, dirs)  # c2w rotation
    rays_d = rays_d / np.maximum(
        np.linalg.norm(rays_d, axis=-1, keepdims=True), 1e-8)
    rays_o = np.broadcast_to(poses[:, None, :3, 3], rays_d.shape)

    rn = imn * h * w
    batch = {
        "rays_o": rays_o.reshape(rn, 3).astype(np.float32),
        "rays_d": rays_d.reshape(rn, 3).astype(np.float32),
        "near": np.full((rn, 1), near, np.float32),
        "far": np.full((rn, 1), far, np.float32),
        "rgbs": imgs.reshape(rn, 3).astype(np.float32),
        "human_poses": np.repeat(poses.astype(np.float32), h * w, axis=0),
    }
    if "masks" in info:
        batch["masks"] = info["masks"].reshape(rn).astype(np.float32)
    return batch, h, w


class RayStore:
    """Epoch-shuffled host-side ray batches (the reference's
    ``_shuffle_train_batch`` + per-step slice, renderer.py:210-214,465-470).

    The trainer selects batches on the device instead; this class backs
    host-side loops (tests, debugging).
    """

    def __init__(self, batch: Dict[str, np.ndarray], ray_num: int,
                 seed: int = 0):
        self.batch = {k: np.asarray(v) for k, v in batch.items()}
        self.rn = next(iter(self.batch.values())).shape[0]
        self.ray_num = int(ray_num)
        self.rng = np.random.RandomState(seed)
        self._shuffle()

    def _shuffle(self):
        self.order = self.rng.permutation(self.rn)
        self.i = 0

    def next_batch(self) -> Dict[str, np.ndarray]:
        if self.i + self.ray_num > self.rn:
            self._shuffle()
        idx = self.order[self.i:self.i + self.ray_num]
        self.i += self.ray_num
        return {k: v[idx] for k, v in self.batch.items()}
