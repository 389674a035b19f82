"""Databases: posed multi-view image collections, four formats.

Re-implements the capability surface of the reference ``dataset/database.py``
(+ its near-copies ``database_eval.py`` / ``database_formask.py``, unified):

* ``nerf/<scene>`` — blender ``transforms_{train,test}.json`` scenes
  (reference :542-651), testskip=64 on the test frames, cam->world OpenGL
  poses;
* ``syn/<scene>`` — Glossy-synthetic renders: per-view ``<k>-camera.pkl``
  (w2c pose, K), 16-bit depth maps (reference :343-378);
* ``real/<scene>/<maxlen>`` — COLMAP scenes normalized by the object point
  cloud + per-scene up/forward, cropped or resized to ``maxlen``
  (reference :182-341);
* ``custom/<scene>/<maxlen>[_crop]`` — like ``real`` but up/forward from
  ``meta_info.txt`` and masks from ``mask_erosion/`` (reference :380-539).

COLMAP parsing uses this package's own reader (``data/colmap.py``), not the
vendored scripts.

The port's copy of ``nunerf_tpu/data/database.py``.  Images are read,
written, resized and warped by ``data/image_io.py`` in place of ``cv2``, with
the same results (PNG read and written exactly; resampling within one level
of an 8-bit image); JPEG files still need ``cv2``.
"""

from __future__ import annotations

import abc
import glob
import json
import os
import pickle
import random
import struct
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from nunerf_tpu_torch.data import image_io


# ---------------------------------------------------------------------------
# small host-side helpers


def read_pickle(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)


def save_pickle(obj, path: str):
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def resize_img(img: np.ndarray, ratio: float) -> np.ndarray:
    h, w = img.shape[:2]
    return image_io.resize(img, (int(ratio * w), int(ratio * h)),
                           "area" if ratio < 1 else "linear")


def read_ply_points(path: str) -> np.ndarray:
    """Vertex positions from a PLY file (binary-LE or ascii); faces and extra
    vertex properties are ignored."""
    with open(path, "rb") as f:
        header = b""
        while not header.endswith(b"end_header\n"):
            line = f.readline()
            if not line:
                raise ValueError(f"bad ply header in {path}")
            header += line
        lines = header.decode("ascii", "replace").strip().split("\n")
        fmt = [l for l in lines if l.startswith("format")][0].split()[1]
        nv = int([l for l in lines if l.startswith("element vertex")][0]
                 .split()[2])
        # vertex property layout
        props = []
        in_vertex = False
        for l in lines:
            if l.startswith("element vertex"):
                in_vertex = True
            elif l.startswith("element"):
                in_vertex = False
            elif in_vertex and l.startswith("property"):
                parts = l.split()
                props.append((parts[-1], parts[1]))
        type_map = {"float": "<f4", "float32": "<f4", "double": "<f8",
                    "float64": "<f8", "uchar": "u1", "uint8": "u1",
                    "int": "<i4", "int32": "<i4", "uint": "<u4",
                    "short": "<i2", "ushort": "<u2", "char": "i1"}
        if fmt == "ascii":
            rows = [f.readline().split() for _ in range(nv)]
            arr = np.array(rows, np.float64)
            idx = {name: k for k, (name, _) in enumerate(props)}
            return arr[:, [idx["x"], idx["y"], idx["z"]]].astype(np.float32)
        dtype = np.dtype([(name, type_map[t]) for name, t in props])
        data = np.frombuffer(f.read(nv * dtype.itemsize), dtype=dtype)
        return np.stack([data["x"], data["y"], data["z"]],
                        -1).astype(np.float32)


def write_ply_points(path: str, pts: np.ndarray):
    pts = np.asarray(pts, np.float32)
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {len(pts)}\n"
              "property float x\nproperty float y\nproperty float z\n"
              "end_header\n")
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(pts.astype("<f4").tobytes())


# ---------------------------------------------------------------------------


class BaseDatabase(abc.ABC):
    """Abstract posed-image collection (reference dataset/database.py:125-147).

    ``get_pose`` returns a world->cam [3,4] for COLMAP-style databases and a
    cam->world OpenGL [3,4] for the blender database (consumed by
    ``construct_ray_batch`` vs ``construct_nerf_ray_batch`` respectively).
    """

    def __init__(self, database_name: str):
        self.database_name = database_name

    @abc.abstractmethod
    def get_image(self, img_id) -> np.ndarray: ...

    @abc.abstractmethod
    def get_K(self, img_id) -> np.ndarray: ...

    @abc.abstractmethod
    def get_pose(self, img_id) -> np.ndarray: ...

    @abc.abstractmethod
    def get_img_ids(self) -> List[str]: ...

    @abc.abstractmethod
    def get_depth(self, img_id) -> Tuple[np.ndarray, np.ndarray]: ...

    def get_mask(self, img_id) -> Optional[np.ndarray]:
        """Object mask in [0,1], or None when the database has none."""
        return None

    def get_image_name(self, img_id) -> str:
        """Relative image filename (keys the mask pipeline's output files)."""
        return f"{img_id}.png"


# ---------------------------------------------------------------------------
# blender / NeRF-synthetic


class NeRFSyntheticDatabase(BaseDatabase):
    """``transforms_{train,test}.json`` scenes (reference :542-651): all train
    frames + every ``testskip``-th test frame; shared K from camera_angle_x;
    poses are cam->world OpenGL."""

    def __init__(self, database_name: str, dataset_dir: str,
                 testskip: int = 64):
        super().__init__(database_name)
        _, model_name = database_name.split("/")
        self.root = os.path.join(dataset_dir, model_name)

        self.imgs, self.poses, self.image_names = [], [], []
        counts = [0]
        meta = None
        for split in ("train", "test"):
            with open(os.path.join(self.root,
                                   f"transforms_{split}.json")) as f:
                meta = json.load(f)
            skip = 1 if (split == "train" or testskip == 0) else testskip
            for frame in meta["frames"][::skip]:
                rel = frame["file_path"]
                self.imgs.append(image_io.imread(os.path.join(self.root,
                                                      rel + ".png")))
                self.image_names.append(rel + ".png")
                self.poses.append(
                    np.asarray(frame["transform_matrix"], np.float32))
            counts.append(len(self.imgs))
        self.split_counts = counts  # [0, n_train, n_total]
        self.img_ids = [str(k) for k in range(len(self.imgs))]

        h, w = self.imgs[0].shape[:2]
        focal = 0.5 * w / np.tan(0.5 * float(meta["camera_angle_x"]))
        self.K = np.array([[focal, 0, 0.5 * w], [0, focal, 0.5 * h],
                           [0, 0, 1]], np.float32)

    def train_test_split(self) -> Tuple[List[str], List[str]]:
        n_train, n_total = self.split_counts[1], self.split_counts[2]
        return ([str(k) for k in range(n_train)],
                [str(k) for k in range(n_train, n_total)])

    def get_image(self, img_id):
        return self.imgs[int(img_id)][..., :3]

    def get_K(self, img_id):
        return self.K.copy()

    def get_pose(self, img_id):
        return self.poses[int(img_id)][:3, :].copy()

    def get_img_ids(self):
        return list(self.img_ids)

    def get_image_name(self, img_id):
        return self.image_names[int(img_id)]

    def get_mask(self, img_id):
        # prefer the eroded masks written by the mask pipeline
        # (reference :579-583): the port's PNG, then the JAX package's JPEG
        # (read where cv2 is installed); else the alpha channel
        rel = os.path.splitext(self.image_names[int(img_id)])[0]
        for ext in (".png", ".jpg"):
            fp = os.path.join(self.root, "mask_erosion", rel + ext)
            if os.path.exists(fp):
                return image_io.imread(fp).astype(np.float32) / 255.0
        img = self.imgs[int(img_id)]
        if img.shape[-1] == 4:
            return (img[..., 3] > 0).astype(np.float32)
        return None

    def get_depth(self, img_id):
        # no depth for blender scenes; alpha as validity (reference :642-648
        # returns garbage here — depth is unused on this path)
        img = self.imgs[int(img_id)]
        h, w = img.shape[:2]
        mask = ((img[..., 3] > 0) if img.shape[-1] == 4
                else np.ones((h, w), bool))
        return np.zeros((h, w), np.float32), mask.astype(np.float32)


# ---------------------------------------------------------------------------
# Glossy synthetic (NeRO renders)


class GlossySyntheticDatabase(BaseDatabase):
    """Per-view ``<k>-camera.pkl`` = (w2c pose [3,4], K); 16-bit depth pngs
    scaled to [0,15] with >14.5 = background (reference :343-378)."""

    def __init__(self, database_name: str, dataset_dir: str):
        super().__init__(database_name)
        _, model_name = database_name.split("/")
        self.root = os.path.join(dataset_dir, model_name)
        self.img_num = len(glob.glob(f"{self.root}/*.pkl"))
        self.img_ids = [str(k) for k in range(self.img_num)]
        self.cams = [read_pickle(f"{self.root}/{k}-camera.pkl")
                     for k in range(self.img_num)]

    def get_image(self, img_id):
        return image_io.imread(f"{self.root}/{img_id}.png")[..., :3]

    def get_K(self, img_id):
        return np.asarray(self.cams[int(img_id)][1], np.float32)

    def get_pose(self, img_id):
        return np.asarray(self.cams[int(img_id)][0], np.float32)

    def get_img_ids(self):
        return list(self.img_ids)

    def get_depth(self, img_id):
        depth = image_io.imread(f"{self.root}/{img_id}-depth.png")
        depth = depth.astype(np.float32) / 65535 * 15
        return depth, (depth < 14.5).astype(np.float32)


# ---------------------------------------------------------------------------
# COLMAP-based (real captures)


def look_at_crop(img: np.ndarray, K: np.ndarray, pose: np.ndarray,
                 center: np.ndarray, scale: float, size: int
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Rotate the camera so its principal axis passes through pixel
    ``center``, zoom by ``scale`` and crop to ``size`` x ``size``.

    Same capability as the reference's ``utils/pose_utils.py:319``
    ``look_at_crop`` (used by dataset cropping, database.py:178): the output
    is a pure rotation of the input camera, so world-space geometry is
    preserved; the image is warped by the induced homography
    ``H = K' R_warp K^-1``.
    """
    K = np.asarray(K, np.float64)
    d = np.linalg.inv(K) @ np.array([center[0], center[1], 1.0])
    z = d / np.linalg.norm(d)
    up = np.array([0.0, 1.0, 0.0])
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    R_warp = np.stack([x, y, z], 0)  # cam -> virtual cam

    f = 0.5 * (K[0, 0] + K[1, 1]) * scale
    K_new = np.array([[f, 0, size / 2], [0, f, size / 2], [0, 0, 1]])
    H = K_new @ R_warp @ np.linalg.inv(K)
    img1 = image_io.warp_perspective(img, H, (size, size))
    R, t = pose[:, :3], pose[:, 3:]
    pose1 = np.concatenate([R_warp @ R, R_warp @ t], 1).astype(np.float32)
    return img1, K_new.astype(np.float32), pose1


def crop_by_points(img, ref_points, pose, K, size):
    """Pick the crop window that covers the projected object points
    (reference database.py:150-179)."""
    h, w = img.shape[:2]
    R, t = pose[:, :3], pose[:, 3:]
    cam = ref_points @ R.T + t[:, 0]
    uvw = cam @ np.asarray(K, np.float64).T
    pts2d = uvw[:, :2] / np.maximum(uvw[:, 2:], 1e-8)
    pts2d[:, 0] = np.clip(pts2d[:, 0], 0, w - 1)
    pts2d[:, 1] = np.clip(pts2d[:, 1], 0, h - 1)
    pt_min, pt_max = pts2d.min(0), pts2d.max(0)
    region = min(float(np.max(pt_max - pt_min)), h - 3, w - 3)
    center = (pt_min + pt_max) / 2
    scale = size / max(region, 1.0)
    return look_at_crop(img, K, pose, center, scale, size)


class _ColmapDatabase(BaseDatabase):
    """Shared COLMAP parse + object-cloud normalization + crop/resize
    (reference GlossyRealDatabase/CustomDatabase, database.py:182-341,
    380-539)."""

    def __init__(self, database_name: str, dataset_dir: str):
        super().__init__(database_name)
        parts = database_name.split("/")
        self.object_name, self.max_len_str = parts[1], parts[2]
        self.root = os.path.join(dataset_dir, self.object_name)
        self._parse_colmap()
        self._normalize(*self._up_forward())
        ml = self.max_len_str
        self.do_crop = "crop" in ml
        if ml.startswith("raw"):
            # raw_<N>: isotropic resize of the full frames
            self.image_dir = f"{self.root}/images_{ml}"
            self._resize(int(ml.split("_")[1]))
        elif self.do_crop:
            self.max_len = int(ml.split("_")[0])
            self.image_dir = f"{self.root}/images_{self.max_len}"
            self._crop()
        else:
            self.max_len = int(ml)
            self.image_dir = f"{self.root}/images_{self.max_len}"
            self._crop()

    # -- parsing ---------------------------------------------------------
    def _parse_colmap(self):
        cache = f"{self.root}/cache.pkl"
        if Path(cache).exists():
            (self.poses, self.Ks, self.image_names,
             self.img_ids) = read_pickle(cache)
            return
        from nunerf_tpu_torch.data.colmap import read_model
        cameras, images, _ = read_model(f"{self.root}/colmap/sparse/0")
        self.poses, self.Ks, self.image_names, self.img_ids = {}, {}, {}, []
        for img_id, image in images.items():
            self.img_ids.append(img_id)
            self.image_names[img_id] = image.name
            R = image.qvec2rotmat()
            self.poses[img_id] = np.concatenate(
                [R, image.tvec[:, None]], 1).astype(np.float32)
            self.Ks[img_id] = cameras[image.camera_id].K().astype(np.float32)
        save_pickle((self.poses, self.Ks, self.image_names, self.img_ids),
                    cache)

    def _up_forward(self) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError

    # -- normalization: object cloud -> unit sphere, up -> +z --------------
    def _normalize(self, up: np.ndarray, forward: np.ndarray):
        ref_points = read_ply_points(f"{self.root}/object_point_cloud.ply")
        center = (ref_points.max(0) + ref_points.min(0)) * 0.5
        offset = -center
        scale = 1.0 / np.max(np.linalg.norm(ref_points - center, axis=-1))
        up = up / np.linalg.norm(up)
        forward = forward / np.linalg.norm(forward)
        # world rotation sending `up` to +z with `forward` in the xz plane
        y = np.cross(up, forward)
        x = np.cross(y, up)
        x, y = x / np.linalg.norm(x), y / np.linalg.norm(y)
        R_rec = np.stack([x, y, up], 0)
        self.ref_points = scale * (ref_points + offset) @ R_rec.T
        self.scale_rect, self.offset_rect, self.R_rect = scale, offset, R_rec
        # x_new = R_rec @ (scale * (x_old + offset)), so
        # x_cam = R @ (R_rec^T x_new / scale - offset) + t; rescaling the
        # camera frame by `scale` gives R_new = R R_rec^T,
        # t_new = scale * (t - R @ offset)
        for img_id, pose in self.poses.items():
            R, t = pose[:, :3], pose[:, 3]
            self.poses[img_id] = np.concatenate(
                [R @ R_rec.T, ((t - R @ offset) * scale)[:, None]],
                -1).astype(np.float32)

    # -- image preprocessing ----------------------------------------------
    def _crop(self):
        meta = f"{self.image_dir}/meta_info.pkl"
        if Path(meta).exists():
            self.poses, self.Ks = read_pickle(meta)
            return
        Path(self.image_dir).mkdir(exist_ok=True, parents=True)
        poses_new, Ks_new = {}, {}
        for img_id in self.img_ids:
            img = image_io.imread(f"{self.root}/images/{self.image_names[img_id]}")
            img1, K1, pose1 = crop_by_points(
                img, self.ref_points, self.poses[img_id], self.Ks[img_id],
                self.max_len)
            image_io.imwrite(f"{self.image_dir}/{self.image_names[img_id]}", img1)
            poses_new[img_id], Ks_new[img_id] = pose1, K1
        save_pickle((poses_new, Ks_new), meta)
        self.poses, self.Ks = poses_new, Ks_new

    def _resize(self, max_len: int):
        Path(self.image_dir).mkdir(exist_ok=True, parents=True)
        first = image_io.imread(f"{self.root}/images/"
                        f"{self.image_names[self.img_ids[0]]}")
        h, w = first.shape[:2]
        ratio = float(max_len) / max(h, w)
        rh, rw = int(ratio * h) / h, int(ratio * w) / w
        for img_id in self.img_ids:
            out = f"{self.image_dir}/{self.image_names[img_id]}"
            if not Path(out).exists():
                img = image_io.imread(
                    f"{self.root}/images/{self.image_names[img_id]}")
                image_io.imwrite(out, resize_img(img, ratio))
            self.Ks[img_id] = (np.diag([rw, rh, 1.0]).astype(np.float32)
                               @ self.Ks[img_id])

    # -- accessors ---------------------------------------------------------
    def get_image(self, img_id):
        return image_io.imread(f"{self.image_dir}/{self.image_names[img_id]}")

    def get_image_name(self, img_id):
        return self.image_names[img_id]

    def get_K(self, img_id):
        return self.Ks[img_id].copy()

    def get_pose(self, img_id):
        return self.poses[img_id].copy()

    def get_img_ids(self):
        return list(self.img_ids)

    def get_depth(self, img_id):
        img = self.get_image(img_id)
        h, w = img.shape[:2]
        return np.ones((h, w), np.float32), np.ones((h, w), np.float32)


class GlossyRealDatabase(_ColmapDatabase):
    # per-scene gravity/forward directions for the published captures
    # (reference database.py:183-194; these are dataset constants)
    meta_info = {
        "bear": {"forward": np.array([0.539944, -0.342791, 0.341446]),
                 "up": np.array([0.0512875, -0.645326, -0.762183])},
        "coral": {"forward": np.array([0.004226, -0.235523, 0.267582]),
                  "up": np.array([0.0477973, -0.748313, -0.661622])},
        "maneki": {"forward": np.array([-2.336584, -0.406351, 0.482029]),
                   "up": np.array([-0.0117387, -0.738751, -0.673876])},
        "bunny": {"forward": np.array([0.437076, -1.672467, 1.436961]),
                  "up": np.array([-0.0693234, -0.644819, -0.761185])},
        "vase": {"forward": np.array([-0.911907, -0.132777, 0.180063]),
                 "up": np.array([-0.01911, -0.738918, -0.673524])},
    }

    def _up_forward(self):
        m = self.meta_info[self.object_name]
        return m["up"].astype(np.float64), m["forward"].astype(np.float64)


class CustomDatabase(_ColmapDatabase):
    """Up/forward from ``<scene>/meta_info.txt`` (two rows: up, forward;
    reference :475-477); masks from ``mask_erosion/`` (reference :531-533)."""

    def _up_forward(self):
        directions = np.loadtxt(f"{self.root}/meta_info.txt")
        return (np.asarray(directions[0], np.float64),
                np.asarray(directions[1], np.float64))

    def get_mask(self, img_id):
        name = self.image_names[img_id]
        stem = os.path.splitext(name)[0]
        # 'custom/<scene>/<res>/rawmask' reads the RAW silhouette masks from
        # mask/ (render-mask output) instead of the eroded trust-region
        # masks: mask_erosion = erode ∪ inverted-original is ~1 everywhere
        # but a boundary ring (right for masking the stage-2 rgb loss,
        # meaningless as an acc target).  The round-5 bootstrap stage-1
        # pass supervises acc_sdf with the silhouette.
        parts = self.database_name.split("/")
        sub = "mask" if len(parts) > 3 and parts[3] == "rawmask" \
            else "mask_erosion"
        # the port's render-mask writes <stem>.png; the JAX package's writes
        # .jpg regardless of the capture's image format (reference
        # render_mask_synthetic.py:76 vs database.py:532 reads the raw image
        # name, which only lines up for .jpg captures)
        for fp in (f"{self.root}/{sub}/{stem}.png",
                   f"{self.root}/{sub}/{name}",
                   f"{self.root}/{sub}/{stem}.jpg"):
            if os.path.exists(fp):
                m = image_io.imread(fp)
                if m.ndim == 3:
                    m = m[..., 0]
                return m.astype(np.float32) / 255.0
        return None


# ---------------------------------------------------------------------------


def parse_database_name(database_name: str, dataset_dir: str) -> BaseDatabase:
    """reference database.py:654-665."""
    name2database = {
        "syn": GlossySyntheticDatabase,
        "real": GlossyRealDatabase,
        "custom": CustomDatabase,
        "nerf": NeRFSyntheticDatabase,
    }
    prefix = database_name.split("/")[0]
    if prefix not in name2database:
        raise NotImplementedError(f"unknown database type {prefix!r}")
    return name2database[prefix](database_name, dataset_dir)


def get_database_split(database: BaseDatabase, split_type: str = "validation"
                       ) -> Tuple[List[str], List[str]]:
    """(train_ids, test_ids).

    * ``validation``: the database's own train/test file split when it has
      one (blender scenes), else the reference's seed-100 shuffle holding out
      one view (database.py:667-674);
    * ``test``: ``configs/synthetic_split_128.pkl`` if present (the
      reference's fixed eval split), else a deterministic seed-100 128-view
      holdout.
    """
    if split_type == "validation":
        if hasattr(database, "train_test_split"):
            return database.train_test_split()
        ids = list(database.get_img_ids())
        random.Random(100).shuffle(ids)
        return ids[:1] + ids[2:], ids[1:2]
    if split_type == "test":
        pkl = "configs/synthetic_split_128.pkl"
        if os.path.exists(pkl):
            test_ids, train_ids = read_pickle(pkl)
            return train_ids, test_ids
        ids = list(database.get_img_ids())
        random.Random(100).shuffle(ids)
        # the reference's fixed split holds out 128 of 1024 renders (1/8);
        # keep that fraction for databases without a split file so small
        # capture scenes don't lose half their views to the holdout
        n = min(128, max(1, len(ids) // 8))
        return ids[n:], ids[:n]
    raise NotImplementedError(split_type)


def mask_depth_to_pts(mask: np.ndarray, depth: np.ndarray, K: np.ndarray
                      ) -> np.ndarray:
    """Unproject masked depth to camera-frame points (pixel centers)."""
    h, w = depth.shape
    x, y = np.meshgrid(np.arange(w, dtype=np.float64) + 0.5,
                       np.arange(h, dtype=np.float64) + 0.5)
    valid = np.asarray(mask, np.float64) > 0.5
    d = depth[valid].astype(np.float64)
    uv1 = np.stack([x[valid], y[valid], np.ones_like(x[valid])], -1)
    return (uv1 @ np.linalg.inv(np.asarray(K, np.float64)).T) * d[:, None]


def voxel_downsample(pts: np.ndarray, voxel: float) -> np.ndarray:
    """Mean point per occupied voxel cell."""
    cells = np.floor(pts / voxel).astype(np.int64)
    _, inv, counts = np.unique(cells, axis=0, return_inverse=True,
                               return_counts=True)
    sums = np.zeros((len(counts), 3), np.float64)
    np.add.at(sums, inv, pts)
    return (sums / counts[:, None]).astype(np.float32)


def get_database_eval_points(database: BaseDatabase, voxel: float = 0.01
                             ) -> np.ndarray:
    """World-frame geometry evaluation points from the database's depth maps
    (reference database.py:682-705; generalized beyond GlossySynthetic, with
    the same eval_pts.ply cache for that database)."""
    cache = None
    if isinstance(database, GlossySyntheticDatabase):
        cache = f"{database.root}/eval_pts.ply"
        if os.path.exists(cache):
            return read_ply_points(cache)
        _, ids = get_database_split(database, "test")
    else:
        ids = database.get_img_ids()

    pts = []
    for img_id in ids:
        depth, mask = database.get_depth(img_id)
        cam_pts = mask_depth_to_pts(mask, depth, database.get_K(img_id))
        pose = np.asarray(database.get_pose(img_id), np.float64)  # w2c [3,4]
        R, t = pose[:, :3], pose[:, 3]
        pts.append((cam_pts - t) @ R)  # R^T (x - t)
    pts = np.concatenate(pts, 0)
    pts = voxel_downsample(pts, voxel)
    if cache is not None:
        write_ply_points(cache, pts)
    return pts
