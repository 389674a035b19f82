"""COLMAP sparse-model IO: own reader/writer for the binary and text formats.
The port's own copy of ``nunerf_tpu/data/colmap.py`` (numpy and ``struct``).

Replaces the reference's vendored ``colmap/read_write_model.py`` (used at
``dataset/database.py:13``) with a compact implementation of the documented
COLMAP formats (https://colmap.github.io/format.html): ``cameras.bin/.txt``,
``images.bin/.txt``, ``points3D.bin/.txt``.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np

# model name -> (colmap model id, #params)
CAMERA_MODELS: Dict[str, Tuple[int, int]] = {
    "SIMPLE_PINHOLE": (0, 3),
    "PINHOLE": (1, 4),
    "SIMPLE_RADIAL": (2, 4),
    "RADIAL": (3, 5),
    "OPENCV": (4, 8),
    "OPENCV_FISHEYE": (5, 8),
    "FULL_OPENCV": (6, 12),
    "FOV": (7, 5),
    "SIMPLE_RADIAL_FISHEYE": (8, 4),
    "RADIAL_FISHEYE": (9, 5),
    "THIN_PRISM_FISHEYE": (10, 12),
}
MODEL_ID_TO_NAME = {v[0]: k for k, v in CAMERA_MODELS.items()}


@dataclass
class Camera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray

    def K(self) -> np.ndarray:
        """3x3 intrinsics from the model's focal/principal-point params
        (distortion coefficients, if any, are ignored)."""
        p = np.asarray(self.params, np.float64)
        if self.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL",
                          "SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE", "FOV"):
            f, cx, cy = p[0], p[1], p[2]
            fx = fy = f
        else:  # PINHOLE / OPENCV / FULL_OPENCV / OPENCV_FISHEYE / THIN_PRISM
            fx, fy, cx, cy = p[0], p[1], p[2], p[3]
        return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)


@dataclass
class Image:
    id: int
    qvec: np.ndarray
    tvec: np.ndarray
    camera_id: int
    name: str
    xys: np.ndarray = field(default_factory=lambda: np.zeros((0, 2)))
    point3D_ids: np.ndarray = field(
        default_factory=lambda: np.zeros((0,), np.int64))

    def qvec2rotmat(self) -> np.ndarray:
        return qvec_to_rotmat(self.qvec)


@dataclass
class Point3D:
    id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float
    image_ids: np.ndarray = field(
        default_factory=lambda: np.zeros((0,), np.int32))
    point2D_idxs: np.ndarray = field(
        default_factory=lambda: np.zeros((0,), np.int32))


def qvec_to_rotmat(q) -> np.ndarray:
    """Rotation matrix from a (w, x, y, z) unit quaternion."""
    w, x, y, z = np.asarray(q, np.float64)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def rotmat_to_qvec(R) -> np.ndarray:
    """(w, x, y, z) quaternion from a rotation matrix (Shepperd's method:
    pick the largest of the four squared components for stability)."""
    R = np.asarray(R, np.float64)
    t = np.trace(R)
    cand = np.array([t, R[0, 0], R[1, 1], R[2, 2]])
    i = int(np.argmax(cand))
    if i == 0:
        w = 0.5 * np.sqrt(1.0 + t)
        s = 0.25 / w
        q = np.array([w, (R[2, 1] - R[1, 2]) * s, (R[0, 2] - R[2, 0]) * s,
                      (R[1, 0] - R[0, 1]) * s])
    else:
        a = i - 1  # the dominant axis
        b, c = (a + 1) % 3, (a + 2) % 3
        s = np.sqrt(1.0 + R[a, a] - R[b, b] - R[c, c])
        q = np.zeros(4)
        q[a + 1] = 0.5 * s
        s = 0.25 / (0.5 * s)
        q[0] = (R[c, b] - R[b, c]) * s
        q[b + 1] = (R[b, a] + R[a, b]) * s
        q[c + 1] = (R[c, a] + R[a, c]) * s
    if q[0] < 0:
        q = -q
    return q / np.linalg.norm(q)


# ---------------------------------------------------------------------------
# binary IO


def _read(f, fmt):
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))


def read_cameras_binary(path: str) -> Dict[int, Camera]:
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cam_id, model_id, w, h = _read(f, "<iiQQ")
            name = MODEL_ID_TO_NAME[model_id]
            np_ = CAMERA_MODELS[name][1]
            params = np.array(_read(f, f"<{np_}d"))
            cams[cam_id] = Camera(cam_id, name, int(w), int(h), params)
    return cams


def read_images_binary(path: str) -> Dict[int, Image]:
    images = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            img_id = _read(f, "<i")[0]
            qvec = np.array(_read(f, "<4d"))
            tvec = np.array(_read(f, "<3d"))
            cam_id = _read(f, "<i")[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (npts,) = _read(f, "<Q")
            data = np.frombuffer(f.read(24 * npts),
                                 dtype=[("xy", "<f8", 2), ("id", "<i8")])
            images[img_id] = Image(img_id, qvec, tvec, cam_id,
                                   name.decode("utf-8"),
                                   data["xy"].copy(), data["id"].copy())
    return images


def read_points3d_binary(path: str) -> Dict[int, Point3D]:
    pts = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            pid = _read(f, "<q")[0]
            xyz = np.array(_read(f, "<3d"))
            rgb = np.array(_read(f, "<3B"), np.uint8)
            (err,) = _read(f, "<d")
            (tl,) = _read(f, "<Q")
            track = np.frombuffer(f.read(8 * tl),
                                  dtype=[("img", "<i4"), ("p2d", "<i4")])
            pts[pid] = Point3D(pid, xyz, rgb, float(err),
                               track["img"].copy(), track["p2d"].copy())
    return pts


def write_cameras_binary(cams: Dict[int, Camera], path: str):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for cam in cams.values():
            model_id = CAMERA_MODELS[cam.model][0]
            f.write(struct.pack("<iiQQ", cam.id, model_id, cam.width,
                                cam.height))
            p = np.asarray(cam.params, np.float64)
            f.write(struct.pack(f"<{len(p)}d", *p))


def write_images_binary(images: Dict[int, Image], path: str):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<i", im.id))
            f.write(struct.pack("<4d", *np.asarray(im.qvec, np.float64)))
            f.write(struct.pack("<3d", *np.asarray(im.tvec, np.float64)))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            xys = np.asarray(im.xys, np.float64).reshape(-1, 2)
            ids = np.asarray(im.point3D_ids, np.int64).reshape(-1)
            f.write(struct.pack("<Q", len(xys)))
            data = np.empty(len(xys), dtype=[("xy", "<f8", 2), ("id", "<i8")])
            data["xy"] = xys
            data["id"] = ids[:len(xys)] if len(ids) >= len(xys) else np.full(
                len(xys), -1, np.int64)
            f.write(data.tobytes())


def write_points3d_binary(pts: Dict[int, Point3D], path: str):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(pts)))
        for p in pts.values():
            f.write(struct.pack("<q", p.id))
            f.write(struct.pack("<3d", *np.asarray(p.xyz, np.float64)))
            f.write(struct.pack("<3B", *np.asarray(p.rgb, np.uint8)))
            f.write(struct.pack("<d", float(p.error)))
            img_ids = np.asarray(p.image_ids, np.int32).reshape(-1)
            p2d = np.asarray(p.point2D_idxs, np.int32).reshape(-1)
            f.write(struct.pack("<Q", len(img_ids)))
            track = np.empty(len(img_ids), dtype=[("img", "<i4"),
                                                  ("p2d", "<i4")])
            track["img"] = img_ids
            track["p2d"] = p2d[:len(img_ids)] if len(p2d) >= len(img_ids) \
                else np.zeros(len(img_ids), np.int32)
            f.write(track.tobytes())


# ---------------------------------------------------------------------------
# text IO (read side; COLMAP also exports models as text)


def _data_lines(path):
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                yield line


def read_cameras_text(path: str) -> Dict[int, Camera]:
    cams = {}
    for line in _data_lines(path):
        el = line.split()
        cam_id, model = int(el[0]), el[1]
        cams[cam_id] = Camera(cam_id, model, int(el[2]), int(el[3]),
                              np.array(el[4:], np.float64))
    return cams


def read_images_text(path: str) -> Dict[int, Image]:
    images = {}
    lines = list(_data_lines(path))
    for i in range(0, len(lines), 2):
        el = lines[i].split()
        img_id = int(el[0])
        qvec = np.array(el[1:5], np.float64)
        tvec = np.array(el[5:8], np.float64)
        cam_id = int(el[8])
        name = el[9]
        pts = lines[i + 1].split() if i + 1 < len(lines) else []
        xys = np.array(pts, np.float64).reshape(-1, 3) if pts else \
            np.zeros((0, 3))
        images[img_id] = Image(img_id, qvec, tvec, cam_id, name,
                               xys[:, :2].copy(),
                               xys[:, 2].astype(np.int64))
    return images


def read_points3d_text(path: str) -> Dict[int, Point3D]:
    pts = {}
    for line in _data_lines(path):
        el = line.split()
        pid = int(el[0])
        xyz = np.array(el[1:4], np.float64)
        rgb = np.array(el[4:7], np.float64).astype(np.uint8)
        err = float(el[7])
        track = np.array(el[8:], np.float64).reshape(-1, 2)
        pts[pid] = Point3D(pid, xyz, rgb, err,
                           track[:, 0].astype(np.int32),
                           track[:, 1].astype(np.int32))
    return pts


# ---------------------------------------------------------------------------


def read_model(model_dir: str):
    """(cameras, images, points3D) dicts; auto-detects binary vs text."""
    if os.path.exists(os.path.join(model_dir, "cameras.bin")):
        return (read_cameras_binary(os.path.join(model_dir, "cameras.bin")),
                read_images_binary(os.path.join(model_dir, "images.bin")),
                read_points3d_binary(os.path.join(model_dir, "points3D.bin")))
    if os.path.exists(os.path.join(model_dir, "cameras.txt")):
        return (read_cameras_text(os.path.join(model_dir, "cameras.txt")),
                read_images_text(os.path.join(model_dir, "images.txt")),
                read_points3d_text(os.path.join(model_dir, "points3D.txt")))
    raise FileNotFoundError(f"no COLMAP model in {model_dir}")


def write_model(cams: Dict[int, Camera], images: Dict[int, Image],
                pts: Dict[int, Point3D], model_dir: str):
    """Write a binary model (exact double-precision roundtrip)."""
    os.makedirs(model_dir, exist_ok=True)
    write_cameras_binary(cams, os.path.join(model_dir, "cameras.bin"))
    write_images_binary(images, os.path.join(model_dir, "images.bin"))
    write_points3d_binary(pts, os.path.join(model_dir, "points3D.bin"))
