"""The port's tools (``nunerf_tpu_torch/tools/render_mask.py`` and
``outer_filter.py``) against the JAX package's, on the CPU, and the masks'
format: the port writes PNG and both databases read a ``.png`` mask before
a ``.jpg``.

``render_masks``: the JAX masks are captured before JPEG encoding (its
``cv2.imwrite`` is replaced in the test), so the masks compare exactly:
both sides are the brute closest hit with the barycentric tolerance 1e-6 on
the same f32 rays.  ``erode_masks``: the JAX eroder (``cv2.erode``) and the
port's (max-pool, on the CPU here) on the same PNG masks, to the bit; the
max-pool also against its numpy twin and ``cv2.erode`` at odd and even
sizes.  ``filter_outer``: the same stats and the same kept faces in the same
order; ``taubin_smooth``, ``convex_hull_mesh`` and ``density_filtered_hull``
are numpy and scipy on both sides: equal.
"""

import os
import shutil

import cv2
import numpy as np
import pytest
import torch

from nunerf_tpu.tools import outer_filter as jof
from nunerf_tpu.tools import render_mask as jrm
from nunerf_tpu.tracing.mesh_ops import extract_geometry, save_ply
from nunerf_tpu_torch.data import database as tdb
from nunerf_tpu_torch.data import image_io
from nunerf_tpu_torch.tools import outer_filter as pof
from nunerf_tpu_torch.tools import render_mask as prm
from scene_utils import make_test_scene


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sphere(r=0.5, res=16, center=(0.0, 0.0, 0.0)):
    v, t = extract_geometry(lambda p: np.linalg.norm(p, axis=-1) - 1.0, resolution=res)
    return (v * r + np.asarray(center, np.float32)).astype(np.float32), t


@pytest.fixture(scope="module")
def mask_scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("masks")
    make_test_scene(str(root / "jax" / "tiny"), n_train=3, n_test=1, h=24, w=32)
    mesh = str(root / "sphere.ply")
    save_ply(mesh, *_sphere(0.45, 24))
    return root, mesh


def _cfg(root, side):
    return {"database_name": "nerf/tiny", "dataset_dir": str(root / side), "is_nerf": True}


def test_render_and_erode_masks_match_jax(mask_scene, monkeypatch):
    root, mesh = mask_scene
    captured = {}
    monkeypatch.setattr(jrm.cv2, "imwrite",
                        lambda fp, img: captured.setdefault(fp, np.array(img)) is not None)
    jrm.render_masks(_cfg(root, "jax"), mesh)
    monkeypatch.undo()
    shutil.copytree(root / "jax" / "tiny", root / "port" / "tiny",
                    ignore=shutil.ignore_patterns("mask"))
    out = prm.render_masks(_cfg(root, "port"), mesh, chunk=200, device="cpu")
    assert out == str(root / "port" / "tiny" / "mask")
    assert len(captured) == 4
    for fp, want in captured.items():
        rel = os.path.relpath(fp, root / "jax" / "tiny" / "mask")
        assert rel.endswith(".jpg")
        got = image_io.imread(os.path.join(out, rel[:-4] + ".png"))
        assert got.dtype == np.uint8 and set(np.unique(got)) <= {0, 255}
        np.testing.assert_array_equal(got, want, err_msg=rel)
    assert sum(int(m.any()) for m in captured.values()) >= 3

    # the JAX eroder on the port's PNG masks, in a copy of the scene
    jroot = root / "jax2"
    shutil.copytree(root / "port", jroot)
    jrm.erode_masks(_cfg(root, "jax2"), erosion=5)
    prm.erode_masks(_cfg(root, "port"), erosion=5, device="cpu")
    n = 0
    for dirpath, _, fnames in os.walk(jroot / "tiny" / "mask_erosion"):
        for fname in fnames:
            rel = os.path.relpath(os.path.join(dirpath, fname), jroot / "tiny")
            want = cv2.imread(str(jroot / "tiny" / rel), cv2.IMREAD_GRAYSCALE)
            np.testing.assert_array_equal(image_io.imread(str(root / "port" / "tiny" / rel)),
                                          want, err_msg=rel)
            n += 1
    assert n == 4
    # the database reads the eroded PNG back
    db = tdb.parse_database_name("nerf/tiny", str(root / "port"))
    m = image_io.imread(str(root / "port" / "tiny" / "mask_erosion" / "train" / "r_0.png"))
    np.testing.assert_array_equal(db.get_mask("0"), m.astype(np.float32) / 255.0)


@pytest.mark.parametrize("k", [1, 4, 5, 15])
def test_device_erosion_equals_cv2_and_its_twin(k):
    rs = np.random.RandomState(k)
    m = (rs.rand(37, 45) > 0.3).astype(np.uint8) * 255
    m[10:25, 5:30] = 255
    want = cv2.erode(m, np.ones((k, k), np.uint8))
    np.testing.assert_array_equal(prm.erode(m, k, "cpu"), want)
    np.testing.assert_array_equal(prm.erode_reference(m, k), want)


def test_masks_read_png_before_jpeg(tmp_path):
    """A ``mask_erosion/`` with a PNG and a JPEG of one view: both databases
    return the PNG's values (Blender layout and the capture layout)."""
    from test_torch_port_data import _write_colmap_scene

    root = tmp_path / "nerf" / "tiny"
    make_test_scene(str(root), n_train=2, n_test=1, h=8, w=8)
    os.makedirs(root / "mask_erosion" / "train")
    image_io.imwrite(str(root / "mask_erosion" / "train" / "r_0.png"),
                     np.full((8, 8), 100, np.uint8))
    cv2.imwrite(str(root / "mask_erosion" / "train" / "r_0.jpg"), np.full((8, 8), 200, np.uint8))
    cv2.imwrite(str(root / "mask_erosion" / "train" / "r_1.jpg"), np.full((8, 8), 200, np.uint8))
    db = tdb.parse_database_name("nerf/tiny", str(tmp_path / "nerf"))
    np.testing.assert_array_equal(db.get_mask("0"), np.full((8, 8), 100 / 255, np.float32))
    # a JPEG alone is still read (cv2 is installed here)
    np.testing.assert_allclose(db.get_mask("1"), 200 / 255, atol=2 / 255)

    _write_colmap_scene(str(tmp_path / "cap" / "obj"))
    os.makedirs(tmp_path / "cap" / "obj" / "mask_erosion")
    image_io.imwrite(str(tmp_path / "cap" / "obj" / "mask_erosion" / "im1.png"),
                     np.full((8, 8), 100, np.uint8))
    cv2.imwrite(str(tmp_path / "cap" / "obj" / "mask_erosion" / "im1.jpg"),
                np.full((8, 8), 200, np.uint8))
    cv2.imwrite(str(tmp_path / "cap" / "obj" / "mask_erosion" / "im2.jpg"),
                np.full((8, 8), 200, np.uint8))
    db = tdb.parse_database_name("custom/obj/64", str(tmp_path / "cap"))
    by_name = {db.get_image_name(i): i for i in db.get_img_ids()}
    np.testing.assert_array_equal(db.get_mask(by_name["im1.png"]),
                                  np.full((8, 8), 100 / 255, np.float32))
    np.testing.assert_allclose(db.get_mask(by_name["im2.png"]), 200 / 255, atol=2 / 255)


@pytest.fixture(scope="module")
def junk_mesh():
    """An outer sphere, an inner sphere (hidden behind it from every view)
    and a small floater beside them."""
    parts = [_sphere(0.5, 8), _sphere(0.2, 6), _sphere(0.03, 5, (0.8, 0.0, 0.0))]
    verts, tris, n = [], [], 0
    for v, t in parts:
        verts.append(v)
        tris.append(t + n)
        n += len(v)
    return np.concatenate(verts), np.concatenate(tris)


def test_filter_outer_matches_jax(junk_mesh):
    verts, tris = junk_mesh
    jv, jt, jstats = jof.filter_outer(verts, tris, n_views=8)
    pv, pt, pstats = pof.filter_outer(verts, tris, n_views=8, device="cpu")
    assert pstats == jstats
    assert jstats["after_floaters"] < jstats["faces_in"]
    assert jstats["faces_out"] < jstats["after_floaters"]
    np.testing.assert_array_equal(pv, jv)
    np.testing.assert_array_equal(pt, jt)
    # the partition into components, whatever the labels
    for t in (tris, jt):
        a, b = jof.face_components(t), pof.face_components(t)
        pairs = set(zip(a.tolist(), b.tolist()))
        assert len(pairs) == len(set(a.tolist())) == len(set(b.tolist()))


def test_smoothing_and_hulls_match_jax(junk_mesh):
    verts, tris = junk_mesh
    np.testing.assert_array_equal(pof.taubin_smooth(verts, tris, iters=5),
                                  jof.taubin_smooth(verts, tris, iters=5))
    for a, b in zip(pof.convex_hull_mesh(verts), jof.convex_hull_mesh(verts)):
        np.testing.assert_array_equal(a, b)
    rs = np.random.RandomState(4)
    cloud = np.concatenate([verts, rs.randn(40, 3) * 2.0]).astype(np.float32)
    for a, b in zip(pof.density_filtered_hull(cloud), jof.density_filtered_hull(cloud)):
        np.testing.assert_array_equal(a, b)


def test_filter_outer_with_every_face_dropped():
    """Guarded: the port returns an empty mesh where the JAX function fails
    on its empty face array (ROADMAP.md 3.4)."""
    verts, tris = _sphere(0.5, 6)
    with pytest.raises(ValueError):
        jof.filter_outer(verts, tris, n_views=2, min_area_frac=2.0)
    v, t, stats = pof.filter_outer(verts, tris, n_views=2, min_area_frac=2.0, device="cpu")
    assert stats == {"faces_in": len(tris), "after_floaters": 0, "after_visibility": 0,
                     "faces_out": 0, "verts_out": 0}
    assert v.shape == (0, 3) and t.shape == (0, 3)
