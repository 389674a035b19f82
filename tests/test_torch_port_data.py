"""The port's data layer against the JAX package's, on the CPU (mirrors
``tests/test_database.py`` and ``tests/test_device_rays.py``).

Every database (NeRF-synthetic, GlossySynthetic with its 16-bit depth, the
colmap-backed GlossyReal and Custom), the splits, ``build_imgs_info``, both
ray-batch constructors, the compact store and ``sample_rays``, the metrics
and the colmap files, each on the same files read by both packages.

Tolerances: images read from PNG, poses, intrinsics and the host-side ray
batches are equal (the same numpy arithmetic on the same bits), except the
crops of the colmap databases, which the port warps with its own bilinear
``warp_perspective`` in float64 (within one level of cv2's, see
``tests/test_torch_port_image_io.py``); ``sample_rays`` is held at atol 1e-5
as the JAX test holds it against the host batch (its 3x3 products and norms
sum in another order); SSIM to 1e-9 (float64 blurs summed in another
order), PSNR to 1e-6 relative.
"""

import os
import pickle

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nunerf_tpu.data import colmap as jcolmap
from nunerf_tpu.data import database as jdb
from nunerf_tpu.data import device_rays as jdr
from nunerf_tpu.data import ray_store as jrs
from nunerf_tpu.train import metrics as jmetrics
from nunerf_tpu_torch.data import colmap as tcolmap
from nunerf_tpu_torch.data import database as tdb
from nunerf_tpu_torch.data import device_rays as tdr
from nunerf_tpu_torch.data import ray_store as trs
from nunerf_tpu_torch.train import metrics as tmetrics
from scene_utils import make_test_scene


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small CPU tensors gain nothing from torch's threads, and the suite's
    workers share the machine's cores: one thread each keeps them from
    oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _look_at_w2c(cam_pos):
    z = -cam_pos / np.linalg.norm(cam_pos)
    x = np.cross(z, np.array([0.0, 0.0, 1.0]))
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    R = np.stack([x, y, z], 0)
    return np.concatenate([R, (-R @ cam_pos)[:, None]], 1)


def _write_text_model(cams, images, pts, model_dir):
    """COLMAP's text format (colmap.github.io/format.html); the JAX package
    writes only the binary one."""
    os.makedirs(model_dir, exist_ok=True)
    with open(f"{model_dir}/cameras.txt", "w") as f:
        f.write("# camera list\n")
        for c in cams.values():
            f.write(" ".join([str(c.id), c.model, str(c.width), str(c.height)]
                             + [repr(float(v)) for v in c.params]) + "\n")
    with open(f"{model_dir}/images.txt", "w") as f:
        for im in images.values():
            f.write(" ".join([str(im.id)] + [repr(float(v)) for v in (*im.qvec, *im.tvec)]
                             + [str(im.camera_id), im.name]) + "\n")
            f.write(" ".join(f"{x!r} {y!r} {int(i)}" for (x, y), i in
                             zip(im.xys.tolist(), im.point3D_ids)) + "\n")
    with open(f"{model_dir}/points3D.txt", "w") as f:
        for q in pts.values():
            track = " ".join(f"{a} {b}" for a, b in zip(q.image_ids, q.point2D_idxs))
            f.write(" ".join([str(q.id)] + [repr(float(v)) for v in q.xyz]
                             + [str(int(v)) for v in q.rgb] + [repr(float(q.error)), track])
                    + "\n")


def _write_colmap_scene(root, n=4, size=48, binary=True):
    """Cameras on a ring looking at a point-cloud sphere, written with the
    JAX package's colmap writer, textured images (so that the crops show)."""
    os.makedirs(f"{root}/images", exist_ok=True)
    center = np.array([0.3, -0.2, 0.5])
    rs = np.random.RandomState(0)
    sph = rs.randn(2000, 3)
    sph /= np.linalg.norm(sph, axis=-1, keepdims=True)
    jdb.write_ply_points(f"{root}/object_point_cloud.ply", center + 0.4 * sph)
    np.savetxt(f"{root}/meta_info.txt", np.array([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0]]))
    f = 60.0
    cams = {1: jcolmap.Camera(1, "SIMPLE_PINHOLE", size, size,
                              np.array([f, size / 2, size / 2], np.float64))}
    images = {}
    y, x = np.mgrid[0:size, 0:size]
    for k in range(n):
        phi = 2 * np.pi * k / n
        pos = center + 2.0 * np.array([np.cos(phi), np.sin(phi), 0.3])
        w2c = _look_at_w2c(pos - center)
        w2c[:, 3] = w2c[:, :3] @ -pos
        images[k + 1] = jcolmap.Image(k + 1, jcolmap.rotmat_to_qvec(w2c[:, :3]),
                                      w2c[:, 3].copy(), 1, f"im{k}.png",
                                      np.array([[10.5, 20.25]]), np.array([-1]))
        img = np.stack([(x * 5 + k * 20) % 256, (y * 3) % 256, (x * y) % 256], -1)
        cv2.imwrite(f"{root}/images/im{k}.png", img.astype(np.uint8))
    if binary:
        jcolmap.write_model(cams, images, {}, f"{root}/colmap/sparse/0")
    else:
        _write_text_model(cams, images, {}, f"{root}/colmap/sparse/0")


def _same_database(jd, td, image_tol=0):
    assert jd.get_img_ids() == td.get_img_ids()
    for i in jd.get_img_ids():
        a, b = np.asarray(jd.get_image(i)), np.asarray(td.get_image(i))
        assert a.shape == b.shape and a.dtype == b.dtype
        assert np.abs(a.astype(int) - b.astype(int)).max() <= image_tol, i
        np.testing.assert_array_equal(jd.get_K(i), td.get_K(i))
        np.testing.assert_array_equal(jd.get_pose(i), td.get_pose(i))
        assert jd.get_image_name(i) == td.get_image_name(i)
        for x, y in zip(jd.get_depth(i), td.get_depth(i)):
            np.testing.assert_array_equal(x, y)
        m1, m2 = jd.get_mask(i), td.get_mask(i)
        assert (m1 is None) == (m2 is None)
        if m1 is not None:
            np.testing.assert_array_equal(m1, m2)


@pytest.fixture(scope="module")
def nerf_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("datasets")
    make_test_scene(str(root / "tiny_sphere"), h=20, w=24)
    return str(root)


def test_nerf_synthetic_database_and_splits(nerf_root):
    jd = jdb.parse_database_name("nerf/tiny_sphere", nerf_root)
    td = tdb.parse_database_name("nerf/tiny_sphere", nerf_root)
    assert isinstance(td, tdb.NeRFSyntheticDatabase)
    _same_database(jd, td)
    for split in ("validation", "test"):
        assert jdb.get_database_split(jd, split) == tdb.get_database_split(td, split)
    with pytest.raises(NotImplementedError):
        tdb.parse_database_name("what/scene", nerf_root)


def test_glossy_synthetic_database_16bit_depth(tmp_path):
    root = tmp_path / "pot"
    root.mkdir()
    K = np.array([[40.0, 0, 16], [0, 40.0, 16], [0, 0, 1]], np.float32)
    pose = _look_at_w2c(np.array([0.0, -2.0, 0.5])).astype(np.float32)
    rs = np.random.RandomState(0)
    for k in range(3):
        with open(root / f"{k}-camera.pkl", "wb") as f:
            pickle.dump((pose, K), f)
        cv2.imwrite(str(root / f"{k}.png"), rs.randint(0, 256, (32, 32, 3)).astype(np.uint8))
        depth = np.full((32, 32), 2.0) + rs.rand(32, 32)
        depth[:4] = 15.0
        cv2.imwrite(str(root / f"{k}-depth.png"), (depth / 15 * 65535).astype(np.uint16))
    jd = jdb.parse_database_name("syn/pot", str(tmp_path))
    td = tdb.parse_database_name("syn/pot", str(tmp_path))
    assert isinstance(td, tdb.GlossySyntheticDatabase)
    _same_database(jd, td)
    for split in ("validation", "test"):
        assert jdb.get_database_split(jd, split) == tdb.get_database_split(td, split)
    want = jdb.get_database_eval_points(jd, 0.05)
    os.remove(root / "eval_pts.ply")  # the cache of the JAX call
    np.testing.assert_array_equal(want, tdb.get_database_eval_points(td, 0.05))
    assert os.path.exists(root / "eval_pts.ply")


@pytest.mark.parametrize("name,binary", [("custom/obj/64", True), ("custom/obj/64", False),
                                         ("real/bear/64", True), ("custom/obj/raw_40", True)])
def test_colmap_databases(tmp_path, name, binary):
    """GlossyReal and Custom: the same colmap parse, normalisation, crop (or
    raw resize) and masks; the crops within one level of the JAX package's
    cv2 warp, the raw resize (INTER_AREA) within one level of cv2's."""
    obj = name.split("/")[1]
    for side in ("jax", "port"):
        _write_colmap_scene(str(tmp_path / side / obj), binary=binary)
    jd = jdb.parse_database_name(name, str(tmp_path / "jax"))
    td = tdb.parse_database_name(name, str(tmp_path / "port"))
    assert type(td).__name__ == type(jd).__name__
    np.testing.assert_array_equal(jd.ref_points, td.ref_points)
    _same_database(jd, td, image_tol=1)
    assert jdb.get_database_split(jd, "validation") == tdb.get_database_split(td, "validation")
    np.testing.assert_allclose(jdb.get_database_eval_points(jd, 0.05),
                               tdb.get_database_eval_points(td, 0.05))
    # a second parse reads the cache both packages wrote
    td2 = tdb.parse_database_name(name, str(tmp_path / "port"))
    i = td.get_img_ids()[0]
    np.testing.assert_array_equal(td2.get_pose(i), td.get_pose(i))


def test_custom_masks_and_crop_helpers(tmp_path):
    for side in ("jax", "port"):
        _write_colmap_scene(str(tmp_path / side / "obj"))
        os.makedirs(tmp_path / side / "obj" / "mask_erosion")
        cv2.imwrite(str(tmp_path / side / "obj" / "mask_erosion" / "im1.jpg"),
                    np.full((8, 8), 200, np.uint8))
    jd = jdb.parse_database_name("custom/obj/64", str(tmp_path / "jax"))
    td = tdb.parse_database_name("custom/obj/64", str(tmp_path / "port"))
    for i in jd.get_img_ids():
        m1, m2 = jd.get_mask(i), td.get_mask(i)
        assert (m1 is None) == (m2 is None)
        if m1 is not None:
            np.testing.assert_array_equal(m1, m2)
    rs = np.random.RandomState(2)
    img = rs.randint(0, 256, (50, 60, 3)).astype(np.uint8)
    K = np.array([[50.0, 0, 30], [0, 50.0, 25], [0, 0, 1]])
    pose = _look_at_w2c(np.array([0.2, -2.0, 0.4]))
    pts = rs.randn(300, 3) * 0.3
    a, b = jdb.crop_by_points(img, pts, pose, K, 32), tdb.crop_by_points(img, pts, pose, K, 32)
    assert np.abs(a[0].astype(int) - b[0].astype(int)).max() <= 1
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[2], b[2])


def test_small_helpers(tmp_path):
    pts = np.random.RandomState(1).randn(100, 3).astype(np.float32)
    tdb.write_ply_points(str(tmp_path / "p.ply"), pts)
    np.testing.assert_array_equal(jdb.read_ply_points(str(tmp_path / "p.ply")), pts)
    jdb.write_ply_points(str(tmp_path / "q.ply"), pts)
    np.testing.assert_array_equal(tdb.read_ply_points(str(tmp_path / "q.ply")), pts)
    tdb.save_pickle({"a": 1}, str(tmp_path / "x.pkl"))
    assert jdb.read_pickle(str(tmp_path / "x.pkl")) == tdb.read_pickle(str(tmp_path / "x.pkl"))
    rs = np.random.RandomState(3)
    depth, mask = rs.rand(6, 7) + 1, (rs.rand(6, 7) > 0.3).astype(np.float32)
    K = np.array([[5.0, 0, 3], [0, 5.0, 3], [0, 0, 1]])
    np.testing.assert_array_equal(jdb.mask_depth_to_pts(mask, depth, K),
                                  tdb.mask_depth_to_pts(mask, depth, K))
    np.testing.assert_array_equal(jdb.voxel_downsample(pts, 0.3), tdb.voxel_downsample(pts, 0.3))


def test_colmap_round_trip_against_jax(tmp_path):
    """The port's binary writer read by the JAX reader, the JAX writer read
    by the port's, and one text model read by both."""
    rs = np.random.RandomState(4)
    cams = {1: tcolmap.Camera(1, "PINHOLE", 64, 48, np.array([50.0, 51.0, 32.0, 24.0])),
            2: tcolmap.Camera(2, "OPENCV", 64, 48, rs.rand(8))}
    q = np.array([0.9, 0.1, -0.2, 0.3]) / np.linalg.norm([0.9, 0.1, -0.2, 0.3])
    R = tcolmap.qvec_to_rotmat(q)
    images = {3: tcolmap.Image(3, tcolmap.rotmat_to_qvec(R), rs.randn(3), 2, "a.png",
                               xys=rs.rand(5, 2), point3D_ids=np.array([1, -1, 7, 8, -1]))}
    pts = {7: tcolmap.Point3D(7, rs.randn(3), np.array([1, 2, 3]), 0.5,
                              np.array([3]), np.array([2]))}
    tcolmap.write_model(cams, images, pts, str(tmp_path / "port"))
    jcolmap.write_model(*jcolmap.read_model(str(tmp_path / "port")), str(tmp_path / "jax"))
    _write_text_model(cams, images, pts, str(tmp_path / "text"))
    models = [jcolmap.read_model(str(tmp_path / "port")),
              tcolmap.read_model(str(tmp_path / "jax")),
              jcolmap.read_model(str(tmp_path / "text")),
              tcolmap.read_model(str(tmp_path / "text"))]
    for c, im, p in models:
        assert sorted(c) == [1, 2] and c[2].model == "OPENCV"
        np.testing.assert_array_equal(c[2].params, cams[2].params)
        np.testing.assert_array_equal(im[3].qvec, images[3].qvec)
        np.testing.assert_array_equal(im[3].tvec, images[3].tvec)
        np.testing.assert_array_equal(im[3].xys, images[3].xys)
        np.testing.assert_array_equal(im[3].point3D_ids, images[3].point3D_ids)
        np.testing.assert_array_equal(p[7].xyz, pts[7].xyz)
        np.testing.assert_array_equal(p[7].image_ids, [3])
    np.testing.assert_allclose(tcolmap.qvec_to_rotmat(images[3].qvec), R, atol=1e-12)
    np.testing.assert_array_equal(tcolmap.rotmat_to_qvec(R), jcolmap.rotmat_to_qvec(R))


@pytest.fixture(scope="module")
def infos(nerf_root):
    jd = jdb.parse_database_name("nerf/tiny_sphere", nerf_root)
    td = tdb.parse_database_name("nerf/tiny_sphere", nerf_root)
    ids, _ = tdb.get_database_split(td)
    return jrs.build_imgs_info(jd, ids), trs.build_imgs_info(td, ids)


def test_imgs_info_and_ray_batches(infos):
    jinfo, tinfo = infos
    assert sorted(jinfo) == sorted(tinfo)
    for k in jinfo:
        np.testing.assert_array_equal(jinfo[k], tinfo[k])
    for fc in (False, True):
        (jb, jh, jw), (tb, th, tw) = (jrs.construct_ray_batch(jinfo, fc),
                                      trs.construct_ray_batch(tinfo, fc))
        assert (jh, jw) == (th, tw) and sorted(jb) == sorted(tb)
        for k in jb:
            np.testing.assert_array_equal(jb[k], tb[k])
    (jb, _, _), (tb, _, _) = (jrs.construct_nerf_ray_batch(jinfo),
                              trs.construct_nerf_ray_batch(tinfo))
    for k in jb:
        np.testing.assert_array_equal(jb[k], tb[k])
    o = np.array([[0.0, 0.0, -3.0], [0.5, 0.1, 2.0]])
    d = o / -np.linalg.norm(o, axis=-1, keepdims=True)
    for x, y in zip(jrs.near_far_from_sphere(o, d), trs.near_far_from_sphere(o, d)):
        np.testing.assert_array_equal(x, y)
    js, ts = jrs.RayStore(jb, 100, seed=3), trs.RayStore(tb, 100, seed=3)
    for _ in range(3):
        a, b = js.next_batch(), ts.next_batch()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("is_nerf,fixed", [(True, False), (False, False), (False, True)])
def test_compact_store_and_sample_rays(infos, is_nerf, fixed):
    """The store's tables equal the JAX store's; the sampled batch equals
    the JAX ``sample_rays`` and the host batch at atol 1e-5, for both
    camera conventions (the poses reinterpreted as w2c for the NeRO one)."""
    jinfo, tinfo = infos
    jstore = jdr.build_compact_store(jinfo, is_nerf, fixed)
    tstore = tdr.build_compact_store(tinfo, is_nerf, fixed, device="cpu")
    assert sorted(jstore) == sorted(tstore)
    for k in jstore:
        np.testing.assert_array_equal(np.asarray(jstore[k]), tstore[k].numpy())
    assert tstore["rgbs"].dtype == torch.uint8 and tstore["masks"].dtype == torch.uint8
    n = tdr.num_rays(tstore)
    assert n == jdr.num_rays(jstore)
    idx = np.random.RandomState(int(is_nerf) + 2 * int(fixed)).randint(0, n, 257)
    got = tdr.sample_rays(tstore, torch.as_tensor(idx))
    want = jdr.sample_rays({k: jnp.asarray(v) for k, v in jstore.items()}, jnp.asarray(idx))
    host, _, _ = (trs.construct_nerf_ray_batch(tinfo) if is_nerf
                  else trs.construct_ray_batch(tinfo, fixed))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32 and got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5, err_msg=k)
        np.testing.assert_allclose(got[k].numpy(), host[k][idx], atol=1e-5, err_msg=k)
    assert tstore["aux"].device.type == "cpu"


def test_metrics_match_jax(tmp_path):
    rs = np.random.RandomState(5)
    gt, pr = rs.rand(24, 20, 3), rs.rand(24, 20, 3)
    pr = 0.7 * gt + 0.3 * pr
    a, b = jmetrics.compute_psnr(gt, pr), tmetrics.compute_psnr(gt, pr)
    assert abs(a - b) <= 1e-6 * abs(a)
    assert abs(jmetrics.compute_ssim(gt, pr) - tmetrics.compute_ssim(gt, pr)) <= 1e-9
    assert abs(jmetrics.compute_ssim(gt[..., 0], pr[..., 0])
               - tmetrics.compute_ssim(gt[..., 0], pr[..., 0])) <= 1e-9
    imgs = [rs.rand(5, 4, 3), (rs.rand(7, 3) * 255).astype(np.uint8)]
    np.testing.assert_array_equal(jmetrics.concat_images_list(*imgs),
                                  tmetrics.concat_images_list(*imgs))
    np.testing.assert_array_equal(jmetrics.concat_images_list(*imgs, vert=True),
                                  tmetrics.concat_images_list(*imgs, vert=True))
    outputs = {"gt_rgb": gt.reshape(-1, 3), "ray_rgb": pr.reshape(-1, 3),
               "normal": rs.rand(480, 3), "roughness": rs.rand(480, 1)}
    jpath = jmetrics.dump_validation_images(outputs, 24, 20, str(tmp_path / "j"), "m", 7, 0)
    tpath = tmetrics.dump_validation_images(outputs, 24, 20, str(tmp_path / "t"), "m", 7, 0)
    assert tpath.endswith("m-step7-idx0.png") and jpath.endswith(".jpg")
    np.testing.assert_array_equal(cv2.imread(tpath)[..., ::-1],
                                  tmetrics.concat_images_list(
                                      tmetrics.concat_images_list(gt, pr, outputs["normal"]
                                                                  .reshape(24, 20, 3)),
                                      tmetrics.concat_images_list(
                                          np.repeat(outputs["roughness"].reshape(24, 20, 1),
                                                    3, -1)), vert=True))
