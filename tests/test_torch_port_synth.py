"""``nunerf_tpu_torch/tools/synth_nested.py`` against
``nunerf_tpu/tools/synth_nested.py``: the same numpy code, so every array is
held equal to the bit; the written datasets decode to the same images (the
JAX package writes them through ``cv2``, the port through ``image_io``), with
the same transforms, ``meta.json``, point samples, object cloud and COLMAP
model (both models read back by the port's reader).
"""

import json
import os

import cv2
import numpy as np
import pytest

from nunerf_tpu.tools import synth_nested as js
from nunerf_tpu_torch.data import image_io
from nunerf_tpu_torch.data.colmap import read_model
from nunerf_tpu_torch.data.database import read_ply_points
from nunerf_tpu_torch.tools import synth_nested as ps


def _rays(n=300, seed=0):
    rs = np.random.RandomState(seed)
    o = np.tile(np.array([[0.1, -0.2, 2.0]]), (n, 1))
    d = rs.randn(n, 3) * 0.25
    d[:, 2] = -1.0
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


@pytest.mark.parametrize("tracer", ["trace_rays", "trace_rays_hollow"])
def test_tracers_and_views_equal_jax(tracer):
    o, d = _rays()
    for a, b in zip(getattr(ps, tracer)(o, d), getattr(js, tracer)(o, d)):
        np.testing.assert_array_equal(a, b)
    c2w = js._look_at(np.array([1.5, -1.2, 0.7]))
    np.testing.assert_array_equal(ps._look_at(np.array([1.5, -1.2, 0.7])), c2w)
    np.testing.assert_array_equal(
        ps.render_view(c2w, 12, 16, 20.0, tracer=getattr(ps, tracer)),
        js.render_view(c2w, 12, 16, 20.0, tracer=getattr(js, tracer)))


def test_gt_surface_points_equal_jax():
    for a, b in zip(ps.gt_surface_points(500, seed=3), js.gt_surface_points(500, seed=3)):
        np.testing.assert_array_equal(a, b)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _same_tree(proot, jroot):
    assert _files(proot) == _files(jroot)
    for rel in _files(jroot):
        p, j = os.path.join(proot, rel), os.path.join(jroot, rel)
        if rel.endswith(".png"):
            want = cv2.imread(j, cv2.IMREAD_UNCHANGED)
            if want.ndim == 3:
                want = want[..., [2, 1, 0, 3]] if want.shape[-1] == 4 else want[..., ::-1]
            np.testing.assert_array_equal(image_io.imread(p), want, err_msg=rel)
        elif rel.endswith(".json"):
            assert json.load(open(p)) == json.load(open(j)), rel
        elif rel.endswith(".npy"):
            np.testing.assert_array_equal(np.load(p), np.load(j), err_msg=rel)
        elif rel.endswith(".ply"):
            np.testing.assert_array_equal(read_ply_points(p), read_ply_points(j))
        elif rel.endswith(".txt"):
            np.testing.assert_array_equal(np.loadtxt(p), np.loadtxt(j))


@pytest.mark.parametrize("shell", [False, True])
def test_make_nested_scene_equals_jax(tmp_path, shell):
    for side, mod in (("port", ps), ("jax", js)):
        mod.make_nested_scene(str(tmp_path / side), n_train=2, n_test=1, h=32, w=32,
                              shell=shell)
    _same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))
    meta = json.load(open(tmp_path / "port" / "meta.json"))
    assert meta["mode"] == ("shell" if shell else "solid")


def test_make_colmap_scene_equals_jax(tmp_path):
    for side, mod in (("port", ps), ("jax", js)):
        mod.make_colmap_scene(str(tmp_path / side), n_views=3, h=32, w=40, shell=True)
    _same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))
    pc, pi, pp = read_model(str(tmp_path / "port" / "colmap/sparse/0"))
    jc, ji, jp = read_model(str(tmp_path / "jax" / "colmap/sparse/0"))
    assert sorted(pc) == sorted(jc) and sorted(pi) == sorted(ji) and pp == jp == {}
    for k in jc:
        assert (pc[k].model, pc[k].width, pc[k].height) == (jc[k].model, jc[k].width,
                                                            jc[k].height)
        np.testing.assert_array_equal(pc[k].params, jc[k].params)
    for k in ji:
        assert (pi[k].name, pi[k].camera_id) == (ji[k].name, ji[k].camera_id)
        np.testing.assert_array_equal(pi[k].qvec, ji[k].qvec)
        np.testing.assert_array_equal(pi[k].tvec, ji[k].tvec)
