"""The port's relighting path against the JAX package's: the material export
(``cli relight``) on the same checkpoint, the pose helpers and the
principled node graph of ``tools/relight_backend.py``, and its ``main()``
behind the ``bpy`` stub of ``tests/test_relight.py``.

The export is f32 on both sides (mixed precision off): the SDF trunk's
features and the material heads are sums of a few hundred products in
another order, held at rtol 1e-5 of each array's largest entry.  The pose
math and the node graph are the same numpy and Python code: equal.
"""

import contextlib
import io
import os
import sys
from argparse import Namespace

import jax
import numpy as np
import pytest
import torch

from nunerf_tpu.cli import cmd_relight as jcmd_relight
from nunerf_tpu.tools import relight_backend as jrb
from nunerf_tpu.tracing.mesh_ops import extract_geometry, save_ply
from nunerf_tpu.train.trainer import save_checkpoint
from nunerf_tpu_torch import cli
from nunerf_tpu_torch.tools import relight_backend as prb
from port_helpers import assert_close
from test_relight import _GOLDEN, _FakeMaterial, _make_bpy_stub

CFG_YAML = """
name: relight_test
network: shape
database_name: nerf/unused
is_nerf: true
zero_thickness: true
sdf_n_layers: 4
mixed_precision: false
sdf_mixed_precision: false
shader_config: {sphere_direction: false, human_light: false}
loss: [nerf_render]
"""


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    root = tmp_path_factory.mktemp("relight")
    cfg_path = str(root / "cfg.yaml")
    with open(cfg_path, "w") as f:
        f.write(CFG_YAML)
    from nunerf_tpu.config import load_cfg
    from nunerf_tpu.models.stage1 import ShapeRenderer
    params = ShapeRenderer(load_cfg(cfg_path)).init_params(jax.random.PRNGKey(7))
    ckpt = str(root / "model.ckpt")
    save_checkpoint(ckpt, 0, params, {}, 0.0)
    verts, tris = extract_geometry(lambda p: np.linalg.norm(p, axis=-1) - 0.5,
                                   resolution=24, bound=1.0)
    mesh = str(root / "mesh.ply")
    save_ply(mesh, verts, tris)
    jcmd_relight(Namespace(cfg=cfg_path, ckpt=ckpt, mesh=mesh, output=str(root / "jax")))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        arrays = cli.main(["relight", "--cfg", cfg_path, "--ckpt", ckpt, "--mesh", mesh,
                           "--output", str(root / "port"), "--device", "cpu"])
    return root, mesh, len(verts), arrays, buf.getvalue().strip().splitlines()


def test_material_export_matches_jax(exports):
    root, _, nv, arrays, printed = exports
    assert printed == [f"materials written to {root / 'port'}"]
    for name, width in (("metallic", 1), ("roughness", 1), ("albedo", 3)):
        got = np.load(root / "port" / f"{name}.npy")
        want = np.load(root / "jax" / f"{name}.npy")
        assert got.shape == (nv, width) and got.dtype == np.float32
        np.testing.assert_array_equal(got, arrays[name])
        assert_close(got, want, rtol=1e-5, what=name)
        assert abs(float(got.mean()) - _GOLDEN[name]) < 2e-3, name


def test_pose_helpers_equal_jax():
    for frame in ("z-up", "y-up"):
        p = prb.relighting_poses(7, azimuth_deg=30.0, elevation_deg=45.0, dist=3.0,
                                 frame=frame)
        np.testing.assert_array_equal(p, jrb.relighting_poses(7, 30.0, 45.0, 3.0, frame))
        for pose in p:
            for a, b in zip(prb.blender_camera_transform(pose),
                            jrb.blender_camera_transform(pose)):
                np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        prb.relighting_poses(3, frame="x-up")
    rs = np.random.RandomState(3)
    for _ in range(20):
        q, _r = np.linalg.qr(rs.randn(3, 3))
        q *= np.sign(np.linalg.det(q))
        np.testing.assert_array_equal(prb.quat_from_rotation(q), jrb.quat_from_rotation(q))


def test_principled_graph_equals_jax():
    def records(mod):
        mat = _FakeMaterial()
        bsdf, _ = mod.build_principled_graph(mat, "albedo", "mat_mr")
        links = [(f.type_name, f.layer_name, fn, t.type_name, tn)
                 for f, fn, t, tn in mat.node_tree.links.records]
        return links, {k: s.default_value for k, s in bsdf.inputs.items()}

    links, defaults = records(prb)
    assert (links, defaults) == records(jrb)
    assert len(links) == 4 and defaults["Specular"] == 0.5


def test_backend_main_behind_a_bpy_stub(exports, monkeypatch):
    root, mesh, nv, _, _ = exports
    hdr = str(root / "env.hdr")
    with open(hdr, "wb") as f:
        f.write(b"hdr")
    rendered = []
    bpy, attrs = _make_bpy_stub(nv, rendered)
    monkeypatch.setitem(sys.modules, "bpy", bpy)
    monkeypatch.setattr(sys, "argv", [
        "blender", "--", "--mesh", mesh, "--materials", str(root / "port"), "--hdr", hdr,
        "--out", str(root / "renders"), "--n-views", "3", "--resolution", "8"])
    prb.main()
    a = np.load(root / "port" / "albedo.npy")
    m = np.load(root / "port" / "metallic.npy")
    r = np.load(root / "port" / "roughness.npy")
    np.testing.assert_array_equal(attrs["albedo"]["color"].reshape(nv, 4)[:, :3], a)
    mr = attrs["mat_mr"]["color"].reshape(nv, 4)
    np.testing.assert_array_equal(mr[:, 0], m[:, 0])
    np.testing.assert_array_equal(mr[:, 1], r[:, 0])
    assert len(rendered) == 3 and all(os.path.exists(p) for p in rendered)
