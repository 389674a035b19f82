"""The port's native mesh library (``nunerf_tpu_torch/native``) against the
JAX package's defaults (CPU).

The mesh is the lumpy sphere that ``chip_smoke.py`` marches (radius 0.5
+- 0.05), here at 64^3.  The JAX package runs its own copy of ``meshops``
by default, so extraction, normals, curvature and the remesh are held for
bit-equality; the port's numpy versions are held to the JAX package's numpy
branch, which the tests reach by making the JAX loader return no library
(a monkeypatch: no file of the JAX package changes).
"""

import os

import numpy as np
import pytest

from nunerf_tpu.tracing import mesh_ops as jm
from nunerf_tpu_torch.native import build
from nunerf_tpu_torch.tracing import mesh_ops as pm

RES = 64


def _lumpy(p):
    r = np.linalg.norm(p, axis=-1)
    return r - (0.5 + 0.05 * np.sin(7 * p[..., 0]) * np.cos(7 * p[..., 1]))


@pytest.fixture(scope="module")
def marched():
    return pm.extract_geometry(_lumpy, resolution=RES)


@pytest.fixture(scope="module")
def remeshed(marched):
    return pm.isotropic_remesh(*marched)


def _equal(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_extraction_is_bit_equal_to_jax_and_to_numpy(marched):
    verts, tris = marched
    assert (len(verts), len(tris)) == (14324, 28644)
    _equal(marched, jm.extract_geometry(_lumpy, resolution=RES))
    _equal(marched, pm.extract_geometry(_lumpy, resolution=RES, native=False))
    # the parts' seconds, which the CLI reports
    times = {}
    _equal(marched, pm.extract_geometry(_lumpy, resolution=RES, times=times))
    assert sorted(times) == ["dedup_s", "grid_s", "march_s", "sweep_s"]
    assert all(v >= 0 for v in times.values())


@pytest.mark.parametrize("which", ["marched", "remeshed"])
def test_normals_curvature_bit_equal_to_jax(request, which):
    verts, tris = request.getfixturevalue(which)
    normals, curv = pm.vertex_normals_curvature(verts, tris)
    _equal((normals, curv), jm.vertex_normals_curvature(verts, tris))
    assert (curv > 0).any() and (curv < 0).any()
    assert np.abs(curv).max() <= 10.0


def test_remesh_array_equal_to_jax(marched, remeshed):
    rv, rt = remeshed
    assert (len(rv), len(rt)) == (10757, 21530)
    _equal(remeshed, jm.isotropic_remesh(*marched))
    # the numpy version snaps to another grid: a different mesh
    nv, nt = pm.isotropic_remesh(*marched, native=False)
    assert (len(nv), len(nt)) != (len(rv), len(rt))


def test_numpy_versions_equal_the_jax_numpy_branch(monkeypatch, marched, remeshed):
    monkeypatch.setattr(jm, "get_lib", lambda: None)
    verts, tris = marched
    _equal(pm.vertex_normals_curvature(verts, tris, native=False),
           jm.vertex_normals_curvature(verts, tris))
    _equal(pm.vertex_normals_curvature(*remeshed, native=False),
           jm.vertex_normals_curvature(*remeshed))
    _equal(pm.isotropic_remesh(verts, tris, native=False), jm.isotropic_remesh(verts, tris))
    _equal(pm.extract_geometry(_lumpy, resolution=24, native=False),
           jm.extract_geometry(_lumpy, resolution=24))
    # the native and numpy curvatures differ: f32 against f64 sums
    _, c_native = pm.vertex_normals_curvature(verts, tris)
    _, c_numpy = pm.vertex_normals_curvature(verts, tris, native=False)
    assert not np.array_equal(c_native, c_numpy)


def test_empty_inputs():
    v, t = pm.marching_tetrahedra_native(np.ones((4, 4, 4), np.float32), 0.0)
    assert v.shape == (0, 3) and t.shape == (0, 3)
    assert v.dtype == np.float32 and t.dtype == np.int32
    v, t = pm.extract_geometry(lambda p: np.ones(len(p), np.float32), resolution=8)
    assert v.shape == (0, 3) and t.shape == (0, 3)
    ev, et = pm.isotropic_remesh(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32))
    jv, jt = jm.isotropic_remesh(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32))
    assert ev.shape == jv.shape and et.shape == jt.shape


def test_library_lands_in_the_port_build_directory():
    lib = build.get_lib()
    port = os.path.dirname(os.path.dirname(os.path.abspath(build.__file__)))
    assert build.LIB == os.path.join(port, "build", "libmeshops.so")
    assert os.path.exists(build.LIB)
    assert os.path.getmtime(build.LIB) >= os.path.getmtime(build.SRC)
    for name in ("extract_isosurface", "vertex_normals_curvature", "cluster_remesh",
                 "bvh_build", "meshops_free"):
        assert hasattr(lib, name), name
    assert "nunerf_tpu_torch" in build.LIB and os.sep + "nunerf_tpu" + os.sep not in build.LIB


def test_failing_compiler_raises(monkeypatch, tmp_path):
    """No silent fallback: a failed build raises, and the callers with it."""
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "LIB", str(tmp_path / "libmeshops.so"))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "CXX", "false")
    with pytest.raises(RuntimeError, match="failed"):
        build.get_lib()
    with pytest.raises(RuntimeError, match="failed"):
        pm.vertex_normals_curvature(np.eye(3, dtype=np.float32), np.array([[0, 1, 2]]))
    assert not os.path.exists(build.LIB)
    assert os.listdir(tmp_path) == []  # the temporary output is removed
    # a source newer than the library is rebuilt (here: refused again)
    monkeypatch.setattr(build, "CXX", "g++")
    build.get_lib()
    assert os.path.exists(build.LIB)
    os.utime(build.LIB, (0, 0))
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "CXX", "false")
    with pytest.raises(RuntimeError, match="failed"):
        build.get_lib()
