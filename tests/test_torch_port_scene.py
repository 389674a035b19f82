"""The port's mesh operations and ``Scene`` against the JAX package (CPU, f32).

One marched mesh, made by the port's extractor, is handed to both scenes;
rays are made with numpy from a seed.  Both packages compute vertex normals,
curvature and the remesh in their copies of one C++ library (``meshops``),
so these are equal to the bit.  Scene queries are then f32 sums in another
order: 1e-5 relative to each output's scale, masks exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from nunerf_tpu.tracing import mesh_ops as jm
from nunerf_tpu.tracing.scene import Scene as JScene
from nunerf_tpu_torch.tracing import mesh_ops as pm
from nunerf_tpu_torch.tracing.scene import Scene
from port_helpers import assert_close, t


def _sphere(p):
    return np.linalg.norm(p, axis=-1) - 0.5


@pytest.fixture(scope="module")
def mesh():
    return pm.extract_geometry(_sphere, resolution=16)


@pytest.fixture(scope="module")
def scenes(mesh):
    return Scene(mesh, tile=512, device="cpu"), JScene(mesh, tile=512)


def _camera_rays(n, seed=0, spread=0.35):
    rs = np.random.RandomState(seed)
    o = np.tile(np.array([[0.0, 0.0, -2.5]], np.float32), (n, 1))
    d = rs.randn(n, 3).astype(np.float32) * spread - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d.astype(np.float32)


def test_marching_tetrahedra_and_extract_match_jax_numpy_path():
    xs = np.linspace(-1, 1, 10, dtype=np.float32)
    grid = _sphere(np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), -1)).astype(np.float32)
    pv, pt = pm.marching_tetrahedra_np(grid, 0.0)
    jv, jt = jm.marching_tetrahedra_np(grid, 0.0)
    np.testing.assert_array_equal(pv, jv)
    np.testing.assert_array_equal(pt, jt)
    assert len(pt) > 100
    # the whole extractor: a closed surface at radius 0.5, in world coords
    verts, tris = pm.extract_geometry(_sphere, resolution=16)
    np.testing.assert_allclose(np.linalg.norm(verts, axis=-1), 0.5, atol=0.02)
    edges = np.sort(np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]]), 1)
    _, counts = np.unique(edges, axis=0, return_counts=True)
    assert (counts == 2).all()
    # two slabs stitch to the same surface as one
    v2, t2 = pm.extract_geometry(_sphere, resolution=16, slab=9)
    assert len(t2) == len(tris)
    g = pm.extract_fields(_sphere, 12, batch=5)
    np.testing.assert_array_equal(g, jm.extract_fields(_sphere, 12, batch=5))


def test_normals_curvature_smoothing_remesh_match_jax(mesh):
    verts, tris = mesh
    pn, pc = pm.vertex_normals_curvature(verts, tris)
    jn, jc = jm.vertex_normals_curvature(verts, tris)
    assert pn.dtype == pc.dtype == np.float32
    np.testing.assert_array_equal(pn, jn)
    np.testing.assert_array_equal(pc, jc)
    # outward normals on a sphere
    assert (np.sum(pn * verts, -1) > 0.4).all()
    np.testing.assert_array_equal(pm.smooth_vertex_scalar(pc, tris, 5),
                                  jm.smooth_vertex_scalar(pc, tris, 5))
    dv, dt = pm.dedup_vertices(verts[tris].reshape(-1, 3), np.arange(3 * len(tris)).reshape(-1, 3))
    jdv, jdt = jm.dedup_vertices(verts[tris].reshape(-1, 3), np.arange(3 * len(tris)).reshape(-1, 3))
    np.testing.assert_array_equal(dv, jdv)
    np.testing.assert_array_equal(dt, jdt)
    # vertex clustering: the same vertices and triangles
    rv, rt = pm.isotropic_remesh(verts, tris, target_edge=0.2)
    jrv, jrt = jm.isotropic_remesh(verts, tris, target_edge=0.2)
    assert 0 < len(rt) < len(tris)
    np.testing.assert_array_equal(rv, jrv)
    np.testing.assert_array_equal(rt, jrt)


def test_ply_round_trip(tmp_path, mesh):
    verts, tris = mesh
    path = str(tmp_path / "m.ply")
    pm.save_ply(path, verts, tris)
    for load in (pm.load_ply, jm.load_ply):
        v, f = load(path)
        np.testing.assert_array_equal(v, verts)
        np.testing.assert_array_equal(f, tris)
    jpath = str(tmp_path / "j.ply")
    jm.save_ply(jpath, verts, tris)
    assert open(path, "rb").read() == open(jpath, "rb").read()
    apath = str(tmp_path / "a.ply")
    with open(apath, "w") as fh:
        fh.write("ply\nformat ascii 1.0\nelement vertex 3\nproperty float x\n"
                 "property float y\nproperty float z\nelement face 1\n"
                 "property list uchar int vertex_indices\nend_header\n"
                 "0 0 0\n1 0 0\n0 1 0\n3 0 1 2\n")
    v, f = pm.load_ply(apath)
    assert v.shape == (3, 3) and f.tolist() == [[0, 1, 2]]
    scene = Scene(path, device="cpu")
    assert len(scene.tris_np) == len(tris) and scene.v0.shape[0] % scene.tile == 0


def test_scene_choice_of_sweep(mesh):
    """The brute sweep below the threshold, the culled descent from there
    on; ``use_kernel`` resolves from the device."""
    brute = Scene(mesh, device="cpu")
    culled = Scene(mesh, cull_threshold=100, device="cpu")
    jculled = JScene(mesh, cull_threshold=100)
    assert not brute.use_kernel and brute.tile_index is None
    assert culled.tile_index is not None and culled.cull_group == jculled.cull_group
    assert culled.tile_index.v0.shape == jculled.tile_index.v0.shape
    o, d = _camera_rays(64)
    hb, hc = brute.intersect(t(o), t(d)), culled.intersect(t(o), t(d))
    jh = jculled.intersect(o, d)
    assert torch.equal(hb.hit, hc.hit)
    np.testing.assert_array_equal(hc.hit.numpy(), np.asarray(jh.hit))
    np.testing.assert_allclose(hc.t.numpy(), np.asarray(jh.t), rtol=1e-6)
    np.testing.assert_allclose(hb.t.numpy(), hc.t.numpy(), rtol=1e-6)


def test_dintersect_matches_jax_with_gradients(scenes):
    import jax

    ps, js = scenes
    o, d = _camera_rays(48)
    jout = js.dintersect(jnp.asarray(o), jnp.asarray(d))
    po, pd = t(o).requires_grad_(True), t(d).requires_grad_(True)
    pout = ps.dintersect(po, pd)
    assert sorted(pout) == sorted(jout)
    hit = np.asarray(jout["hit"])
    assert 8 < hit.sum() < 48  # hits and misses both present
    for k, e in jout.items():
        a, e = pout[k].detach().numpy(), np.asarray(e)
        if k in ("hit", "tri_idx"):
            np.testing.assert_array_equal(a, e, err_msg=k)
        elif k == "curvature":  # inherits the curvature tolerance above
            assert_close(a, e, 0.0, atol=1e-2, what=k)
        else:
            assert_close(a, e, 1e-5, what=k)
    # missed lanes carry dummies: origin, zero normal, MISS_T
    miss = ~hit
    np.testing.assert_array_equal(pout["pos"].detach().numpy()[miss], o[miss])
    assert not pout["normal"].detach().numpy()[miss].any()
    assert (pout["t"].detach().numpy()[miss] == np.float32(1e7)).all()

    w = np.random.RandomState(1).randn(48, 3).astype(np.float32)

    def jloss(o_, d_):
        r = js.dintersect(o_, d_)
        return jnp.sum((r["pos"] + r["normal"]) * w)

    jg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(o), jnp.asarray(d))
    torch.sum((pout["pos"] + pout["normal"]) * t(w)).backward()
    for a, e in zip((po.grad, pd.grad), jg):
        assert torch.isfinite(a).all()
        assert_close(a, np.asarray(e), 1e-4, what="grad")


def test_refract_trace2_transparent_mask_match_jax(scenes):
    ps, js = scenes
    o, d = _camera_rays(64, seed=2)
    jo, jd = jnp.asarray(o), jnp.asarray(d)

    ji = js.dintersect(jo, jd)
    pi_ = ps.dintersect(t(o), t(d))
    for a, e in zip(ps.refract_ray(pi_, t(d)), js.refract_ray(ji, jd)):
        e = np.asarray(e)
        if e.dtype == bool:
            np.testing.assert_array_equal(a.numpy(), e)
        else:
            assert_close(a, e, 1e-5, what="refract_ray")

    for fn in ("trace2", "render_transparent"):
        pres = getattr(ps, fn)(t(o), t(d))
        jres = getattr(js, fn)(jo, jd)
        ok = np.asarray(jres[2])
        assert 8 < ok.sum() < 64, fn
        np.testing.assert_array_equal(pres[2].numpy(), ok, err_msg=fn)
        # two refractions deep: 1e-4 of the scale
        assert_close(pres[0], np.asarray(jres[0]), 1e-4, what=fn + " o")
        assert_close(pres[1], np.asarray(jres[1]), 1e-4, what=fn + " d")
    # the exit rays are unit vectors that leave the sphere
    o2, d2, ok = ps.trace2(t(o), t(d))
    np.testing.assert_allclose(torch.linalg.norm(d2[ok], dim=-1).numpy(), 1.0, atol=1e-5)
    assert (torch.sum(d2[ok] * o2[ok], -1) > 0).all()

    np.testing.assert_array_equal(ps.render_mask(t(o), t(d)).numpy(),
                                  np.asarray(js.render_mask(jo, jd)))
    assert ps.render_mask(t(o), t(d)).dtype == torch.float32


def test_unsigned_distance_matches_jax(scenes):
    ps, js = scenes
    pts = np.random.RandomState(3).uniform(-0.9, 0.9, (300, 3)).astype(np.float32)
    a = ps.unsigned_distance(pts, chunk=128)
    e = js.unsigned_distance(pts, chunk=128)
    assert a.dtype == np.float32
    np.testing.assert_allclose(a, e, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(a, np.abs(np.linalg.norm(pts, axis=-1) - 0.5), atol=0.02)
