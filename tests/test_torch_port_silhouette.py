"""The silhouette and regulariser queries of the port's ``Scene``
(``tracing/silhouette.py``) against the JAX ``Scene`` of the same mesh.

A sphere marched at 24^3 (a few thousand triangles: both scenes run the
brute sweep with the barycentric tolerance 1e-6 on the CPU), one camera.
``silhouette_edges``, and ``primary_visibility``'s ``index`` and ``valid``,
are decisions on the same f32 inputs: equal.  ``value`` is 0.5 on both
sides.  The ``verts`` gradient of a weighted coverage goes through the
custom backward (``edge_sample_coverage``) and the projection: f32 products
of a few terms a vertex, rtol 1e-5 of the largest entry.  The two-bounce
queries (``trace2``, ``render_transparent``, ``render_mask``), as
``tests/test_silhouette.py`` drives them, against the JAX scene: hit masks
equal, positions and directions within 1e-5 of their scale (f32 Snell
refraction with its square root, evaluated in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nunerf_tpu.tracing.mesh_ops import extract_geometry
from nunerf_tpu.tracing.scene import Scene as JScene
from nunerf_tpu_torch.tracing.scene import Scene
from nunerf_tpu_torch.tracing.silhouette import edge_sample_coverage
from port_helpers import assert_close

H = W = 48


@pytest.fixture(scope="module")
def scenes():
    verts, tris = extract_geometry(lambda p: np.linalg.norm(p, axis=-1) - 0.5,
                                   resolution=24, bound=1.0)
    return JScene((verts, tris)), Scene((verts, tris), device="cpu")


def camera(offset=(0.0, 0.0)):
    """OpenCV world->cam pose of a camera on +z looking down -z, K, origin."""
    focal = 60.0
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]], np.float32)
    R = np.diag([1.0, -1.0, -1.0]).astype(np.float32)
    origin = np.array([offset[0], offset[1], 2.0], np.float32)
    pose = np.concatenate([R, (-R @ origin)[:, None]], -1).astype(np.float32)
    return pose, K, origin


def test_topology_and_silhouette_edges_match_jax(scenes):
    js, ps = scenes
    for f in js.topology._fields:
        np.testing.assert_array_equal(getattr(ps.topology, f), getattr(js.topology, f))
    for origin in ([0.0, 0.0, 100.0], [0.3, -1.2, 1.7]):
        origin = np.asarray(origin, np.float32)
        je, jm = js.silhouette_edge(origin)
        pe, pm = ps.silhouette_edge(origin)
        np.testing.assert_array_equal(pe.numpy(), np.asarray(je))
        np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
        assert pm.sum() > 10


@pytest.mark.parametrize("detach_depth", [False, True])
def test_primary_visibility_and_its_gradient_match_jax(scenes, detach_depth):
    js, ps = scenes
    pose, K, origin = camera((0.05, -0.03))
    jout = js.primary_visibility(pose, K, origin, (H, W), detach_depth=detach_depth)
    pout = ps.primary_visibility(pose, K, origin, (H, W), detach_depth=detach_depth)
    for k in ("index", "valid"):
        np.testing.assert_array_equal(pout[k].numpy(), np.asarray(jout[k]), err_msg=k)
    np.testing.assert_array_equal(pout["value"].numpy(), np.asarray(jout["value"]))
    assert pout["valid"].sum() > 10

    w = np.random.RandomState(0).randn(len(js.topology.edges)).astype(np.float32)

    def jloss(v):
        o = js.primary_visibility(pose, K, origin, (H, W), verts=v, detach_depth=detach_depth)
        return jnp.sum(jnp.where(o["valid"], o["value"], 0.0) * w)

    g_j = jax.grad(jloss)(js.verts)
    v = ps.verts.clone().requires_grad_(True)
    o = ps.primary_visibility(pose, K, origin, (H, W), verts=v, detach_depth=detach_depth)
    torch.sum(torch.where(o["valid"], o["value"], torch.zeros_like(o["value"]))
              * torch.as_tensor(w)).backward()
    assert (v.grad.norm(dim=-1) > 0).sum() > 10
    assert_close(v.grad, np.asarray(g_j), rtol=1e-5, what="d coverage / d verts")


def test_edge_sample_coverage_backward_matches_the_custom_vjp():
    """The backward alone: g * f * (-N) to both endpoints, None to f."""
    rs = np.random.RandomState(3)
    e_pos = rs.randn(7, 2, 2).astype(np.float32) * 10
    f = rs.choice([-1.0, 0.0, 1.0], 7).astype(np.float32)
    g = rs.randn(7).astype(np.float32)
    from nunerf_tpu.tracing.silhouette import edge_sample_coverage as jcov
    val_j, vjp = jax.vjp(lambda e: jcov(e, jnp.asarray(f)), jnp.asarray(e_pos))
    e = torch.tensor(e_pos, requires_grad=True)
    ft = torch.tensor(f, requires_grad=True)
    val = edge_sample_coverage(e, ft)
    val.backward(torch.as_tensor(g))
    np.testing.assert_array_equal(val.detach().numpy(), np.asarray(val_j))
    assert_close(e.grad, np.asarray(vjp(jnp.asarray(g))[0]), rtol=1e-6, what="d e_pos")
    assert ft.grad is None


def test_two_bounce_queries_match_jax(scenes):
    js, ps = scenes
    # 64 rays from (0, 0, 2) toward points of the disc of radius 0.6 at z = 0
    # (most enter the sphere of radius 0.5, some miss it), and the centre ray
    rs = np.random.RandomState(0)
    target = np.concatenate([rs.uniform(-0.6, 0.6, (64, 2)), np.zeros((64, 1))], 1)
    o = np.tile(np.array([[0.0, 0.0, 2.0]]), (65, 1)).astype(np.float32)
    d = np.concatenate([target - o[:64], [[0.0, 0.0, -1.0]]])
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    to, td = torch.as_tensor(o), torch.as_tensor(d)
    jo, jd = jnp.asarray(o), jnp.asarray(d)

    jo2, jd2, jok = js.trace2(jo, jd)
    po2, pd2, pok = ps.trace2(to, td)
    np.testing.assert_array_equal(pok.numpy(), np.asarray(jok))
    assert pok.sum() > 10 and bool(pok[-1])
    assert_close(po2, np.asarray(jo2), rtol=1e-5, what="trace2 o")
    assert_close(pd2, np.asarray(jd2), rtol=1e-5, what="trace2 d")

    joo, jdd, jmask = js.render_transparent(jo, jd)
    poo, pdd, pmask = ps.render_transparent(to, td)
    np.testing.assert_array_equal(pmask.numpy(), np.asarray(jmask))
    assert pmask.sum() > 0
    assert_close(poo, np.asarray(joo), rtol=1e-5, what="render_transparent o")
    assert_close(pdd, np.asarray(jdd), rtol=1e-5, what="render_transparent d")
    np.testing.assert_array_equal(ps.render_mask(to, td).numpy(),
                                  np.asarray(js.render_mask(jo, jd)))
