"""``nunerf_tpu_torch/tracing/mesh_reg.py`` against ``nunerf_tpu/tracing/mesh_reg.py``.

The topology is host numpy on both sides: equal to the element (the port's
stable sorts against the JAX loops), on a closed marched sphere and on one
with an open boundary, a non-manifold edge (three faces) and isolated
vertices.  The energies are f32 on both sides: sums of a few thousand terms
in another order, rtol 1e-5 of the value; their ``verts`` gradients against
``jax.grad`` at rtol 1e-4 of the largest entry (the gradients of a variance
subtract the mean from each term, which loses a digit more).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nunerf_tpu.tracing import mesh_reg as jreg
from nunerf_tpu.tracing.mesh_ops import extract_geometry
from nunerf_tpu_torch.tracing import mesh_reg as preg
from port_helpers import assert_close


def _sphere():
    return extract_geometry(lambda p: np.linalg.norm(p, axis=-1) - 0.5, resolution=16)


def _odd_mesh():
    """The sphere less its first 5 faces (an open boundary), plus a third face
    on the edge of the last face's first two vertices and a triangle of
    three vertices of their own."""
    v, t = _sphere()
    n = len(v)
    rs = np.random.RandomState(0)
    extra_v = (rs.randn(5, 3) * 0.3).astype(np.float32)
    keep = t[5:]
    a, b = keep[-1, 0], keep[-1, 1]
    assert sum({a, b} <= set(f) for f in keep.tolist()) == 2
    extra_t = np.array([[b, a, n], [n + 2, n + 3, n + 4]])
    return np.concatenate([v, extra_v]), np.concatenate([keep, extra_t])


MESHES = {"sphere": _sphere, "odd": _odd_mesh}


@pytest.mark.parametrize("name", sorted(MESHES))
def test_topology_equals_jax(name):
    v, t = MESHES[name]()
    jt = jreg.build_topology(t, len(v))
    pt = preg.build_topology(t, len(v))
    for f in jt._fields:
        a, b = getattr(pt, f), getattr(jt, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert preg.is_watertight(pt) == jreg.is_watertight(jt) == (name == "sphere")


def test_topology_of_no_faces():
    jt = jreg.build_topology(np.zeros((0, 3), np.int64), 4)
    pt = preg.build_topology(np.zeros((0, 3), np.int64), 4)
    for f in jt._fields:
        np.testing.assert_array_equal(getattr(pt, f), getattr(jt, f), err_msg=f)
        assert getattr(pt, f).shape == getattr(jt, f).shape, f


ENERGIES = ("edge_length_variance", "face_area_variance", "dihedral_angle_energy")


@pytest.mark.parametrize("name", sorted(MESHES))
@pytest.mark.parametrize("energy", ENERGIES)
def test_energies_and_gradients_match_jax(name, energy):
    v, t = MESHES[name]()
    rs = np.random.RandomState(1)
    v = (v + 0.01 * rs.randn(*v.shape)).astype(np.float32)
    topo_j = jreg.build_topology(t, len(v))
    topo_p = preg.build_topology(t, len(v))
    fj, fp = getattr(jreg, energy), getattr(preg, energy)
    val_j, g_j = jax.value_and_grad(lambda x: fj(x, topo_j))(jnp.asarray(v))
    vt = torch.tensor(v, requires_grad=True)
    val_p = fp(vt, topo_p)
    val_p.backward()
    assert_close(val_p, np.asarray(val_j), rtol=1e-5, what=energy)
    assert_close(vt.grad, np.asarray(g_j), rtol=1e-4, what=f"d {energy}/d verts")


@pytest.mark.parametrize("name", sorted(MESHES))
def test_laplacian_smooth_matches_jax(name):
    """v - mean(one-ring): a mean of at most a dozen terms, subtracted from a
    vertex, within 1e-6 of the vertices' scale (one rounding of it); its
    gradient through a weighted sum at 1e-5."""
    v, t = MESHES[name]()
    topo_j = jreg.build_topology(t, len(v))
    topo_p = preg.build_topology(t, len(v))
    w = np.random.RandomState(2).randn(*v.shape).astype(np.float32)
    val_j, g_j = jax.value_and_grad(
        lambda x: jnp.sum(jreg.laplacian_smooth(x, topo_j) * w))(jnp.asarray(v))
    vt = torch.tensor(v, requires_grad=True)
    lap = preg.laplacian_smooth(vt, topo_p)
    torch.sum(lap * torch.as_tensor(w)).backward()
    assert_close(lap, np.asarray(jreg.laplacian_smooth(jnp.asarray(v), topo_j)), rtol=0.0,
                 atol=1e-6 * np.abs(v).max(), what="laplacian")
    assert_close(vt.grad, np.asarray(g_j), rtol=1e-5, what="d laplacian")
