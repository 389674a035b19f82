"""``nunerf_tpu_torch/ops/sphere_tracing.py`` against
``nunerf_tpu/ops/sphere_tracing.py`` (CPU, f32).

Two SDFs: an analytic sphere of radius 0.5 and a small stage-1 SDF (4
layers, the JAX init jittered by 5 %) whose weights go to the port through
``convert.py``.  Rays from a 16x16 camera grid, the corners missing the
bounding sphere.  Each march step decides lanes by ``|sdf| < threshold`` on
f32 values that agree to about 1e-6 (sums in another order), so ``hit`` and
``iterations`` are held equal.  ``depth`` and ``points`` are held to 1e-6
of their scale plus ten times the port's own f32 error against the port's
march in float64 (``assert_close_calibrated``): on the rays that hit, the
two packages differ by at most 4.8e-7 and the port's f32 error is 2.4e-7;
a ray that grazes the surface and never converges adds up 61 ill-conditioned
steps, whose f32 depths differ by up to 6.4e-4 between the packages and by
3.2e-4 from float64 (measured on the network SDF).  Normals from autograd
(``eps`` 0, rtol 1e-5) and from central differences (``eps`` 1e-3, whose
quotient divides an f32 difference by 2e-3: 1e-3 of the normal's length).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nunerf_tpu.models.stage1 import ShapeRenderer as JShapeRenderer
from nunerf_tpu.ops import sphere_tracing as jst
from nunerf_tpu_torch.convert import load_jax_params
from nunerf_tpu_torch.models.stage1 import PARAM_KEYS, ShapeRenderer
from nunerf_tpu_torch.ops import sphere_tracing as pst
from port_helpers import assert_close, assert_close_calibrated, jitter_tree

CFG = {"sdf_n_layers": 4, "mixed_precision": False, "sdf_mixed_precision": False}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rays(n=16):
    """A camera at (0.3, -0.2, 2.2) looking at the origin, pixels over a
    field wide enough that the corners miss the unit sphere."""
    o = np.array([0.3, -0.2, 2.2], np.float32)
    u, v = np.meshgrid(np.linspace(-0.7, 0.7, n), np.linspace(-0.7, 0.7, n))
    fwd = -o / np.linalg.norm(o)
    right = np.cross(fwd, [0.0, 1.0, 0.0])
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    d = fwd + u.reshape(-1, 1) * right + v.reshape(-1, 1) * up
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return np.tile(o, (n * n, 1)), d


@pytest.fixture(scope="module")
def sdfs():
    jr = JShapeRenderer(CFG)
    params = jitter_tree(jr.init_params(jax.random.PRNGKey(0)), 1, 0.05)
    pr = ShapeRenderer(CFG, device="cpu")
    load_jax_params(pr, params, PARAM_KEYS)
    pr64 = ShapeRenderer(CFG, device="cpu")
    load_jax_params(pr64, params, PARAM_KEYS)
    pr64.double()

    def sphere(p):
        return torch.linalg.norm(p, dim=-1, keepdim=True) - 0.5

    return {
        "sphere": (lambda p: jnp.linalg.norm(p, axis=-1, keepdims=True) - 0.5, sphere,
                   sphere),
        "stage1": (jax.jit(lambda p: jr.sdf(params, p)), pr.sdf, pr64.sdf),
    }


@pytest.mark.parametrize("which", ["sphere", "stage1"])
def test_sphere_trace_matches_jax(sdfs, which):
    jfn, pfn, pfn64 = sdfs[which]
    o, d = _rays()
    jres = jst.sphere_trace(jfn, jnp.asarray(o), jnp.asarray(d), max_iters=64,
                            threshold=1e-4)
    pres = pst.sphere_trace(pfn, torch.as_tensor(o), torch.as_tensor(d), max_iters=64,
                            threshold=1e-4)
    np.testing.assert_array_equal(pres.hit.numpy(), np.asarray(jres.hit))
    assert pres.iterations == int(jres.iterations)
    assert 0 < int(pres.hit.sum()) < len(o)
    p64 = pst.sphere_trace(pfn64, torch.as_tensor(o).double(), torch.as_tensor(d).double(),
                           max_iters=64, threshold=1e-4)
    assert torch.equal(p64.hit, pres.hit)
    assert_close_calibrated(pres.depth, np.asarray(jres.depth), p64.depth, rtol=1e-6,
                            what="depth")
    assert_close_calibrated(pres.points, np.asarray(jres.points), p64.points, rtol=1e-6,
                            what="points")

    hit = pres.hit.numpy()
    pts = np.asarray(jres.points)[hit]
    for eps, tol in ((0.0, 1e-5), (1e-3, 1e-3)):
        jn = np.asarray(jst.sdf_normals(jfn, jnp.asarray(pts), eps=eps))
        pn = pst.sdf_normals(pfn, torch.as_tensor(pts), eps=eps)
        assert_close(pn, jn, rtol=tol, what=f"normals eps={eps}")


def test_sphere_trace_stops_where_the_jax_loop_stops():
    """A march capped at 3 steps, and rays that all miss: the count."""
    o, d = _rays()
    sphere = (lambda p: jnp.linalg.norm(p, axis=-1, keepdims=True) - 0.5,
              lambda p: torch.linalg.norm(p, dim=-1, keepdim=True) - 0.5)
    j = jst.sphere_trace(sphere[0], jnp.asarray(o), jnp.asarray(d), max_iters=3)
    p = pst.sphere_trace(sphere[1], torch.as_tensor(o), torch.as_tensor(d), max_iters=3)
    assert p.iterations == int(j.iterations) == 3
    far = o + 10.0
    j = jst.sphere_trace(sphere[0], jnp.asarray(far), jnp.asarray(d))
    p = pst.sphere_trace(sphere[1], torch.as_tensor(far), torch.as_tensor(d))
    assert p.iterations == int(j.iterations) == 0
    assert not bool(p.hit.any()) and not bool(np.asarray(j.hit).any())
