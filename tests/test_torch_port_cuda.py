"""K1, K2, K3, K4 and K5 on the card against their plain versions.

Needs an NVIDIA GPU with ``nvcc`` (the kernels are built at first use) and
skips elsewhere.  The file imports no JAX, so it runs on a machine that has
only PyTorch:

    python -m pytest -o addopts= --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerances, relative to each array's largest magnitude: f32 1e-5 forward and
1e-4 backward (sums in another order); bf16 1e-2 forward and 3e-2 backward
(hidden activations and cotangents rounded to bf16, where a rounding flips
with the sum order); K4 is held as a forward (``y``, ``j``) and K5 as a
backward (against autograd through K4's plain version).  K3 multiplies and adds without FMA contraction, one
rounding an operation as the plain version: ``t``, the triangle index and
``hit`` are held exactly.
"""

import math

import numpy as np
import pytest
import torch

from nunerf_tpu_torch.ops import fused_mlp as fm
from nunerf_tpu_torch.ops import ray_intersect as ri

SPECS = {
    # the SDF chain's shape: softplus100, a NeuS skip (1/sqrt(2)), 257 wide out
    "sdf": ((39, 256, 217, 256, 257), ("softplus100",) * 3 + ("none",),
            (False, False, True, False), (1.0, 1.0, 1 / math.sqrt(2), 1.0)),
    # a predictor head: relu chain with a 3-wide linear output
    "relu": ((131, 64, 64, 64, 3), ("relu",) * 3 + ("none",),
             (False,) * 4, (1.0,) * 4),
    # a material head: the input (feature + point) wider than the hidden layers
    "relu259": ((259, 256, 256, 256, 3), ("relu",) * 3 + ("none",),
                (False,) * 4, (1.0,) * 4),
    # the NeRF++ trunk's shape: a post-activation skip, every layer relu
    "trunk": ((84, 256, 256, 256), ("relu",) * 3, (False, False, True), (1.0,) * 3),
    # a skip on layer 1 and on the last layer, a relu among the activations
    "jac_skips": ((20, 64, 64, 64, 5), ("softplus100", "relu", "softplus100", "none"),
                  (False, True, False, True), (1.0, 0.5, 1.0, 0.7)),
}
TOL = {("fwd", "float32"): 1e-5, ("bwd", "float32"): 1e-4,
       ("fwd", "bfloat16"): 1e-2, ("bwd", "bfloat16"): 3e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _make(name, n, compute_dtype, dev, seed=5):
    dims, acts, skip, scales = SPECS[name]
    spec = fm.ChainSpec(dims, acts, skip, scales, compute_dtype=compute_dtype)
    rs = np.random.RandomState(seed)
    flat = [(rs.randn(*s) / np.sqrt(s[0])).astype(np.float32)
            for s in fm.flat_weight_shapes(spec)]
    flat += [rs.randn(1, d).astype(np.float32) * 0.1 for d in dims[1:]]
    x = rs.randn(n, dims[0]).astype(np.float32)
    g = rs.randn(n, dims[-1]).astype(np.float32)
    return spec, *(torch.as_tensor(a, device=dev) for a in (x, g)), \
        [torch.as_tensor(f, device=dev) for f in flat]


def _assert_close(a, e, rtol, what):
    err = float((a - e).abs().max())
    bound = rtol * float(e.abs().max())
    assert err <= bound, f"{what}: max err {err:.3e} > {bound:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,n", [("sdf", 1000), ("relu", 333), ("relu259", 333),
                                    ("trunk", 200)])
def test_kernels_match_plain_version(cuda, name, n, compute_dtype):
    spec, x, g, flat = _make(name, n, compute_dtype, cuda)
    leaves = [a.clone().requires_grad_(True) for a in [x] + flat]
    y_ref = fm.chain_mlp_reference(spec, *leaves)
    torch.sum(y_ref * g).backward()

    fm.reset_launches()
    y = fm.chain_fwd_cuda(spec, x, flat)
    dx, dflat = fm.chain_bwd_cuda(spec, x, g, flat)
    torch.cuda.synchronize()
    assert fm.launches["chain_fwd"] == 1 and fm.launches["chain_bwd"] == 1
    _assert_close(y, y_ref.detach(), TOL[("fwd", compute_dtype)], "K1")
    for i, (a, r) in enumerate(zip((dx,) + dflat, leaves)):
        _assert_close(a, r.grad, TOL[("bwd", compute_dtype)], f"K2 grad {i}")


@pytest.mark.cuda
def test_autograd_function_runs_the_kernels(cuda):
    spec, x, g, flat = _make("relu", 200, "float32", cuda)
    leaves = [a.clone().requires_grad_(True) for a in [x] + flat]
    fm.reset_launches()
    torch.sum(fm.fused_chain_mlp(spec, *leaves) * g).backward()
    assert fm.launches["chain_fwd"] == 1 and fm.launches["chain_bwd"] == 1
    ref = [a.clone().requires_grad_(True) for a in [x] + flat]
    torch.sum(fm.chain_mlp_reference(spec, *ref) * g).backward()
    for a, r in zip(leaves, ref):
        _assert_close(a.grad, r.grad, TOL[("bwd", "float32")], "grad")
    # a CUDA tensor the kernel does not take raises: no plain fallback
    with pytest.raises(ValueError):
        fm.fused_chain_mlp(spec, x.double(), *flat)


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,n", [("sdf", 1000), ("jac_skips", 333), ("sdf", 64)])
def test_jacobian_kernels_match_plain_version(cuda, monkeypatch, name, n, compute_dtype):
    """K4 (y, j) and K5 (dx, every dW, every db); 40 rows a chunk, so that
    the ragged cases also cross chunks whose last one is short."""
    monkeypatch.setattr(fm, "JAC_CHUNK_ROWS", 40 * 16)
    spec, x, gy, flat = _make(name, n, compute_dtype, cuda)
    gj = torch.as_tensor(np.random.RandomState(9).randn(*x.shape).astype(np.float32),
                         device=cuda)
    leaves = [a.clone().requires_grad_(True) for a in [x] + flat]
    y_ref, j_ref = fm.chain_mlp_with_grad0_reference(spec, *leaves)
    (torch.sum(y_ref * gy) + torch.sum(j_ref * gj)).backward()

    fm.reset_launches()
    y, j = fm.chain_jac_fwd_cuda(spec, x, flat)
    dx, dflat = fm.chain_jac_bwd_cuda(spec, x, gy, gj, flat)
    torch.cuda.synchronize()
    assert fm.launches == {"chain_fwd": 0, "chain_bwd": 0, "chain_jac_fwd": 1,
                           "chain_jac_bwd": 1}
    _assert_close(y, y_ref.detach(), TOL[("fwd", compute_dtype)], "K4 y")
    _assert_close(j, j_ref.detach(), TOL[("bwd", compute_dtype)], "K4 j")
    for i, (a, r) in enumerate(zip((dx,) + dflat, leaves)):
        _assert_close(a, r.grad, TOL[("bwd", compute_dtype)], f"K5 grad {i}")


@pytest.mark.cuda
def test_grad0_autograd_function_runs_the_kernels(cuda):
    spec, x, gy, flat = _make("sdf", 200, "float32", cuda)
    leaves = [a.clone().requires_grad_(True) for a in [x] + flat]
    fm.reset_launches()
    y, j = fm.chain_mlp_with_grad0(spec, *leaves)
    (torch.sum(y * gy) + torch.sum(j ** 2)).backward()
    assert fm.launches["chain_jac_fwd"] == 1 and fm.launches["chain_jac_bwd"] == 1
    ref = [a.clone().requires_grad_(True) for a in [x] + flat]
    yr, jr = fm.chain_mlp_with_grad0_reference(spec, *ref)
    (torch.sum(yr * gy) + torch.sum(jr ** 2)).backward()
    for a, r in zip(leaves, ref):
        _assert_close(a.grad, r.grad, TOL[("bwd", "float32")], "grad")
    # a CUDA tensor the kernels do not take raises: no plain fallback
    with pytest.raises(ValueError):
        fm.chain_mlp_with_grad0(spec, x.double(), *flat)


def _sphere_soup(n_lat, n_lon, radius=0.5, pad_to=256):
    """(v0, e1, e2) of a latitude/longitude sphere, padded with far-away
    degenerate triangles to a multiple of ``pad_to``."""
    th = np.linspace(0.0, np.pi, n_lat + 1)
    ph = np.linspace(0.0, 2 * np.pi, n_lon, endpoint=False)
    grid = np.stack([np.outer(np.sin(th), np.cos(ph)), np.outer(np.sin(th), np.sin(ph)),
                     np.outer(np.cos(th), np.ones_like(ph))], -1) * radius
    tris = []
    for i in range(n_lat):
        for j in range(n_lon):
            a, b = grid[i, j], grid[i, (j + 1) % n_lon]
            c, d = grid[i + 1, j], grid[i + 1, (j + 1) % n_lon]
            tris += [(a, c, b), (b, c, d)]
    tv = np.asarray(tris, np.float32)
    v0, e1, e2 = tv[:, 0], tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0]
    pad = (-len(v0)) % pad_to
    v0 = np.concatenate([v0, np.full((pad, 3), 1e8, np.float32)])
    e1 = np.concatenate([e1, np.zeros((pad, 3), np.float32)])
    e2 = np.concatenate([e2, np.zeros((pad, 3), np.float32)])
    return v0, e1, e2, len(tv)


def _rays(n, seed):
    """A third each: from outside towards the sphere, from inside it, and
    pointing away from it (misses)."""
    rs = np.random.RandomState(seed)
    d = rs.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.empty((n, 3), np.float32)
    k = np.arange(n) % 3
    target = rs.randn(n, 3).astype(np.float32) * 0.2
    o[k == 0] = (target - 2.0 * d)[k == 0]
    o[k == 1] = (rs.rand(n, 3).astype(np.float32) * 0.4 - 0.2)[k == 1]
    o[k == 2] = (target + 2.0 * d)[k == 2]
    return o, d


@pytest.mark.cuda
@pytest.mark.parametrize("n_rays", [1, 1024, 5000])
@pytest.mark.parametrize("n_lat,n_lon", [(6, 8), (90, 180)])
def test_closest_hit_matches_plain_version(cuda, n_rays, n_lat, n_lon):
    v0, e1, e2, n_tris = _sphere_soup(n_lat, n_lon)
    o, d = _rays(n_rays, seed=n_rays)
    tri = [torch.as_tensor(a, device=cuda) for a in (v0, e1, e2)]
    ro, rd = torch.as_tensor(o, device=cuda), torch.as_tensor(d, device=cuda)
    ri.reset_launches()
    t, idx, hit = ri.ray_mesh_closest_hit(ro, rd, *tri)
    # without the padding rows, which can never be hit: the same answer
    t2, idx2, hit2 = ri.ray_mesh_closest_hit(ro, rd, *(a[:n_tris] for a in tri))
    torch.cuda.synchronize()
    assert ri.launches == {"closest_hit": 2}
    rt, ridx, rhit = ri.closest_hit_reference(ro, rd, *tri)
    for a, b in ((t, rt), (idx, ridx), (hit, rhit), (t2, rt), (idx2, ridx), (hit2, rhit)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    if n_rays >= 1024:
        k = torch.arange(n_rays, device=cuda) % 3
        assert hit[k == 0].float().mean() > 0.9 and hit[k == 1].all()
        assert not hit[k == 2].any()
        assert (idx[~hit] == 0).all() and (t[~hit] == ri.MISS_T).all()
    # the same answer on the CPU from the plain version
    ct, cidx, chit = ri.ray_mesh_closest_hit(
        torch.as_tensor(o), torch.as_tensor(d), *(torch.as_tensor(a) for a in (v0, e1, e2)))
    assert torch.equal(chit, hit.cpu())
    np.testing.assert_allclose(ct.numpy(), t.cpu().numpy(), rtol=1e-5)


@pytest.mark.cuda
def test_closest_hit_ties_and_refusals(cuda):
    # two coincident triangles: the lowest index wins whatever the chunking
    tri = np.array([[[-1, -1, 1], [1, -1, 1], [0, 1, 1]]], np.float32)
    tv = np.repeat(tri, 2000, axis=0)
    v0, e1, e2 = tv[:, 0], tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0]
    ro = torch.zeros((300, 3), device=cuda)
    rd = torch.tensor([[0.0, 0.0, 1.0]], device=cuda).repeat(300, 1)
    t, idx, hit = ri.closest_hit_cuda(ro, rd, *(torch.as_tensor(a, device=cuda)
                                                for a in (v0, e1, e2)))
    assert hit.all() and (idx == 0).all() and torch.allclose(t, torch.ones_like(t))
    # a CUDA tensor the kernel does not take raises: no plain fallback
    with pytest.raises(ValueError):
        ri.ray_mesh_closest_hit(ro.double(), rd.double(),
                                *(torch.as_tensor(a, device=cuda) for a in (v0, e1, e2)))
    with pytest.raises(ValueError):
        ri.closest_hit_cuda(ro.cpu(), rd.cpu(), *(torch.as_tensor(a) for a in (v0, e1, e2)))
