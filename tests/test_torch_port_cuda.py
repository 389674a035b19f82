"""K1 and K2 on the card against their plain version.

Needs an NVIDIA GPU with ``nvcc`` (the kernels are built at first use) and
skips elsewhere.  The file imports no JAX, so it runs on a machine that has
only PyTorch:

    python -m pytest -o addopts= --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerances, relative to each array's largest magnitude: f32 1e-5 forward and
1e-4 backward (sums in another order); bf16 1e-2 forward and 3e-2 backward
(hidden activations and cotangents rounded to bf16, where a rounding flips
with the sum order).
"""

import math

import numpy as np
import pytest
import torch

from nunerf_tpu_torch.ops import fused_mlp as fm

SPECS = {
    # the SDF chain's shape: softplus100, a NeuS skip (1/sqrt(2)), 257 wide out
    "sdf": ((39, 256, 217, 256, 257), ("softplus100",) * 3 + ("none",),
            (False, False, True, False), (1.0, 1.0, 1 / math.sqrt(2), 1.0)),
    # a predictor head: relu chain with a 3-wide linear output
    "relu": ((131, 64, 64, 64, 3), ("relu",) * 3 + ("none",),
             (False,) * 4, (1.0,) * 4),
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
@pytest.mark.parametrize("name,n", [("sdf", 1000), ("relu", 333)])
def test_kernels_match_plain_version(cuda, name, n, compute_dtype):
    spec, x, g, flat = _make(name, n, compute_dtype, cuda)
    leaves = [a.clone().requires_grad_(True) for a in [x] + flat]
    y_ref = fm.chain_mlp_reference(spec, *leaves)
    torch.sum(y_ref * g).backward()

    fm.reset_launches()
    y = fm.chain_fwd_cuda(spec, x, flat)
    dx, dflat = fm.chain_bwd_cuda(spec, x, g, flat)
    torch.cuda.synchronize()
    assert fm.launches == {"chain_fwd": 1, "chain_bwd": 1}
    _assert_close(y, y_ref.detach(), TOL[("fwd", compute_dtype)], "K1")
    for i, (a, r) in enumerate(zip((dx,) + dflat, leaves)):
        _assert_close(a, r.grad, TOL[("bwd", compute_dtype)], f"K2 grad {i}")


@pytest.mark.cuda
def test_autograd_function_runs_the_kernels(cuda):
    spec, x, g, flat = _make("relu", 200, "float32", cuda)
    leaves = [a.clone().requires_grad_(True) for a in [x] + flat]
    fm.reset_launches()
    torch.sum(fm.fused_chain_mlp(spec, *leaves) * g).backward()
    assert fm.launches == {"chain_fwd": 1, "chain_bwd": 1}
    ref = [a.clone().requires_grad_(True) for a in [x] + flat]
    torch.sum(fm.chain_mlp_reference(spec, *ref) * g).backward()
    for a, r in zip(leaves, ref):
        _assert_close(a.grad, r.grad, TOL[("bwd", "float32")], "grad")
    # a CUDA tensor the kernel does not take raises: no plain fallback
    with pytest.raises(ValueError):
        fm.fused_chain_mlp(spec, x.double(), *flat)
