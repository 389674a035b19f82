"""The port stands alone: no module of ``nunerf_tpu_torch``, nor
``chip_smoke.py``, loads JAX or the JAX package; its entry points run on
CUDA unless the caller asks for the CPU, and raise when CUDA is missing."""

import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import nunerf_tpu_torch
names = [m.name for m in pkgutil.walk_packages(nunerf_tpu_torch.__path__,
                                                "nunerf_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "nunerf_tpu"))
print(len(names), bad)
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    n, bad = res.stdout.strip().splitlines()[-1].split(" ", 1)
    assert int(n) >= 20, res.stdout
    assert bad == "[]", bad


def test_entry_points_need_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    from nunerf_tpu_torch.device import resolve_device
    from nunerf_tpu_torch.models.stage1 import ShapeRenderer

    with pytest.raises(RuntimeError, match="CUDA"):
        ShapeRenderer({"sdf_n_layers": 2})
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    r = ShapeRenderer({"sdf_n_layers": 2}, device="cpu")
    assert r.device.type == "cpu" and not r.fused_sdf_value
    assert all(p.device.type == "cpu" for p in r.parameters())
