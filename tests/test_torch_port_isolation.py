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
    assert int(n) >= 27, res.stdout
    assert bad == "[]", bad


def test_probe_walks_the_stage2_modules():
    """The import probe above reaches every module of the second slice."""
    import pkgutil

    import nunerf_tpu_torch
    names = {m.name for m in pkgutil.walk_packages(nunerf_tpu_torch.__path__,
                                                   "nunerf_tpu_torch.")}
    for mod in ("tracing.mesh_ops", "tracing.intersect", "tracing.scene",
                "ops.ray_intersect", "models.stage2", "convert"):
        assert f"nunerf_tpu_torch.{mod}" in names, mod


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

    # stage 2: the scene and the renderer resolve the device the same way
    import numpy as np
    from nunerf_tpu_torch.models.stage2 import Stage2Renderer
    from nunerf_tpu_torch.tracing.scene import Scene

    tri = (np.array([[0, 0, 1], [1, 0, 1], [0, 1, 1]], np.float32), np.array([[0, 1, 2]]))
    with pytest.raises(RuntimeError, match="CUDA"):
        Scene(tri)
    scene = Scene(tri, device="cpu")
    assert scene.device.type == "cpu" and not scene.use_kernel
    cfg = {"sdf_n_layers": 2, "stage1_cfg": {"sdf_n_layers": 2}}
    with pytest.raises(RuntimeError, match="CUDA"):
        Stage2Renderer(cfg, scene, r)
    r2 = Stage2Renderer(cfg, scene, r, device="cpu")
    assert all(p.device.type == "cpu" for p in r2.parameters())
    assert not any(p.requires_grad for p in r2.stage1.parameters())
