"""The port stands alone: no module of ``nunerf_tpu_torch``, nor
``chip_smoke.py``, loads JAX, the JAX package, the repository's tests or
(when imported) OpenCV, which the machine with the card lacks; its entry
points run on CUDA unless the caller asks for the CPU, and raise when CUDA
is missing."""

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
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "nunerf_tpu", "cv2",
                                    "tests", "scene_utils", "port_helpers"))
print(len(names), bad)
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    n, bad = res.stdout.strip().splitlines()[-1].split(" ", 1)
    assert int(n) >= 60, res.stdout
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


def test_probe_walks_the_data_and_trainer_modules():
    """The import probe reaches every module of the data layer and the
    training loop, and importing the benchmark runs nothing."""
    import pkgutil

    import nunerf_tpu_torch
    names = {m.name for m in pkgutil.walk_packages(nunerf_tpu_torch.__path__,
                                                   "nunerf_tpu_torch.")}
    for mod in ("data.image_io", "data.colmap", "data.database", "data.ray_store",
                "data.device_rays", "train.metrics", "train.trainer", "utils.debug",
                "utils.profiling", "models", "bench"):
        assert f"nunerf_tpu_torch.{mod}" in names, mod


def test_probe_walks_the_pipeline_modules():
    """The import probe reaches the native mesh library's build module, the shell,
    the chamfer and the CLI, and importing the CLI runs nothing."""
    import pkgutil

    import nunerf_tpu_torch
    names = {m.name for m in pkgutil.walk_packages(nunerf_tpu_torch.__path__,
                                                   "nunerf_tpu_torch.")}
    for mod in ("native", "native.build", "models.stage2_shell", "ops.chamfer", "cli"):
        assert f"nunerf_tpu_torch.{mod}" in names, mod


def test_probe_walks_the_tool_modules():
    """The import probe reaches the tools, the silhouette and regulariser
    queries and the sphere tracer."""
    import pkgutil

    import nunerf_tpu_torch
    names = {m.name for m in pkgutil.walk_packages(nunerf_tpu_torch.__path__,
                                                   "nunerf_tpu_torch.")}
    for mod in ("tools", "tools.render_mask", "tools.outer_filter", "tools.synth_nested",
                "tools.relight_backend", "tracing.mesh_reg", "tracing.silhouette",
                "ops.sphere_tracing"):
        assert f"nunerf_tpu_torch.{mod}" in names, mod


def test_probe_walks_the_parallel_modules():
    """The import probe reaches data parallelism's modules, and importing
    them joins no process group."""
    import pkgutil

    import nunerf_tpu_torch
    names = {m.name for m in pkgutil.walk_packages(nunerf_tpu_torch.__path__,
                                                   "nunerf_tpu_torch.")}
    for mod in ("parallel", "parallel.mesh", "parallel.multihost"):
        assert f"nunerf_tpu_torch.{mod}" in names, mod
    import nunerf_tpu_torch.parallel.multihost  # noqa: F401
    assert not torch.distributed.is_initialized()


def test_probe_walks_the_leg_runner_modules():
    """The import probe reaches the leg runner, the shell's scorer and the
    leg's surface report."""
    import pkgutil

    import nunerf_tpu_torch
    names = {m.name for m in pkgutil.walk_packages(nunerf_tpu_torch.__path__,
                                                   "nunerf_tpu_torch.")}
    for mod in ("pipeline", "tools.eval_shell", "tools.leg_geometry"):
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
    assert not r.fused and not r.fused_sdf  # the opt-in gates default to off
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

    # the training loop and the benchmark
    from nunerf_tpu_torch import bench
    from nunerf_tpu_torch.train.trainer import Trainer

    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer({"name": "x", "model_dir": "/nonexistent"})
    assert bench.main() == 2

    # the tools
    from nunerf_tpu_torch.tools import outer_filter, render_mask

    with pytest.raises(RuntimeError, match="CUDA"):
        outer_filter.visible_faces(*tri)
    with pytest.raises(RuntimeError, match="CUDA"):
        render_mask.erode_masks({"database_name": "nerf/x", "dataset_dir": "/nonexistent"})

    # the shell's scorer
    from nunerf_tpu_torch.tools.eval_shell import eval_shell

    with pytest.raises(RuntimeError, match="CUDA"):
        eval_shell({"name": "x"}, {}, "/nonexistent/model.ckpt")
