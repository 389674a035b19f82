"""The JAX side of ``tests/test_torch_port_stage2_schedule.py``, run in a
spawned process of its own for each kind (f32, float64, bf16), so that the
three traces, each about 11 s of Python, run side by side while the test's
own process steps the port.

``steps`` builds JAX's zero-thickness ``Stage2Renderer`` on the mesh,
traces ``tools/trained_step_compare.py``'s step once (``ShellJaxSide``,
which steps any stage-2 renderer: Adam at the config's warm-up cosine
schedule on ``train``, nothing on ``frozen``; in float64 JAX's float32 pins
lifted and the step an int64), compiles it with the kind's XLA options and
runs it at each case from a fresh Adam state.  It returns, a case, (terms,
outputs, gradients, lr): the outputs and the gradients of the ``train``
subtree as numpy in the step's own dtype, flat by JAX path (the ``frozen``
subtree's are checked zero here, and not sent), and the lr of the
config's ``warm_up_cos_schedule`` at the case's step.
"""

import importlib.util
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool():
    spec = importlib.util.spec_from_file_location(
        "trained_step_compare", os.path.join(ROOT, "tools", "trained_step_compare.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fresh_adam(params):
    import jax
    import numpy as np

    zero = jax.tree_util.tree_map(np.zeros_like, params["train"])
    return {"count": 0, "exp_avg": {"train": zero}, "exp_avg_sq": {"train": zero}}


def warm():
    """A spawned worker's start: JAX on the CPU with the tests' persistent
    compilation cache (``tests/conftest.py``), and the imports of
    ``steps``, made while the parent builds the cases."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_compilation_cache_dir",
                      os.path.join(os.path.dirname(os.path.abspath(__file__)), ".jax_cache_cpu"))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 5.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    import optax  # noqa: F401
    import torch

    torch.set_num_threads(1)
    import nunerf_tpu.models.stage2  # noqa: F401
    import nunerf_tpu.tracing.scene  # noqa: F401


def steps(kind, cfg, mesh, s1_params, cases, options=None, renderer=None):
    """JAX's step of ``kind`` at ``cases``, a list of (parameters, batch,
    step), in a worker that ``warm`` started; returns [(terms, outputs,
    gradients, lr)] in their order.  ``renderer``: the stage-2 renderer's
    class (the zero-thickness ``Stage2Renderer`` unless given)."""
    import numpy as np

    from nunerf_tpu.models.stage2 import Stage2Renderer
    from nunerf_tpu.tracing.scene import Scene
    from nunerf_tpu.train.lr import warm_up_cos_schedule

    renderer = renderer or Stage2Renderer
    side = _tool().ShellJaxSide(renderer(cfg, scene=Scene(mesh, tile=512),
                                         stage1_params=s1_params), kind == "f64")
    params, batch, step = cases[0]
    side.load(params, _fresh_adam(params))
    side.compiled = side.lower(batch, step).compile(compiler_options=options)
    lr = dict(cfg["lr_cfg"])
    schedule = warm_up_cos_schedule(lr=lr.get("lr", 5e-4), end_warm=lr["end_warm"],
                                    end_iter=lr["end_iter"])
    out = []
    for params, batch, step in cases:
        side.load(params, _fresh_adam(params))
        terms, grads, _ = side.step(batch, step)
        for k, v in grads.items():
            if k.startswith("frozen/") and np.asarray(v).any():
                raise AssertionError(f"JAX's {kind} step gave the frozen {k} a gradient")
        out.append((terms, side.outputs,
                    {k: v for k, v in grads.items() if not k.startswith("frozen/")},
                    float(schedule(step))))
    return out
