"""The JAX side of ``tests/test_torch_port_real_schedule.py``, run in spawned
processes (one a config and kind), so that the JAX traces run side by side
while the test's own process steps the port.

``stage1`` jits JAX's stage-1 ``value_and_grad`` (``train_outputs`` then
``compute_losses``) once, with the step traced, and runs it at each case:
the occlusion subset's priorities are injected where it traces
(``jax.random.uniform`` of a one-dimensional shape, the subset's, returns
``RandomState(priority_seed).rand`` of that shape, as the test hands the
port), and ``jax.lax.top_k`` hands each subset's candidates to
the host.  In float64 the trace runs with JAX's float32 pins lifted
(``tools/trained_step_compare.py``'s ``jax_layers_in_f64``, and the
init-SDF anneal's cast of the step to float32) and the step is an int64.

``shell`` builds JAX's ``Stage2ShellRenderer`` on the mesh and steps it as
``stage2_schedule_jax.steps`` steps the zero-thickness renderer
(``ShellJaxSide``: the trainer's step, Adam at the config's warm-up cosine
from a fresh state a case).
"""

import stage2_schedule_jax


def warm():
    """A spawned worker's start (``stage2_schedule_jax.warm``) and the
    imports of both sides."""
    stage2_schedule_jax.warm()
    import nunerf_tpu.models.stage1  # noqa: F401
    import nunerf_tpu.models.stage2_shell  # noqa: F401


def stage1(kind, cfg, batch, cases, priority_seed, k, options=None):
    """JAX's stage-1 step of ``kind`` ("f32", "f64" or "bf16") at each of
    ``cases``, a list of (parameters, step): [(terms, gradients by JAX
    path, [candidate mask of each subset])], numpy in float64; ``k`` is the
    subset's size."""
    import contextlib

    import jax
    import jax.numpy as jnp
    import numpy as np

    from nunerf_tpu.models.stage1 import ShapeRenderer
    from nunerf_tpu.train.loss import compute_losses
    from nunerf_tpu_torch.convert import flat_leaves

    tsc = stage2_schedule_jax._tool()
    f64 = kind == "f64"
    fdt = jnp.float64 if f64 else jnp.float32
    # in float64 the step too, so that what JAX computes from it (the anneal
    # ratio) is float64 as the port's is
    idt = jnp.int64 if f64 else jnp.int32
    found = []
    real_uniform, real_top_k = jax.random.uniform, jax.lax.top_k

    def uniform(key, shape=(), *a, **kw):
        if len(shape) == 1:
            return jnp.asarray(np.random.RandomState(priority_seed).rand(shape[0])
                               .astype(np.float32), fdt)
        return real_uniform(key, shape, *a, **kw)

    def top_k(x, kk):
        if kk == k:
            jax.debug.callback(lambda p: found.append(np.asarray(p) >= 0), x)
        return real_top_k(x, kk)

    with jax.enable_x64(f64):
        renderer = ShapeRenderer(cfg)
        jbatch = {key: jnp.asarray(v, fdt) for key, v in batch.items()}

        def loss_fn(p, step):
            out = renderer.train_outputs(p, jbatch, jax.random.PRNGKey(1), step)
            terms = compute_losses(out, jbatch, step, renderer.cfg)
            return terms["loss_total"], terms

        def cast(params):
            return jax.tree_util.tree_map(lambda x: jnp.asarray(x, fdt), params)

        jax.random.uniform, jax.lax.top_k = uniform, top_k
        reg = ShapeRenderer._init_sdf_reg
        if f64:
            # JAX's init-SDF anneal reads the step as float32: one more pin,
            # lifted as the layers' are
            ShapeRenderer._init_sdf_reg = staticmethod(
                lambda points, sdf, step: reg(points, sdf, step.astype(points.dtype)))
        try:
            with tsc.jax_layers_in_f64() if f64 else contextlib.nullcontext():
                fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True)).lower(
                    cast(cases[0][0]), jnp.asarray(cases[0][1], idt)).compile(
                        compiler_options=options)
        finally:
            jax.random.uniform, jax.lax.top_k = real_uniform, real_top_k
            ShapeRenderer._init_sdf_reg = staticmethod(reg)
        out = []
        for params, step in cases:
            p = cast(params)
            found.clear()
            (_, terms), grads = fn(p, jnp.asarray(step, idt))
            jax.effects_barrier()
            out.append(({key: float(v) for key, v in terms.items()},
                        {key: np.asarray(v, np.float64)
                         for key, v in flat_leaves(grads).items()},
                        list(found)))
    return out


def shell(kind, cfg, mesh, s1_params, cases, options=None):
    """JAX's shell stage-2 step of ``kind`` at ``cases``, a list of
    (parameters, batch, step): [(terms, outputs, trainable gradients, lr)]
    (``stage2_schedule_jax.steps`` on the shell renderer)."""
    from nunerf_tpu.models.stage2_shell import Stage2ShellRenderer

    return stage2_schedule_jax.steps(kind, cfg, mesh, s1_params, cases, options,
                                     renderer=Stage2ShellRenderer)
