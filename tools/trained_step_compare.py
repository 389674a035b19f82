"""Hold the port's training step to the JAX package's on trained weights: a
checkpoint of the port's ``front`` leg (stage 1) or ``shell_stage2`` leg
(the shell's stage 2) loaded into both packages, every random draw of the
step injected into both, on the CPU.

    python tools/trained_step_compare.py f64 CKPT [CKPT ...] [--moments FULL] [--rays N]
    python tools/trained_step_compare.py traj CKPT [--steps 100] [--every 25] [--rays N]
    python tools/trained_step_compare.py init OUT [--rays N]
    python tools/trained_step_compare.py shell-f64 CKPT [CKPT ...] --workdir W [--moments FULL]
    python tools/trained_step_compare.py shell-render CKPT --workdir W [--views 0,1,...]
    python tools/trained_step_compare.py shell-traj CKPT --workdir W [--steps 25] [--control]

``CKPT`` is a checkpoint of the port's trainer (``save_checkpoint``: the
parameters as a JAX tree, Adam's ``count``, ``exp_avg`` and ``exp_avg_sq``
by the same paths).  One that holds no Adam state
takes the moments of the full checkpoint ``--moments``, with its own step as
the count.  Both packages read the same arrays: the port through
``Trainer.load``, the JAX ``Trainer`` as its parameters and as optax's Adam
state (``ScaleByAdamState`` and the schedule's count), so that both lr
schedules stand at the checkpoint's step.

The config is ``configs/shape/nerf/nested.yaml`` as the leg trains it with
``leg_geometry --train-f32`` (``mixed_precision`` and ``sdf_mixed_precision``
off): full width, 64 + 64 SDF samples, ``perturb`` 1.0 through
``sample_ray_partitioned``, ``occ_loss_max_pn`` 2,048, ``outer_reg`` from
step 20,000.  ``--rays`` cuts the rays a step (the config resolves 512),
never a width.  The scene is ``synth-scene``'s, made in ``--scene`` when it
is missing, as the leg makes it.

Injected at each step, from ``numpy.random.RandomState(seed + step)``: the
ray indices (the port's batch through ``Trainer.batch``, JAX's through
``sample_rays``), the four draws of ``sample_ray_partitioned`` in the order
both packages ask for them (front and back gap fractions, the background
tail, the chord jitter of ``_hierarchical_inner``) and the occlusion
subset's priorities: ``jax.random.uniform`` and ``torch.rand`` hand out the
next array, checked by shape (``jax_draws``, ``torch_draws``).

``f64``: one step at each checkpoint, in float64 on both sides, with one
batch (JAX's, cast) given to both.  JAX's layers pin float32 even on float64
operands (``preferred_element_type``, the heads' casts), so its float64
step would round every layer's output to f32; the tool lifts those pins
(``jax_layers_in_f64``).  Prints each loss term of both, each
leaf's gradient and update gap over its scale (JAX's largest magnitude),
the occlusion candidates (count, equal or not, the subset's size) and the
count of ``spec_mask``, and whether every term and gradient agrees to
``RTOL_LOSS`` / ``RTOL_GRAD`` (those of ``test_torch_port_leg_schedule.py``).

``traj``: ``--steps`` steps from the checkpoint in f32 in each package, each
with its own batch; every ``--every`` steps the distance between the two
packages' parameters (global L2, and over the distance JAX's moved from the
checkpoint), the mean of every loss term of each over the span, the steps
whose candidates differ, and each package's median zero-crossing radius of
its SDF along ``N_DIRS`` fixed directions (the outermost change from inside
to outside on radii 0..1).  ``--control`` runs JAX against JAX from the
checkpoint with every parameter one f32 ulp up, in place of the port: the
rate at which f32 roundings alone part two runs.  Each point also reads
each side's stage-1 shader transmission weight ``T``
(``transmission_weight``, through which stage 2 sees behind the outer
interface) at ``N_T_POINTS`` points of the scene's outer sphere
(``r_outer`` of its ``meta.json``): its 1st, 50th and 99th percentiles,
computed by the port's shader on each side's parameters.

``init``: writes to ``OUT`` the port trainer's step-0 checkpoint of the
leg's config (its initialisation at the config's ``random_seed``, Adam's
moments zero and its count 0), the state both packages start ``traj``
from.

The shell modes run in ``--workdir``, the shell legs' working directory
(``python -m nunerf_tpu_torch.pipeline shell_front`` then ``shell_stage2``):
both packages' trainers read the stage-2 config the leg wrote there, its
stage-1 checkpoint and the outer mesh it traced.  A step's one draw is its
rays (``shell_indices``).  ``shell-f64``: one step at each checkpoint in
float64 in both packages (``--rays``, 128 unless given, of the config's
1,024), every width and sample count the config's, with JAX's float32 pins
lifted and its step an int64; the record as ``f64``'s, with the worst
gradient gap of each head (``by_head``), the freeze flags and the inner
inv_s (``shell_flags``).  ``shell-render``: both packages render the
validation view and the test views in f32 (the config's bf16 switches
off, as in every shell mode) through their trainers' ``render_image``
(``test_outputs``), the TIR mask applied as
``eval-images`` applies it; per view the largest pixel gap, each package's
PSNR / SSIM against the ground truth and, by region (``shell_regions``:
background, rim, through the shell onto the inner object or onto what lies
behind, TIR-masked), each one's pixels, SSIM, share of the view's SSIM
deficit and MSE.  ``shell-traj``: as ``traj``, with the steps where each
package holds the thickness and IoR fields.

One JSON object a line, every record also written to ``--out``.  On 8 CPU
cores: f64 at 256 rays about 12 s a step in JAX and 15 s in the port after
a 25 s compile, about 11 GB (20 GB at 512 rays); f32 at 512 rays about 6.5 s
in JAX and 25 s in the port, about 11 GB.
"""

import argparse
import contextlib
import importlib.util
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

LEG_CFG = "configs/shape/nerf/nested.yaml"
RTOL_LOSS, RTOL_GRAD = 1e-5, 1e-4
N_DIRS, N_RADII = 1000, 256
N_T_POINTS = 4096


# ---------------------------------------------------------------------------
# the draws
# ---------------------------------------------------------------------------

def draw_shapes(cfg, rn):
    """The shapes of one step's draws, in the order both packages ask for
    them: ``sample_ray_partitioned``'s front and back gap fractions, its
    background tail and chord jitter, then the occlusion priorities."""
    inner = cfg["n_samples"] + cfg["n_importance"]
    return [(rn, cfg["n_front_samples"]), (rn, cfg["n_back_samples"]),
            (rn, cfg["n_bg_samples"]), (rn, 1), (rn * inner,)]


def step_draws(cfg, rn, n_rays, seed):
    """(ray indices, [draw, ...]) of one step, from ``RandomState(seed)``."""
    rs = np.random.RandomState(seed)
    idx = rs.randint(0, n_rays, rn) if n_rays else None
    return idx, [rs.rand(*s).astype(np.float32) for s in draw_shapes(cfg, rn)]


@contextlib.contextmanager
def jax_draws(feed, candidates, k):
    """While open, ``jax.random.uniform`` on [0, 1) hands out ``feed``'s
    arrays in order (their shapes checked), and ``jax.lax.top_k`` of ``k``
    hands the occlusion subset's candidates (priority >= 0) to
    ``candidates`` as the step runs.  Draws on another range are flax's
    initialisers, which ``apply`` evaluates for their shapes: left as they
    are."""
    real_uniform, real_top_k = jax.random.uniform, jax.lax.top_k

    def uniform(key, shape=(), dtype=None, minval=0.0, maxval=1.0):
        if not (isinstance(minval, float) and isinstance(maxval, float)
                and (minval, maxval) == (0.0, 1.0)):
            return real_uniform(key, shape, dtype or jnp.float32, minval, maxval)
        if not feed:
            raise AssertionError(f"JAX asked for a draw of {tuple(shape)} past the feed")
        x = feed.pop(0)
        if tuple(x.shape) != tuple(shape):
            raise AssertionError(f"JAX asked for {tuple(shape)}, the feed holds {x.shape}")
        return x

    def top_k(x, kk):
        if kk == k:
            jax.debug.callback(lambda p: candidates.append(np.asarray(p) >= 0), x)
        return real_top_k(x, kk)

    jax.random.uniform, jax.lax.top_k = uniform, top_k
    try:
        yield
    finally:
        jax.random.uniform, jax.lax.top_k = real_uniform, real_top_k


@contextlib.contextmanager
def torch_draws(feed):
    """While open, ``torch.rand`` hands out ``feed``'s arrays in order
    (their shapes checked), in the default dtype."""
    real = torch.rand

    def rand(*size, generator=None, device=None, dtype=None, **kw):
        shape = tuple(size[0]) if len(size) == 1 and not isinstance(size[0], int) \
            else tuple(size)
        if not feed:
            raise AssertionError(f"the port asked for a draw of {shape} past the feed")
        x = feed.pop(0)
        if tuple(x.shape) != shape:
            raise AssertionError(f"the port asked for {shape}, the feed holds {x.shape}")
        return torch.as_tensor(x, dtype=dtype or torch.get_default_dtype(), device=device)

    torch.rand = rand
    try:
        yield
    finally:
        torch.rand = real


class _F64Names:
    """``jax.numpy`` with ``float32`` read as ``float64``."""

    def __init__(self, real):
        self._real = real

    def __getattr__(self, name):
        return self._real.float64 if name == "float32" else getattr(self._real, name)


@contextlib.contextmanager
def jax_layers_in_f64():
    """While open, JAX's dense layers, heads and SDF inputs compute in
    float64 under x64: ``fields/mlp.py``, ``nerf.py`` and ``sdf.py`` pin
    float32 (``preferred_element_type=jnp.float32``, the heads'
    ``astype(jnp.float32)``) even on float64 operands, which rounds each
    layer's output to f32; so does stage 2's ``models/stage2.py`` in its
    logged means (a hit mask cast to f32, ``ior_glass``' denominator).
    Their ``jnp`` reads ``float32`` as ``float64`` for as long as the step
    traces."""
    from nunerf_tpu.fields import mlp, nerf, sdf
    from nunerf_tpu.models import stage2

    mods = (mlp, nerf, sdf, stage2)
    real = [m.jnp for m in mods]
    for m in mods:
        m.jnp = _F64Names(jnp)
    try:
        yield
    finally:
        for m, r in zip(mods, real):
            m.jnp = r


# ---------------------------------------------------------------------------
# one step of each package
# ---------------------------------------------------------------------------

def jax_step_fn(renderer, optimizer, candidates):
    """The JAX step as the trainer's ``one_step`` takes it, with the batch
    and the draws passed in: jitted ``(params, opt_state, batch, draws,
    step) -> (params, opt_state, terms, grads, updates, spec_mask count)``."""
    from nunerf_tpu.train.loss import compute_losses

    cfg = renderer.cfg

    def step_fn(params, opt_state, batch, draws, step):
        rn = batch["rays_o"].shape[0]
        k = min(int(cfg["occ_loss_max_pn"]), rn * (cfg["n_samples"] + cfg["n_importance"]))
        feed = list(draws)

        def loss_fn(p):
            out = renderer.train_outputs(p, batch, jax.random.PRNGKey(0), step)
            terms = compute_losses(out, batch, step, cfg)
            return terms["loss_total"], (terms, jnp.sum(out["spec_mask"]))

        with jax_draws(feed, candidates, k):
            (_, (terms, spec)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        if feed:
            raise AssertionError(f"{len(feed)} draws left over in the JAX step")
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, terms, grads, updates, spec

    return jax.jit(step_fn)


def jax_adam_state(optimizer, params, opt_state, dtype):
    """optax.adam's state of ``params`` holding the port's Adam state
    (``count``, ``exp_avg``, ``exp_avg_sq`` as JAX trees) in ``dtype``."""
    adam, sched = jax.eval_shape(optimizer.init, params)
    count = jnp.asarray(int(opt_state["count"]), jnp.int32)

    def cast(tree):
        return jax.tree_util.tree_map(lambda x: jnp.asarray(x, dtype), tree)

    mu, nu = cast(opt_state["exp_avg"]), cast(opt_state["exp_avg_sq"])
    if jax.tree_util.tree_structure(mu) != jax.tree_util.tree_structure(adam.mu):
        raise ValueError("the checkpoint's moments are not the parameters' tree")
    return (adam._replace(count=count, mu=mu, nu=nu), sched._replace(count=count))


def port_instrument(renderer):
    """Record, on the instance, each occlusion subset's (candidate mask,
    subset size) and each step's ``spec_mask`` count: returns the two lists."""
    cands, spec = [], []
    select, outputs = renderer._occ_select, renderer.train_outputs

    def occ_select(mask, generator):
        idx = select(mask, generator)
        cands.append((mask.detach().cpu().numpy().copy(), int(idx.numel())))
        return idx

    def train_outputs(batch, step, generator=None):
        out = outputs(batch, step, generator)
        spec.append(int(out["spec_mask"].sum()))
        return out

    renderer._occ_select, renderer.train_outputs = occ_select, train_outputs
    return cands, spec


def port_leaves(module, tree_top, what="param"):
    """The module's parameters (``what`` "param"), gradients ("grad") or
    the tensors a dict ``what`` maps each parameter to, by JAX path, as
    numpy in their own dtype (``convert.to_jax_tree`` gives float32)."""
    from nunerf_tpu_torch.convert import flat_leaves, named_to_jax_tree

    named = {}
    for name, p in module.named_parameters():
        if what == "grad":
            t = p.grad if p.grad is not None else torch.zeros_like(p)  # a frozen one's
        else:
            t = p if what == "param" else what[p]
        named[name] = t.detach().cpu().numpy().copy()
    return flat_leaves(named_to_jax_tree(named, tree_top))


def port_step(train, batch, draws, step, tree_top):
    """One step of the port's ``TrainStep`` with ``draws`` injected:
    (terms, grads, updates) by JAX path, as numpy.  The occlusion priorities
    are asked for only from ``occ_loss_step``."""
    feed = list(draws)
    with torch_draws(feed):
        terms = train.compute_grads(batch, step)
    if len(feed) > (step < train.renderer.cfg["occ_loss_step"]):
        raise AssertionError(f"{len(feed)} draws left over in the port's step")
    grads = port_leaves(train.renderer, tree_top, "grad")
    before = port_leaves(train.renderer, tree_top)
    train.apply()
    after = port_leaves(train.renderer, tree_top)
    terms = {k: float(v.detach()) if torch.is_tensor(v) else float(v) for k, v in terms.items()}
    return terms, grads, {k: after[k] - before[k] for k in before}


# ---------------------------------------------------------------------------
# the two packages on the leg's scene
# ---------------------------------------------------------------------------

def leg_cfg(scene_dir, model_dir, rays=None):
    """The front leg's config in f32, reading ``scene_dir``'s scene."""
    import yaml

    with open(os.path.join(ROOT, LEG_CFG)) as f:
        cfg = yaml.safe_load(f)
    cfg.update(mixed_precision=False, sdf_mixed_precision=False,
               dataset_dir=scene_dir, model_dir=model_dir, compilation_cache_dir="")
    if rays:
        cfg["train_ray_num"] = int(rays)
    return cfg


def make_scene(scene_dir):
    """The leg's scene (``synth-scene``'s defaults) under ``scene_dir``,
    made where it is missing."""
    root = os.path.join(scene_dir, "nested")
    if not os.path.exists(os.path.join(root, "meta.json")):
        from nunerf_tpu_torch import cli
        cli.synth_scene(root)
    return root


def read_checkpoint(path, moments=None, need_moments=True):
    """(step, params, opt_state) of a port checkpoint (gzip'd where it ends
    in ``.gz``); one without Adam's state takes ``moments``' at its own
    step (or None, where ``need_moments`` is false)."""
    from nunerf_tpu_torch.train.trainer import load_checkpoint

    step, params, opt, _ = load_checkpoint(path)
    if opt is None and need_moments:
        if moments is None:
            raise ValueError(f"{path} holds no Adam state: pass --moments")
        opt = dict(read_checkpoint(moments)[2])
        opt["count"] = int(step)
    return int(step), params, opt


class JaxSide:
    """A JAX renderer and its optax optimizer, stepped with the draws
    injected; ``store`` is the trainer's ray store, where there is one."""

    def __init__(self, renderer, optimizer, f64, store=None):
        self.renderer, self.optimizer, self.store = renderer, optimizer, store
        self.cfg = renderer.cfg
        self.f64 = f64
        self.dtype = jnp.float64 if f64 else jnp.float32
        self.candidates = []
        self.fn = jax_step_fn(renderer, optimizer, self.candidates)
        self.compiled = None  # ``lower(...).compile()``, where the caller made it
        self._sdf = jax.jit(lambda p, x: renderer.sdf(p, x)[..., 0])

    @classmethod
    def from_trainer(cls, cfg, f64):
        """The JAX ``Trainer``'s renderer, optimizer and ray store on ``cfg``."""
        from nunerf_tpu.train import trainer as jtrainer

        tr = jtrainer.Trainer(cfg, n_devices=1)
        return cls(tr.renderer, tr.optimizer, f64, tr.device_store)

    @property
    def num_rays(self):
        from nunerf_tpu.data.device_rays import num_rays
        return int(num_rays(self.store))

    def load(self, params, opt_state):
        """The parameters (a JAX tree) and the port's Adam state."""
        with jax.enable_x64(self.f64):
            self.params = jax.tree_util.tree_map(lambda x: jnp.asarray(x, self.dtype), params)
            self.opt_state = jax_adam_state(self.optimizer, self.params, opt_state,
                                            self.dtype)

    def adam_state(self):
        """The Adam state as the port's checkpoint holds it (numpy)."""
        adam = self.opt_state[0]
        return {"count": int(adam.count),
                "exp_avg": jax.tree_util.tree_map(np.asarray, adam.mu),
                "exp_avg_sq": jax.tree_util.tree_map(np.asarray, adam.nu)}

    def batch(self, idx):
        """JAX's ``sample_rays`` batch of ``idx`` (f32), as numpy."""
        from nunerf_tpu.data.device_rays import sample_rays
        out = sample_rays(self.store, jnp.asarray(idx))
        return {k: np.asarray(v) for k, v in out.items()}

    def _args(self, batch, draws, step):
        b = {k: jnp.asarray(v, self.dtype if np.asarray(v).dtype.kind == "f"
                            else np.asarray(v).dtype)
             for k, v in batch.items()}
        return (self.params, self.opt_state, b,
                tuple(jnp.asarray(d, self.dtype) for d in draws), jnp.asarray(step, jnp.int32))

    def lower(self, batch, draws, step):
        """The step traced at these inputs' shapes (parameters loaded): its
        ``compile()`` may run on another thread, and set as ``compiled`` the
        steps use it."""
        with jax.enable_x64(self.f64), \
                jax_layers_in_f64() if self.f64 else contextlib.nullcontext():
            return self.fn.lower(*self._args(batch, draws, step))

    def step(self, batch, draws, step):
        """(terms, grads, updates, candidate masks, spec_mask count)."""
        from nunerf_tpu_torch.convert import flat_leaves

        with jax.enable_x64(self.f64):
            args = self._args(batch, draws, step)
            self.candidates.clear()
            with jax_layers_in_f64() if self.f64 else contextlib.nullcontext():
                (self.params, self.opt_state, terms, grads, updates, spec) = (
                    self.compiled or self.fn)(*args)
            jax.effects_barrier()
            return ({k: float(v) for k, v in terms.items()},
                    {k: np.asarray(v) for k, v in flat_leaves(grads).items()},
                    {k: np.asarray(v) for k, v in flat_leaves(updates).items()},
                    list(self.candidates), int(spec))

    def flat_params(self):
        from nunerf_tpu_torch.convert import flat_leaves
        return {k: np.asarray(v) for k, v in flat_leaves(self.params).items()}

    def sdf(self, x):
        with jax.enable_x64(self.f64):
            return np.asarray(self._sdf(self.params, jnp.asarray(x, self.dtype)))


class PortSide:
    """A port renderer and its ``TrainStep`` (CPU), stepped with the draws
    injected; ``trainer`` is the port's ``Trainer``, where there is one."""

    def __init__(self, renderer, train, f64, tree_top, trainer=None):
        self.renderer, self.train, self.tree_top, self.trainer = (renderer, train, tree_top,
                                                                  trainer)
        self.cfg = renderer.cfg
        self.dtype = torch.float64 if f64 else torch.float32
        if f64:
            renderer.to(torch.float64)
        self.cands, self.spec = (port_instrument(renderer) if hasattr(renderer, "_occ_select")
                                 else ([], []))

    @classmethod
    def from_trainer(cls, cfg, f64):
        """The port's ``Trainer`` on ``cfg``, on the CPU."""
        from nunerf_tpu_torch.train import trainer as ttrainer

        tr = ttrainer.Trainer(cfg, device="cpu")
        return cls(tr.renderer, tr.train, f64, tr.tree_top, tr)

    def load(self, params, opt_state):
        """The parameters (a JAX tree) and Adam's state, as ``Trainer.load``
        restores them."""
        from nunerf_tpu_torch.convert import load_jax_params

        load_jax_params(self.renderer, params, self.tree_top)
        self.train.load_state(opt_state, self.tree_top)

    def batch(self, idx):
        return self.trainer.batch(torch.as_tensor(idx))

    def step(self, batch, draws, step):
        prev = torch.get_default_dtype()
        torch.set_default_dtype(self.dtype)
        try:
            self.cands.clear()
            self.spec.clear()
            b = {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
                 for k, v in batch.items()}
            b = {k: v.to(self.dtype) if v.is_floating_point() else v for k, v in b.items()}
            terms, grads, updates = port_step(self.train, b, draws, step, self.tree_top)
        finally:
            torch.set_default_dtype(prev)
        return terms, grads, updates, list(self.cands), self.spec[-1] if self.spec else None

    def flat_params(self):
        return port_leaves(self.renderer, self.tree_top)

    def flat_moments(self, key):
        """Adam's ``key`` (``exp_avg`` or ``exp_avg_sq``) by JAX path."""
        state = self.train.optimizer.state
        return port_leaves(self.renderer, self.tree_top, {p: state[p][key] for p in state})

    @torch.no_grad()
    def sdf(self, x):
        return self.renderer.sdf(torch.as_tensor(x, dtype=self.dtype))[..., 0].numpy()


# ---------------------------------------------------------------------------
# the comparisons
# ---------------------------------------------------------------------------

def gaps(port, jax_, floor=1e-30):
    """Each leaf's largest gap over JAX's largest magnitude."""
    out = {}
    for k, v in jax_.items():
        scale = float(np.abs(v).max()) if v.size else 0.0
        err = float(np.abs(np.asarray(port[k], np.float64) - v).max()) if v.size else 0.0
        out[k] = dict(gap=err / max(scale, floor), err=err, scale=scale)
    return out


def compare_step(pres, jres):
    """The record of one step of both packages: terms, gradients, updates,
    candidates, ``spec_mask``, and whether terms and gradients agree."""
    pterms, pgrads, pupd, pcands, pspec = pres
    jterms, jgrads, jupd, jcands, jspec = jres
    terms = {}
    for k, v in jterms.items():
        err = abs(pterms[k] - v)
        terms[k] = dict(port=pterms[k], jax=v, err=err,
                        ok=bool(err <= RTOL_LOSS * max(abs(v), 1.0)))
    g = gaps(pgrads, jgrads)
    for k, r in g.items():
        r["ok"] = bool(r["err"] <= RTOL_GRAD * r["scale"] + 1e-15)
    u = gaps(pupd, jupd)
    pmasks = [m for m, _ in pcands]
    same = len(pmasks) == len(jcands) and all(np.array_equal(a, b)
                                              for a, b in zip(pmasks, jcands))
    return dict(terms=terms, grads=g, updates={k: r["gap"] for k, r in u.items()},
                candidates=dict(port=[int(m.sum()) for m in pmasks],
                                jax=[int(m.sum()) for m in jcands], equal=bool(same),
                                subset=[n for _, n in pcands]),
                spec_mask=dict(port=pspec, jax=jspec),
                terms_ok=all(r["ok"] for r in terms.values()),
                grads_ok=all(r["ok"] for r in g.values()),
                worst_grad=sorted(((r["gap"], k) for k, r in g.items()), reverse=True)[:6],
                worst_update=sorted(((r["gap"], k) for k, r in u.items()), reverse=True)[:6])


def fixed_dirs(n=N_DIRS):
    """``n`` unit directions on a Fibonacci sphere."""
    i = np.arange(n) + 0.5
    phi = np.arccos(1 - 2 * i / n)
    theta = np.pi * (1 + 5 ** 0.5) * i
    return np.stack([np.cos(theta) * np.sin(phi), np.sin(theta) * np.sin(phi),
                     np.cos(phi)], -1).astype(np.float32)


def median_radius(sdf, dirs, n=N_RADII, chunk=65536):
    """The median over ``dirs`` of the outermost radius in (0, 1] where the
    SDF ``sdf`` (numpy [N, 3] -> [N]) goes from inside (< 0) to outside,
    interpolated linearly; directions with none are left out."""
    r = np.linspace(0.0, 1.0, n + 1, dtype=np.float32)[1:]
    pts = (dirs[:, None, :] * r[None, :, None]).reshape(-1, 3)
    vals = np.concatenate([sdf(pts[i:i + chunk]) for i in range(0, len(pts), chunk)])
    vals = vals.reshape(len(dirs), n).astype(np.float64)
    out = []
    for v in vals:
        cross = np.nonzero((v[:-1] < 0) & (v[1:] >= 0))[0]
        if cross.size:
            i = cross[-1]
            out.append(r[i] + (r[i + 1] - r[i]) * (-v[i]) / (v[i + 1] - v[i]))
    return float(np.median(out)) if out else float("nan"), len(out)


def _card_transmission():
    """``tools/card_nested_transmission.py``, which reads ``T``."""
    spec = importlib.util.spec_from_file_location(
        "card_nested_transmission", os.path.join(ROOT, "tools", "card_nested_transmission.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sphere_points(radius, n=N_T_POINTS):
    return _card_transmission().sphere_points(radius, n)


def outer_sphere(scene_root, n=N_T_POINTS):
    """``n`` points of the scene's outer sphere (``r_outer`` of its meta),
    the points ``tools/card_nested_transmission.py`` reads ``T`` at."""
    with open(os.path.join(scene_root, "meta.json")) as f:
        return sphere_points(float(json.load(f)["r_outer"]), n)


class Transmission:
    """The stage-1 shader's transmission weight at fixed points
    (``card_nested_transmission.transmission_at``), read by a port renderer
    of the config on the CPU for either side's parameters (a ``PortSide``'s
    own renderer, or JAX's tree loaded into a scratch one)."""

    def __init__(self, cfg, points):
        from nunerf_tpu_torch.models.stage1 import ShapeRenderer

        self.points = points
        self.scratch = ShapeRenderer(cfg, device="cpu", seed=0)
        self.at = _card_transmission().transmission_at

    def __call__(self, side):
        from nunerf_tpu_torch.convert import load_jax_params
        from nunerf_tpu_torch.models.stage1 import PARAM_KEYS

        if isinstance(side, PortSide):
            return self.at(side.renderer, self.points)
        load_jax_params(self.scratch, jax.tree_util.tree_map(np.asarray, side.params),
                        PARAM_KEYS)
        return self.at(self.scratch, self.points)


def _emit(rec, log):
    line = json.dumps(rec)
    print(line, flush=True)
    log.append(rec)


def run_f64(args, log):
    cfg = leg_cfg(args.scene, args.model_dir, args.rays)
    J, P = JaxSide.from_trainer(cfg, True), PortSide.from_trainer(cfg, True)
    rn = J.cfg["train_ray_num"]
    if rn != P.cfg["train_ray_num"]:
        raise AssertionError("the packages resolve different rays a step")
    for path in args.ckpt:
        step, params, opt = read_checkpoint(path, args.moments)
        J.load(params, opt)
        P.load(params, opt)
        idx, draws = step_draws(J.cfg, rn, J.num_rays, args.seed + step)
        batch = J.batch(idx)
        t0 = time.perf_counter()
        jres = J.step(batch, draws, step)
        t1 = time.perf_counter()
        pres = P.step(batch, draws, step)
        t2 = time.perf_counter()
        rec = dict(mode="f64", ckpt=path, step=step, rays=rn,
                   jax_s=t1 - t0, port_s=t2 - t1, **compare_step(pres, jres))
        _emit(rec, log)


def run_traj(args, log):
    cfg = leg_cfg(args.scene, args.model_dir, args.rays)
    J = JaxSide.from_trainer(cfg, False)
    rn = J.cfg["train_ray_num"]
    dirs = fixed_dirs()
    step0, params, opt = read_checkpoint(args.ckpt[0], args.moments)
    J.load(params, opt)
    if args.control:
        # JAX again, every parameter one f32 ulp up: how fast one package
        # parts from itself
        P = JaxSide(J.renderer, J.optimizer, False, store=J.store)
        P.load(jax.tree_util.tree_map(
            lambda x: np.nextafter(np.asarray(x, np.float32), np.float32(np.inf)), params), opt)
    else:
        P = PortSide.from_trainer(cfg, False)
        P.load(params, opt)
    theta0 = J.flat_params()
    trans = Transmission(cfg, outer_sphere(os.path.join(args.scene, "nested")))

    def point(i, span):
        pp, jp = P.flat_params(), J.flat_params()
        dist = float(np.sqrt(sum(np.sum((pp[k].astype(np.float64) - jp[k]) ** 2)
                                 for k in jp)))
        moved = float(np.sqrt(sum(np.sum((jp[k].astype(np.float64) - theta0[k]) ** 2)
                                  for k in jp)))
        mean = {side: {k: float(np.mean([s[side][k] for s in span]))
                       for k in span[0][side]} for side in ("port", "jax")} if span else {}
        rec = dict(mode="traj", step=step0 + i, rays=rn,
                   against="jax, one ulp off" if args.control else "port",
                   param_dist=dist, jax_moved=moved,
                   dist_over_moved=dist / moved if moved else 0.0,
                   radius=dict(port=median_radius(P.sdf, dirs), jax=median_radius(J.sdf, dirs)),
                   transmission=dict(port=trans(P), jax=trans(J)),
                   span_terms=mean, candidates_differ=[s["step"] for s in span
                                                       if not s["same"]],
                   s_a_step=dict(port=float(np.mean([s["port_s"] for s in span])) if span else 0,
                                 jax=float(np.mean([s["jax_s"] for s in span])) if span else 0))
        _emit(rec, log)

    point(0, [])
    span = []
    for i in range(args.steps):
        step = step0 + i
        idx, draws = step_draws(J.cfg, rn, J.num_rays, args.seed + step)
        t0 = time.perf_counter()
        jres = J.step(J.batch(idx), draws, step)
        t1 = time.perf_counter()
        pres = P.step(P.batch(idx), draws, step)
        t2 = time.perf_counter()
        pm, jm = [m[0] if isinstance(m, tuple) else m for m in pres[3]], jres[3]
        span.append(dict(step=step, port=pres[0], jax=jres[0], jax_s=t1 - t0, port_s=t2 - t1,
                         same=len(pm) == len(jm) and all(np.array_equal(a, b)
                                                         for a, b in zip(pm, jm))))
        if (i + 1) % args.every == 0 or i + 1 == args.steps:
            point(i + 1, span)
            span = []


def run_init(args, log):
    """The port trainer's step-0 checkpoint of the leg's config, to
    ``args.ckpt[0]``."""
    from nunerf_tpu_torch.train import trainer as ttrainer

    cfg = leg_cfg(args.scene, args.model_dir, args.rays)
    tr = ttrainer.Trainer(cfg, device="cpu")
    tr.save(args.ckpt[0], 0, 0.0)
    _emit(dict(mode="init", ckpt=args.ckpt[0], rays=tr.cfg["train_ray_num"],
               seed=tr.cfg.get("random_seed")), log)


# ---------------------------------------------------------------------------
# the shell's stage 2 (``shell``): a checkpoint of the port's shell_stage2 leg
# ---------------------------------------------------------------------------

SHELL_CFG = "configs/stage2/nerf/nested_shell.yaml"
RIM_COS = 0.25  # a hit with |cos| under this is the rim
REGIONS = ("background", "rim", "inner", "behind", "tir")
SCENE_ARRAYS = ("v0", "e1", "e2", "verts", "vertex_normals", "vertex_curvature")


def shell_cfg(model_dir, rays=None, full=True, rel=SHELL_CFG):
    """A stage-2 leg's config (the shell's unless ``rel`` names another) as
    the leg wrote it into its working directory, the current one (its
    ``./datasets``, ``./data/...`` and ``./configs/...`` resolve there), with
    its bf16 switches off unless ``full`` is false (the frozen nets'
    ``mixed_precision``, stage 2's, and the inner SDF's
    ``sdf_mixed_precision``)."""
    from nunerf_tpu_torch.config import load_cfg

    cfg = load_cfg(rel)
    cfg.update(model_dir=model_dir, compilation_cache_dir="")
    if full:
        cfg.update(mixed_precision=False, sdf_mixed_precision=False)
    if rays:
        cfg["train_ray_num"] = int(rays)
    return cfg


def shell_step_fn(renderer, optimizer):
    """JAX's shell step, jitted: ``(params, opt_state, batch, step) ->
    (params, opt_state, terms, outputs, grads, updates)``, Adam
    (``optimizer``) on the ``train`` subtree and nothing on ``frozen`` (the
    trainer's ``multi_transform``).  Stage 2 draws nothing: its one draw is
    the batch."""
    from nunerf_tpu.train.loss import compute_losses

    def step_fn(params, opt_state, batch, step):
        def loss_fn(p):
            out = renderer.train_outputs(p, batch, jax.random.PRNGKey(0), step)
            terms = compute_losses(out, batch, step, renderer.cfg)
            return terms["loss_total"], (terms, out)

        (_, (terms, out)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = optimizer.update(grads["train"], opt_state, params["train"])
        params = dict(params, train=optax.apply_updates(params["train"], updates))
        return params, opt_state, terms, out, grads, {"train": updates}

    return jax.jit(step_fn)


class ShellJaxSide:
    """A JAX shell renderer stepped by ``shell_step_fn`` (Adam at the
    config's warm-up cosine schedule); ``trainer`` is the JAX ``Trainer``
    (ray store, ``render_image``), where there is one.  In float64 the
    scene's arrays are float64, the step traces with JAX's float32 pins
    lifted and the step is an int64, so that what JAX computes from it (the
    anneal ratio, the inv_s floor) is float64 too."""

    def __init__(self, renderer, f64, trainer=None):
        from nunerf_tpu.train.lr import warm_up_cos_schedule

        self.renderer, self.cfg, self.trainer, self.f64 = renderer, renderer.cfg, trainer, f64
        self.store = trainer.device_store if trainer is not None else None
        self.dtype = jnp.float64 if f64 else jnp.float32
        if f64:
            with jax.enable_x64(True):
                for name in SCENE_ARRAYS:
                    setattr(renderer.scene, name,
                            jnp.asarray(np.asarray(getattr(renderer.scene, name)), jnp.float64))
        lr = dict(self.cfg.get("lr_cfg") or {})
        self.optimizer = optax.adam(learning_rate=warm_up_cos_schedule(
            lr=lr.get("lr", 5e-4), end_warm=lr.get("end_warm", 5000),
            end_iter=lr.get("end_iter", 300000)))
        self.fn = shell_step_fn(renderer, self.optimizer)
        self.compiled = None  # ``lower(...).compile()``, where the caller made it
        self.outputs = None

    @classmethod
    def from_trainer(cls, cfg, f64):
        from nunerf_tpu.train import trainer as jtrainer

        tr = jtrainer.Trainer(cfg, n_devices=1)
        return cls(tr.renderer, f64, tr)

    num_rays = JaxSide.num_rays
    batch = JaxSide.batch

    def load(self, params, opt_state):
        """The parameters (a JAX tree) and the port's Adam state of their
        ``train`` subtree (``count``, ``exp_avg``, ``exp_avg_sq``)."""
        with jax.enable_x64(self.f64):
            self.params = jax.tree_util.tree_map(lambda x: jnp.asarray(x, self.dtype), params)
            moments = {k: opt_state[k].get("train", opt_state[k])
                       for k in ("exp_avg", "exp_avg_sq")}
            self.opt_state = jax_adam_state(self.optimizer, self.params["train"],
                                            dict(opt_state, **moments), self.dtype)

    def _args(self, batch, step):
        b = {k: jnp.asarray(v, self.dtype if np.asarray(v).dtype.kind == "f"
                            else np.asarray(v).dtype) for k, v in batch.items()}
        return (self.params, self.opt_state, b,
                jnp.asarray(step, jnp.int64 if self.f64 else jnp.int32))

    def _pins(self):
        return jax_layers_in_f64() if self.f64 else contextlib.nullcontext()

    def lower(self, batch, step):
        """The step traced at these inputs' shapes (parameters loaded)."""
        with jax.enable_x64(self.f64), self._pins():
            return self.fn.lower(*self._args(batch, step))

    def step(self, batch, step):
        """(terms, grads, updates) of one step, as numpy by JAX path; its
        forward's outputs in ``outputs``."""
        from nunerf_tpu_torch.convert import flat_leaves

        with jax.enable_x64(self.f64), self._pins():
            self.params, self.opt_state, terms, out, grads, updates = (
                self.compiled or self.fn)(*self._args(batch, step))
            self.outputs = {k: np.asarray(v) for k, v in out.items()}
            return ({k: float(v) for k, v in terms.items()},
                    {k: np.asarray(v) for k, v in flat_leaves(grads).items()},
                    {k: np.asarray(v) for k, v in flat_leaves(updates).items()})

    def flat_params(self):
        from nunerf_tpu_torch.convert import flat_leaves
        return {k: np.asarray(v) for k, v in flat_leaves(self.params).items()}

    def render(self, info, step):
        """``render_image`` of the JAX trainer at the loaded parameters (f32)."""
        self.trainer.params = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float32),
                                                     self.params)
        return self.trainer.render_image(info, step, jax.random.PRNGKey(0))


def shell_port_side(cfg, f64):
    """The port's ``Trainer`` of the shell's stage 2 on the CPU, as a
    ``PortSide`` (its scene's arrays in float64 too where ``f64``)."""
    side = PortSide.from_trainer(cfg, f64)
    if f64:
        scene = side.renderer.scene
        for name in SCENE_ARRAYS:
            setattr(scene, name, getattr(scene, name).to(torch.float64))
    return side


def shell_flags(terms, params, cfg, step):
    """The freeze flags of a step and the inner inv_s: the parameter's and
    the floored value the thickness gate reads."""
    inv_s = float(np.exp(10.0 * float(np.asarray(params["train/var_inner/variance"]))))
    start, end = cfg.get("inv_s_floor_start", 0), cfg.get("inv_s_floor_end", 30000)
    floor = 0.0
    if cfg.get("inv_s_floor_max") and step >= start:
        t = min(max((step - start) / max(end - start, 1), 0.0), 1.0)
        base = float(cfg.get("inv_s_floor_base", 32.0))
        floor = base * (float(cfg["inv_s_floor_max"]) / base) ** t
    return dict(ior_frozen=terms.get("ior_frozen"), thickness_frozen=terms.get("thickness_frozen"),
                absorption_gated=bool(cfg.get("freeze_absorption_step")
                                      or cfg.get("freeze_absorption_inv_s")),
                kappa=[terms.get(k) for k in ("kappa_r", "kappa_g", "kappa_b")],
                inv_s=inv_s, inv_s_floor=floor, inv_s_gate=max(inv_s, floor),
                ior_glass=terms.get("ior_glass"), thickness_mean=terms.get("thickness_mean"))


def by_head(rec, depth=2):
    """The worst gradient gap of each head (the first ``depth`` parts of a
    leaf's path) of a ``compare_step`` record."""
    heads = {}
    for k, r in rec["grads"].items():
        head = "/".join(k.split("/")[:depth])
        if r["gap"] >= heads.get(head, (-1.0, ""))[0]:
            heads[head] = (r["gap"], k)
    return {h: dict(gap=g, leaf=k) for h, (g, k) in sorted(heads.items())}


def ssim_map(img_gt, img_pr):
    """The windowed SSIM map behind ``compute_ssim`` (Gaussian window 11,
    sigma 1.5, data range 1), averaged over channels: [h, w].  Its mean is
    ``compute_ssim``."""
    from nunerf_tpu_torch.train.metrics import gaussian_blur

    x, y = np.asarray(img_gt, np.float64), np.asarray(img_pr, np.float64)
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    maps = []
    for c in range(x.shape[-1]):
        a, b = x[..., c], y[..., c]
        mu_a, mu_b = gaussian_blur(a, 11, 1.5), gaussian_blur(b, 11, 1.5)
        saa = gaussian_blur(a * a, 11, 1.5) - mu_a ** 2
        sbb = gaussian_blur(b * b, 11, 1.5) - mu_b ** 2
        sab = gaussian_blur(a * b, 11, 1.5) - mu_a * mu_b
        maps.append(((2 * mu_a * mu_b + c1) * (2 * sab + c2))
                    / ((mu_a ** 2 + mu_b ** 2 + c1) * (saa + sbb + c2)))
    return np.mean(maps, 0)


def shell_regions(scene, rays_o, rays_d, tir_mask, ior):
    """Each pixel's region, an index into ``REGIONS``: ``tir`` where
    ``eval-images`` masks it out (``tir_mask`` 0), else ``background``
    where the camera ray misses the outer mesh (the frozen stage-1 NeRF++
    alone), ``rim`` where it hits with |cos| under ``RIM_COS``, ``inner``
    where the ray refracted at the hit (the mesh's face normal, IoR
    ``ior``; the shell's thickness left out) meets the scene's inner
    spheres (``synth_nested.INNER_SPHERES``), else ``behind``.  The hit is
    the port's ``Scene.intersect`` on the mesh the run traced."""
    from nunerf_tpu_torch.tools import synth_nested as sn

    o = torch.as_tensor(np.asarray(rays_o, np.float32))
    d = torch.nn.functional.normalize(torch.as_tensor(np.asarray(rays_d, np.float32)), dim=-1)
    hit = scene.intersect(o, d)
    h = hit.hit.cpu().numpy()
    t = hit.t.reshape(-1).cpu().numpy().astype(np.float64)
    tri = scene.tris_np[np.clip(hit.tri_idx.reshape(-1).cpu().numpy(), 0, None)]
    v = scene.verts_np.astype(np.float64)
    n = np.cross(v[tri[:, 1]] - v[tri[:, 0]], v[tri[:, 2]] - v[tri[:, 0]])
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    dd = d.numpy().astype(np.float64)
    cos = np.sum(n * dd, -1)
    n = np.where(cos[:, None] > 0, -n, n)  # against the ray
    p = o.numpy().astype(np.float64) + np.where(h, t, 0.0)[:, None] * dd
    refr, _ = sn._refract(dd, n, 1.0 / ior)
    inner_t = sn._inner_hit(p + 1e-4 * refr, refr)[0]
    label = np.full(len(dd), REGIONS.index("behind"))
    label[h & np.isfinite(inner_t)] = REGIONS.index("inner")
    label[h & (np.abs(cos) < RIM_COS)] = REGIONS.index("rim")
    label[~h] = REGIONS.index("background")
    label[np.asarray(tir_mask).reshape(-1) < 0.5] = REGIONS.index("tir")
    return label


def region_scores(gt, pr, labels, h, w):
    """Per region: pixels, mean SSIM (of the map), its share of the image's
    SSIM deficit (sum of 1 - SSIM over the region / pixels of the image),
    and MSE; with the image's own SSIM and PSNR."""
    from nunerf_tpu_torch.train.metrics import compute_psnr, compute_ssim

    smap = ssim_map(gt.reshape(h, w, 3), pr.reshape(h, w, 3)).reshape(-1)
    err = np.mean((np.asarray(gt, np.float64) - np.asarray(pr, np.float64)) ** 2, -1)
    out = dict(ssim=float(compute_ssim(gt.reshape(h, w, 3), pr.reshape(h, w, 3))),
               psnr=float(compute_psnr(gt, pr)), regions={})
    for i, name in enumerate(REGIONS):
        m = labels == i
        out["regions"][name] = dict(
            pixels=int(m.sum()), ssim=float(smap[m].mean()) if m.any() else None,
            ssim_deficit=float(np.sum(1.0 - smap[m]) / len(smap)),
            mse=float(err[m].mean()) if m.any() else None)
    return out


def shell_views(trainer):
    """(name, imgs_info) of the validation view and the test views, as
    ``validate`` and ``eval-images --split test`` take them."""
    from nunerf_tpu_torch.data.database import NeRFSyntheticDatabase
    from nunerf_tpu_torch.data.ray_store import build_imgs_info

    cfg = trainer.cfg
    views = [("val_" + str(trainer.test_ids[0]),
              {k: v[:1] for k, v in trainer.val_info.items()})]
    db = NeRFSyntheticDatabase(cfg["database_name"], cfg.get("dataset_dir", "./datasets"),
                               testskip=1)
    for vid in db.train_test_split()[1]:
        views.append(("test_" + str(vid), build_imgs_info(db, [vid], with_mask=True)))
    return views


def _masked(outputs):
    gt, pr = outputs["gt_rgb"], outputs["ray_rgb"]
    tm = outputs["tir_mask"].reshape(-1, 1)
    return gt * tm, pr * tm


def run_shell_f64(args, log):
    """One f64 step of both packages at each checkpoint (every width and
    sample count the config's; ``--rays`` a step)."""
    cfg = shell_cfg(args.model_dir, args.rays or 128, rel=args.cfg)
    # both scenes take the brute closest hit: JAX's tile-culled descent
    # (the default above 32,768 triangles) does not trace under x64 (its
    # dynamic_slice gets an int64 and an int32 index)
    os.environ["NUNERF_CULL_TRIS"] = str(2 ** 62)
    J, P = ShellJaxSide.from_trainer(cfg, True), shell_port_side(cfg, True)
    rn = J.cfg["train_ray_num"]
    for path in args.ckpt:
        step, params, opt = read_checkpoint(path, args.moments)
        J.load(params, opt)
        P.load(params, opt)
        batch = J.batch(shell_indices(rn, J.num_rays, args.seed + step))
        t0 = time.perf_counter()
        jterms, jgrads, jupd = J.step(batch, step)
        t1 = time.perf_counter()
        pterms, pgrads, pupd, _, _ = P.step(batch, [], step)
        t2 = time.perf_counter()
        rec = compare_step((pterms, pgrads, pupd, [], None), (jterms, jgrads, jupd, [], None))
        for key in ("candidates", "spec_mask"):
            rec.pop(key)
        flat = {k: np.asarray(v) for k, v in J.flat_params().items()}
        rec = dict(mode="shell_f64", ckpt=path, step=step, rays=rn, jax_s=t1 - t0,
                   port_s=t2 - t1, heads=by_head(rec), flags=dict(
                       port=shell_flags(pterms, flat, J.cfg, step),
                       jax=shell_flags(jterms, flat, J.cfg, step)), **rec)
        _emit(rec, log)


def run_shell_render(args, log):
    """Both packages render the validation view and the test views from the
    checkpoint in f32 through ``render_image`` (``test_outputs``), the TIR
    mask applied as ``eval-images`` applies it; per view the largest
    per-pixel gap, each package's PSNR / SSIM against the ground truth and
    the region split of the port's."""
    from nunerf_tpu_torch.convert import load_jax_params
    from nunerf_tpu_torch.data.ray_store import construct_nerf_ray_batch

    cfg = shell_cfg(args.model_dir, rel=args.cfg)
    with open(os.path.join(cfg["dataset_dir"], cfg["database_name"].split("/")[-1],
                           "meta.json")) as f:
        ior = float(json.load(f)["ior"])
    J, P = ShellJaxSide.from_trainer(cfg, False), shell_port_side(cfg, False)
    step, params, _ = read_checkpoint(args.ckpt[0], args.moments, need_moments=False)
    J.params = params
    load_jax_params(P.renderer, params, P.tree_top)
    views = shell_views(P.trainer)
    if args.views:
        views = [views[int(i)] for i in args.views.split(",")]
    for name, info in views:
        t0 = time.perf_counter()
        jout, h, w = J.render(info, step)
        t1 = time.perf_counter()
        with torch.no_grad():
            pout, _, _ = P.trainer.render_image(info, step)
        t2 = time.perf_counter()
        jgt, jpr = _masked(jout)
        pgt, ppr = _masked(pout)
        batch, _, _ = construct_nerf_ray_batch(P.trainer._downsampled(dict(info)))
        labels = shell_regions(P.renderer.scene, batch["rays_o"], batch["rays_d"],
                               pout["tir_mask"], ior)
        gap = np.abs(np.asarray(ppr, np.float64) - jpr).max(-1)
        worst = int(np.argmax(gap))
        rec = dict(mode="shell_render", ckpt=args.ckpt[0], step=int(step), view=name, h=h, w=w,
                   max_pixel_gap=float(gap[worst]),
                   pixels_over={f"{t:g}": int((gap > t).sum()) for t in (1e-5, 1e-4, 1e-3)},
                   worst_pixel=dict(index=worst, region=REGIONS[labels[worst]],
                                    port=np.asarray(ppr[worst], np.float64).tolist(),
                                    jax=np.asarray(jpr[worst], np.float64).tolist()),
                   region_gap={r: float(gap[labels == i].max()) if (labels == i).any() else None
                               for i, r in enumerate(REGIONS)},
                   tir_equal=bool(np.array_equal(pout["tir_mask"].reshape(-1) > 0.5,
                                                 np.asarray(jout["tir_mask"]).reshape(-1) > 0.5)),
                   port=region_scores(pgt, ppr, labels, h, w),
                   jax=region_scores(jgt, jpr, labels, h, w), jax_s=t1 - t0, port_s=t2 - t1)
        _emit(rec, log)


def shell_indices(rn, n_rays, seed):
    """A step's ray indices, from ``RandomState(seed)``: stage 2 draws
    nothing else."""
    return np.random.RandomState(seed).randint(0, n_rays, rn)


def run_shell_traj(args, log):
    """``--steps`` f32 steps from the checkpoint in each package, the same
    rays a step; every ``--every`` steps the parameter distance over JAX's
    move, each package's mean terms over the span, and the steps where each
    holds the thickness and IoR fields.  ``--control``: JAX against JAX one
    f32 ulp up, in place of the port."""
    cfg = shell_cfg(args.model_dir, args.rays, rel=args.cfg)
    J = ShellJaxSide.from_trainer(cfg, False)
    rn = J.cfg["train_ray_num"]
    step0, params, opt = read_checkpoint(args.ckpt[0], args.moments)
    J.load(params, opt)
    if args.control:
        P = ShellJaxSide.__new__(ShellJaxSide)
        P.__dict__.update(J.__dict__)
        P.load(jax.tree_util.tree_map(
            lambda x: np.nextafter(np.asarray(x, np.float32), np.float32(np.inf)), params), opt)
    else:
        P = shell_port_side(cfg, False)
        P.load(params, opt)
    theta0 = J.flat_params()
    trans = Transmission(cfg, outer_sphere(os.path.join(args.scene, "nested")))

    def point(i, span):
        pp, jp = P.flat_params(), J.flat_params()
        dist = float(np.sqrt(sum(np.sum((pp[k].astype(np.float64) - jp[k]) ** 2) for k in jp)))
        moved = float(np.sqrt(sum(np.sum((jp[k].astype(np.float64) - theta0[k]) ** 2)
                                  for k in jp)))
        mean = {side: {k: float(np.mean([s[side][k] for s in span])) for k in span[0][side]}
                for side in ("port", "jax")} if span else {}
        held = {side: {flag: [s["step"] for s in span if s[side].get(flag)]
                       for flag in ("thickness_frozen", "ior_frozen")}
                for side in ("port", "jax")} if span else {}
        _emit(dict(mode="shell_traj", step=step0 + i, rays=rn,
                   against="jax, one ulp off" if args.control else "port",
                   param_dist=dist, jax_moved=moved, dist_over_moved=dist / moved if moved else 0.0,
                   inv_s=dict(port=shell_flags({}, pp, J.cfg, step0 + i)["inv_s"],
                              jax=shell_flags({}, jp, J.cfg, step0 + i)["inv_s"]),
                   span_terms=mean, held=held), log)

    point(0, [])
    span = []
    for i in range(args.steps):
        step = step0 + i
        batch = J.batch(shell_indices(rn, J.num_rays, args.seed + step))
        jterms = J.step(batch, step)[0]
        pterms = P.step(batch, step)[0] if args.control else P.step(batch, [], step)[0]
        span.append(dict(step=step, port=pterms, jax=jterms))
        if (i + 1) % args.every == 0 or i + 1 == args.steps:
            point(i + 1, span)
            span = []


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=["f64", "traj", "init", "shell-f64", "shell-render",
                                       "shell-traj"])
    ap.add_argument("ckpt", nargs="+")
    ap.add_argument("--moments", default=None,
                    help="a full checkpoint whose Adam moments a parameters-only one takes")
    ap.add_argument("--rays", type=int, default=None,
                    help="rays a step (the config's: 512 for the front leg, 1024 for the "
                         "shell's stage 2; shell-f64: 128 unless given)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--every", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--control", action="store_true",
                    help="traj: JAX against itself one f32 ulp off, in place of the port")
    ap.add_argument("--scene", default="data/trained_step_compare")
    ap.add_argument("--workdir", default=None,
                    help="shell modes: the shell legs' working directory (its datasets/, "
                         "configs/ and the stage-1 checkpoint and mesh under data/)")
    ap.add_argument("--cfg", default=SHELL_CFG,
                    help="shell modes: the stage-2 config in --workdir (the shell's by "
                         "default; configs/stage2/nerf/nested.yaml for the nested stage2 leg)")
    ap.add_argument("--views", default=None,
                    help="shell-render: the views to render, comma-separated indices into "
                         "[validation, test 0, test 1, ...] (all by default)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    args.ckpt = [os.path.abspath(c) for c in args.ckpt]
    if args.moments:
        args.moments = os.path.abspath(args.moments)
    if args.out:
        args.out = os.path.abspath(args.out)
    log = []
    shell = args.mode.startswith("shell")
    if shell:
        if not args.workdir:
            ap.error("the shell modes take --workdir")
        prev = os.getcwd()
        os.chdir(args.workdir)
    else:
        args.scene = os.path.abspath(args.scene)
        make_scene(args.scene)
    try:
        with tempfile.TemporaryDirectory() as model_dir:
            args.model_dir = model_dir
            {"f64": run_f64, "traj": run_traj, "init": run_init, "shell-f64": run_shell_f64,
             "shell-render": run_shell_render, "shell-traj": run_shell_traj}[args.mode](args, log)
    finally:
        if shell:
            os.chdir(prev)
    if args.out:
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(log, f, indent=1)
    return log


if __name__ == "__main__":
    main()
