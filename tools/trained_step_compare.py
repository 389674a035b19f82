"""Hold the port's stage-1 training step to the JAX package's on trained
weights: a checkpoint of the port's ``front`` leg loaded into both packages,
every random draw of the step injected into both, on the CPU.

    python tools/trained_step_compare.py f64 CKPT [CKPT ...] [--moments FULL] [--rays N]
    python tools/trained_step_compare.py traj CKPT [--steps 100] [--every 25] [--rays N]

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
rate at which f32 roundings alone part two runs.

One JSON object a line, every record also written to ``--out``.  On 8 CPU
cores: f64 at 256 rays about 12 s a step in JAX and 15 s in the port after
a 25 s compile, about 11 GB (20 GB at 512 rays); f32 at 512 rays about 6.5 s
in JAX and 25 s in the port, about 11 GB.
"""

import argparse
import contextlib
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
    layer's output to f32.  Their ``jnp`` reads ``float32`` as ``float64``
    for as long as the step traces."""
    from nunerf_tpu.fields import mlp, nerf, sdf

    mods = (mlp, nerf, sdf)
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
        t = p if what == "param" else p.grad if what == "grad" else what[p]
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


def read_checkpoint(path, moments=None):
    """(step, params, opt_state) of a port checkpoint; one without Adam's
    state takes ``moments``' at its own step."""
    from nunerf_tpu_torch.train.trainer import load_checkpoint

    step, params, opt, _ = load_checkpoint(path)
    if opt is None:
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
        self.cands, self.spec = port_instrument(renderer)

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
        return terms, grads, updates, list(self.cands), self.spec[-1]

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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=["f64", "traj"])
    ap.add_argument("ckpt", nargs="+")
    ap.add_argument("--moments", default=None,
                    help="a full checkpoint whose Adam moments a parameters-only one takes")
    ap.add_argument("--rays", type=int, default=None, help="rays a step (the config's: 512)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--every", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--control", action="store_true",
                    help="traj: JAX against itself one f32 ulp off, in place of the port")
    ap.add_argument("--scene", default="data/trained_step_compare")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    args.scene = os.path.abspath(args.scene)
    make_scene(args.scene)
    log = []
    with tempfile.TemporaryDirectory() as model_dir:
        args.model_dir = model_dir
        (run_f64 if args.mode == "f64" else run_traj)(args, log)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(log, f, indent=1)
    return log


if __name__ == "__main__":
    main()
