"""The port's stage-1 step against the JAX step under the nested legs' own
configs, at their schedule gates (CPU).

``configs/shape/nerf/nested.yaml`` (the ``front`` leg) and
``nested_shell.yaml`` (``shell_front``) are read as they are; only depth and
width are cut (``CUT``: a 4-layer SDF, 8 + 8 SDF samples, 32 rays).  Their
schedule keys stay: ``zero_thickness``, ``freeze_inv_s_step`` 15,000,
``anneal_end`` 10,000, ``occ_loss_step`` 10,000, ``outer_reg_step`` 20,000,
``mask_loss_weight`` and the warm-up cosine lr of ``lr_cfg``.  One whole
step (``train_outputs``, ``compute_losses``, one Adam update at the
schedule's lr through ``TrainStep``) is held at the steps on both sides of
each gate: 9,999 / 10,000 / 14,999 / 15,000 / 19,999 / 20,000 / 29,999.

* **Weights** are the JAX init jittered off it (``jitter_tree``), so that
  more points are occlusion candidates than the subset takes.  At 32 rays
  18 points are candidates, far below the legs' ``occ_loss_max_pn`` of
  2,048, so that key is cut to ``OCC_MAX_PN`` (8; below every step's count,
  which the test checks): the top-K really selects.
* **Random draws.**  ``perturb`` is 0 (no sample jitter, as in
  ``test_torch_port_stage1.py``); the subset's priorities, the step's one
  random draw left, are injected into both packages: ``jax.random.uniform``
  and ``torch.rand`` are patched for the test to return ``_priorities`` where
  a one-dimensional draw is asked for (the subset's is the only one), and
  ``jax.lax.top_k`` is wrapped to hand JAX's candidates to the host.
* **One JAX compile a dtype.**  The step is a traced value; the two legs'
  renderer configs are equal (checked), and their one difference,
  ``mask_loss_weight``, enters ``compute_losses`` as a traced value too.

Checks, in f32: in float64 the two packages' terms and gradients agree to
``RTOL_LOSS`` and ``RTOL_GRAD`` of scale with no conditioning term; in f32
every loss term within ``RTOL_LOSS`` of its scale and every gradient within
``RTOL_GRAD`` of its scale, each plus ten times both packages' own f32 error
against their float64 step (``port_helpers.assert_close_calibrated``, as
``test_torch_port_shell.py`` holds its step: the shader's light heads carry
f32 errors near their tolerance in JAX too); the same occlusion candidates
in both packages, in f32 and float64; the inv_s gradient exactly zero
before ``freeze_inv_s_step`` and nonzero from it, in both packages; the
resolved ``train_ray_num`` 512 (a zero-thickness stage 1) in both.

In bf16 (``mixed_precision`` and ``sdf_mixed_precision`` as the configs
set them) each quantity of the port is held to JAX's within ``rtol * scale
+ K_BF16 * |jax_bf16 - jax_f32|``: JAX's own bf16 rounding, measured
against its f32 step, and none of the port's, so a fault in the port's
bf16 path alone cannot widen its own bound (a bias 2 % off in the bf16
dense layers of the port fails every case).  rtol is set from the port's
step with one rounding after the f32 bias: beyond twice JAX's own gap its
values need 2.2e-7 of scale and its gradients 3.9e-3, so ``BF16_RTOL_LOSS``
is 1e-3 and ``BF16_RTOL_GRAD`` 1e-2 (before, 1e-2 and 3e-2, those of the
bf16 kernel parity cases, ``test_torch_port_jac.py``).  One head is left
out where it cannot be held, and the test names it and checks that nothing
else is: the occlusion probability's
(``OCC_HEAD``), before ``occ_loss_step`` only, where the colour alone
reaches it and JAX's own bf16 gradient of it is 0.58-1.22 of its scale off
its f32 one (``OWN_GAP``).  From ``occ_loss_step`` the occlusion loss
drives it, over a subset of candidates chosen by a threshold on the bf16
SDF at bf16 importance samples, and it is held like every other leaf
(within 0.76 of its bound at most).  The two packages' bf16 decide one
of the 18 candidates differently (at most ``MAX_OCC_FLIPS``, checked): an
importance sample placed elsewhere (radius 0.4818 in the port, 0.4576 in
JAX; |sdf| 0.0024 against 0.0144, against the 0.01 threshold).  The
eikonal term's bf16-vs-f32 gap is 1.09e-4 in the port, 7.3e-5 in JAX, at
0.0063.  Before the port's bf16 dense layers rounded once, after the f32
bias, and its softplus took JAX's derivative, the two packages decided 2
candidates differently (one |sdf| 0.00981 in JAX, 0.01011 in the port),
the head's gradient was off JAX's by up to 1.63 times the bound then in
force (0.31 of its scale, where JAX's own bf16 is 0.17 off its f32), and
the head was left out from ``occ_loss_step`` too.

The Adam update: the port's equals optax.adam's on the port's own
gradients, and where JAX's gradient is clear of the bound above, JAX's
update (a first Adam step is lr times the gradient's sign); at least
``ADAM_HELD_F32`` / ``ADAM_HELD_BF16`` of the parameters are so held.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from nunerf_tpu.models.stage1 import ShapeRenderer as JShapeRenderer
from nunerf_tpu.train.loss import compute_losses as j_compute_losses
from nunerf_tpu.train.lr import warm_up_cos_schedule as j_schedule
from nunerf_tpu_torch.convert import flat_leaves, load_jax_params, to_jax_tree
from nunerf_tpu_torch.models.stage1 import PARAM_KEYS, ShapeRenderer
from nunerf_tpu_torch.train.lr import warm_up_cos_host
from nunerf_tpu_torch.train.trainer import TrainStep
from port_helpers import assert_close_calibrated, jitter_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEGS = {"front": "configs/shape/nerf/nested.yaml",
        "shell_front": "configs/shape/nerf/nested_shell.yaml"}
STEPS = [9999, 10000, 14999, 15000, 19999, 20000, 29999]
RN = 32
CUT = dict(sdf_n_layers=4, n_samples=8, n_importance=8, up_sample_steps=2, n_bg_samples=4,
           n_front_samples=2, n_back_samples=2, perturb=0.0, train_ray_num=RN)
OCC_MAX_PN = 8
RTOL_LOSS, RTOL_GRAD, K_COND = 1e-5, 1e-4, 10.0
BF16_RTOL_LOSS, BF16_RTOL_GRAD, K_BF16 = 1e-3, 1e-2, 2.0
OCC_HEAD = "shade/inner_weight/"  # the shader head of the occlusion probability
OWN_GAP = 0.5      # JAX's bf16 gradient of a leaf is noise where it is this far off its f32
MAX_OCC_FLIPS = 1  # occlusion candidates the two packages' bf16 may decide differently
# at least these shares of the parameters are held to JAX's update (measured
# 0.253-0.302 in f32, 0.084-0.087 in bf16)
ADAM_HELD_F32, ADAM_HELD_BF16 = 0.2, 0.07
# keys of the configs that name the run, not the renderer
RUN_KEYS = ("name", "database_name", "mask_loss_weight")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _read(leg):
    with open(os.path.join(ROOT, LEGS[leg])) as f:
        return yaml.safe_load(f)


def _cfg(leg, bf16):
    cfg = dict(_read(leg), **CUT, occ_loss_max_pn=OCC_MAX_PN)
    if not bf16:
        cfg.update(mixed_precision=False, sdf_mixed_precision=False)
    return cfg


def _priorities(n):
    return np.random.RandomState(5).rand(n).astype(np.float32)


def _batch():
    rs = np.random.RandomState(0)
    origins = np.tile(np.array([[0.0, 0.0, -2.5]], np.float32), (RN, 1))
    dirs = rs.randn(RN, 3).astype(np.float32) * 0.3 - origins
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return {"rays_o": origins, "rays_d": dirs.astype(np.float32),
            "near": np.full((RN, 1), 0.8, np.float32),
            "far": np.full((RN, 1), 4.5, np.float32),
            "rgbs": rs.rand(RN, 3).astype(np.float32),
            "masks": (rs.rand(RN) < 0.7).astype(np.float32)}


def _lr(cfg, step):
    lr = cfg["lr_cfg"]
    return float(j_schedule(lr=lr.get("lr", 5e-4), end_warm=lr["end_warm"],
                            end_iter=lr["end_iter"])(step))


def test_legs_differ_only_in_their_run_keys():
    """What lets the two legs share one JAX compile a dtype: their renderer
    configs are equal, and the mask weight is traced."""
    a, b = _read("front"), _read("shell_front")
    assert {k for k in set(a) | set(b) if a.get(k) != b.get(k)} == set(RUN_KEYS)
    assert b["mask_loss_weight"] == 0.5 and "mask_loss_weight" not in a
    for cfg in (a, b):
        assert cfg["zero_thickness"] and cfg["freeze_inv_s_step"] == 15000
        assert cfg["anneal_end"] == 10000 and cfg["occ_loss_step"] == 10000
        assert cfg["outer_reg_step"] == 20000
        assert cfg["mixed_precision"] and cfg["sdf_mixed_precision"]


@pytest.mark.parametrize("leg", sorted(LEGS))
def test_zero_thickness_resolves_512_rays_in_both(leg):
    cfg = dict(_read(leg), sdf_n_layers=4)
    assert JShapeRenderer(cfg).cfg["train_ray_num"] == 512
    assert ShapeRenderer(cfg, device="cpu").cfg["train_ray_num"] == 512


@pytest.fixture(scope="module")
def params():
    renderer = JShapeRenderer(_cfg("front", False))
    return jitter_tree(jax.jit(renderer.init_params)(jax.random.PRNGKey(0)), 1, 0.05)


_JAX = {}
_JAX_OCC = []  # the occlusion candidates of the JAX step's last call


def _top_k(real):
    """``jax.lax.top_k`` that hands the occlusion subset's priorities (-1 off
    the candidates) to the host as it runs; the subset's is the one top-K
    of ``OCC_MAX_PN``."""
    def top_k(x, k):
        if k == OCC_MAX_PN:
            jax.debug.callback(lambda p: _JAX_OCC.append(np.asarray(p) >= 0), x)
        return real(x, k)
    return top_k


def _jax_grad_fn(kind):
    """value_and_grad of the JAX step, jitted once a kind ("f32", "bf16",
    "f64"): (params, step, mask weight) -> ((loss, terms), grads), with the
    subset's priorities injected while it traces."""
    if kind not in _JAX:
        cfg = {k: v for k, v in _cfg("front", kind == "bf16").items() if k not in RUN_KEYS}
        renderer = JShapeRenderer(cfg)
        fdt = jnp.float64 if kind == "f64" else jnp.float32
        batch = {k: jnp.asarray(v, fdt) for k, v in _batch().items()}

        def loss_fn(p, step, mask_w):
            out = renderer.train_outputs(p, batch, jax.random.PRNGKey(1), step)
            terms = j_compute_losses(out, batch, step,
                                     dict(renderer.cfg, mask_loss_weight=mask_w))
            return terms["loss_total"], terms

        _JAX[kind] = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    return _JAX[kind]


def _jax_step(params, cfg, step, kind, monkeypatch):
    real = jax.random.uniform
    fdt = jnp.float64 if kind == "f64" else jnp.float32

    def uniform(key, shape=(), *a, **kw):
        if len(shape) == 1:
            return jnp.asarray(_priorities(shape[0]), fdt)
        return real(key, shape, *a, **kw)

    with monkeypatch.context() as m, jax.enable_x64(kind == "f64"):
        m.setattr(jax.random, "uniform", uniform)
        m.setattr(jax.lax, "top_k", _top_k(jax.lax.top_k))
        p = jax.tree_util.tree_map(lambda x: jnp.asarray(x, fdt), params)
        _JAX_OCC.clear()
        (_, terms), grads = _jax_grad_fn(kind)(
            p, jnp.asarray(step, jnp.int32),
            jnp.asarray(cfg.get("mask_loss_weight", 0.01), fdt))
        terms = {k: float(v) for k, v in terms.items()}
        grads = {k: np.asarray(v, np.float64) for k, v in flat_leaves(grads).items()}
        jax.effects_barrier()
    return terms, grads, list(_JAX_OCC)


def _port_step(params, cfg, step, dtype, monkeypatch):
    """One port step; (terms, grads, params before, params after, lr,
    (candidate mask, subset size) of each occlusion draw)."""
    real = torch.rand
    draws = []

    def rand(*shape, **kw):
        size = tuple(shape[0]) if len(shape) == 1 and not isinstance(shape[0], int) \
            else shape
        if len(size) == 1:
            return torch.as_tensor(_priorities(size[0]), device=kw.get("device"))
        return real(*shape, **kw)

    def occ_select(self, mask, generator):
        idx = select(self, mask, generator)
        draws.append((mask.numpy().copy(), int(idx.numel())))
        return idx

    select = ShapeRenderer._occ_select
    prev = torch.get_default_dtype()
    torch.set_default_dtype(dtype if dtype != torch.bfloat16 else torch.float32)
    try:
        with monkeypatch.context() as m:
            m.setattr(torch, "rand", rand)
            m.setattr(ShapeRenderer, "_occ_select", occ_select)
            renderer = ShapeRenderer(cfg, device="cpu")
            load_jax_params(renderer, params, PARAM_KEYS)
            if dtype == torch.float64:
                renderer.to(dtype)
            lr = cfg["lr_cfg"]
            train = TrainStep(renderer, warm_up_cos_host(
                lr=lr.get("lr", 5e-4), end_warm=lr["end_warm"], end_iter=lr["end_iter"]))
            train.n_updates = step  # the schedule's lr at this step
            fdt = torch.float64 if dtype == torch.float64 else torch.float32
            batch = {k: torch.as_tensor(v).to(fdt) for k, v in _batch().items()}
            terms = train.compute_grads(batch, step)
            grads = flat_leaves(to_jax_tree(renderer, PARAM_KEYS, "grad"))
            before = flat_leaves(to_jax_tree(renderer, PARAM_KEYS))
            train.apply()
            after = flat_leaves(to_jax_tree(renderer, PARAM_KEYS))
            used_lr = train.optimizer.param_groups[0]["lr"]
    finally:
        torch.set_default_dtype(prev)
    terms = {k: float(v.detach()) for k, v in terms.items()}
    return terms, grads, before, after, used_lr, draws


def _var_keys(grads):
    keys = [k for k in grads if k.startswith("var")]
    assert keys
    return keys


def _check_gates(cfg, step, terms, grads, masks):
    """The schedule's gates in one package's step; ``masks`` are the
    occlusion candidates of each subset drawn in it."""
    # the inv_s gradient is exactly zero while frozen and live from the gate
    inv_s = sum(float(np.abs(grads[k]).sum()) for k in _var_keys(grads))
    if step < cfg["freeze_inv_s_step"]:
        assert inv_s == 0.0, (step, inv_s)
    else:
        assert inv_s > 0.0, step
    if step >= cfg["outer_reg_step"]:
        assert terms["loss_outer_reg"] > 0
    else:
        assert terms["loss_outer_reg"] == 0
    if step >= cfg["occ_loss_step"]:
        # one subset a step, of OCC_MAX_PN points out of more candidates
        assert len(masks) == 1 and masks[0].sum() > OCC_MAX_PN, [m.sum() for m in masks]
        assert terms["loss_occ"] > 0
    else:
        assert masks == [] and terms["loss_occ"] == 0


def _port_masks(draws):
    assert all(n == OCC_MAX_PN for _, n in draws), draws
    return [m for m, _ in draws]


def _same_masks(a, b):
    return len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))


def _adam_held(cfg, step, grads, jgrads, before, after, lr, noise):
    """The port's update is optax.adam's at the schedule's lr on the port's
    own gradients; where JAX's gradient is clear of ``noise`` (a bound per
    leaf of the two packages' gradient gap), the parameters after the step
    are those of JAX's update.  Returns the share of parameters so held."""
    assert lr == pytest.approx(_lr(cfg, step), rel=1e-6)
    opt = optax.adam(lr)
    upd, _ = opt.update(grads, opt.init(before), before)
    jupd, _ = opt.update({k: v.astype(np.float32) for k, v in jgrads.items()},
                         opt.init(before), before)
    held = total = 0
    for k in before:
        np.testing.assert_allclose(after[k], before[k] + np.asarray(upd[k]),
                                   rtol=1e-6, atol=1e-5 * lr, err_msg=k)
        total += before[k].size
        if k not in noise:
            continue
        jafter = before[k] + np.asarray(jupd[k])
        clear = np.abs(jgrads[k]) > noise[k] + 1e-6
        diff = np.abs(after[k] - jafter)
        assert (diff[clear] <= 1e-6 + 1e-6 * np.abs(jafter[clear])).all(), k
        held += int(clear.sum())
    return held / total


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("leg", sorted(LEGS))
def test_leg_step_matches_jax_f32(params, leg, step, monkeypatch):
    cfg = _cfg(leg, bf16=False)
    jterms, jgrads, jmasks = _jax_step(params, cfg, step, "f32", monkeypatch)
    j64, jg64, jmasks64 = _jax_step(params, cfg, step, "f64", monkeypatch)
    t32, g32, before, after, lr, draws = _port_step(params, cfg, step, torch.float32,
                                                    monkeypatch)
    t64, g64, _, _, _, draws64 = _port_step(params, cfg, step, torch.float64, monkeypatch)
    masks = _port_masks(draws)
    # the same occlusion candidates in both packages and both precisions
    for other in (_port_masks(draws64), jmasks, jmasks64):
        assert _same_masks(masks, other)
    _check_gates(cfg, step, jterms, jgrads, jmasks)
    _check_gates(cfg, step, t32, g32, masks)

    # in float64 the two packages compute the same step within the f32
    # tolerances alone, with no conditioning term (a few constants stay f32
    # on each side, so not to float64's precision)
    for k, v in j64.items():
        assert abs(t64[k] - v) <= RTOL_LOSS * max(abs(v), 1.0), (k, t64[k], v)
    for k, v in jg64.items():
        err = np.abs(g64[k] - v).max()
        assert err <= RTOL_GRAD * np.abs(v).max() + 1e-15, (k, err, np.abs(v).max())

    assert sorted(t32) == sorted(jterms)
    for k, v in jterms.items():
        assert_close_calibrated(np.float64(t32[k]), np.float64(v), np.float64(t64[k]),
                                RTOL_LOSS, K_COND, what=k, expected64=np.float64(j64[k]))

    assert sorted(g32) == sorted(jgrads)
    noise = {}
    for k, v in jgrads.items():
        assert_close_calibrated(g32[k], v, g64[k], RTOL_GRAD, K_COND, what=k,
                                expected64=jg64[k])
        noise[k] = RTOL_GRAD * np.abs(g64[k]).max() + K_COND * (
            np.abs(g32[k] - g64[k]).max() + np.abs(v - jg64[k]).max())
    share = _adam_held(cfg, step, g32, jgrads, before, after, lr, noise)
    assert share >= ADAM_HELD_F32, share


def _held_bf16(got, want, want32, rtol, what):
    """``got`` (the port in bf16) against ``want`` (JAX in bf16) within
    ``rtol * scale + K_BF16 * |want - want32|``: the scale is JAX's f32
    value's, the second term JAX's own bf16 rounding.  Returns that
    rounding over the scale."""
    got, want, want32 = (np.asarray(x, np.float64) for x in (got, want, want32))
    scale, gap = np.abs(want32).max(), np.abs(want - want32).max()
    err, bound = np.abs(got - want).max(), rtol * scale + K_BF16 * gap
    assert err <= bound, f"{what}: max err {err:.3e} > {bound:.3e} (JAX's own {gap:.3e})"
    return gap / max(scale, 1e-30)


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("leg", sorted(LEGS))
def test_leg_step_matches_jax_bf16(params, leg, step, monkeypatch):
    cfg, cfg32 = _cfg(leg, bf16=True), _cfg(leg, bf16=False)
    assert cfg["mixed_precision"] and cfg["sdf_mixed_precision"]
    jterms, jgrads, jmasks = _jax_step(params, cfg, step, "bf16", monkeypatch)
    j32, jg32, _ = _jax_step(params, cfg32, step, "f32", monkeypatch)
    terms, grads, before, after, lr, draws = _port_step(params, cfg, step, torch.bfloat16,
                                                        monkeypatch)
    masks = _port_masks(draws)
    _check_gates(cfg, step, jterms, jgrads, jmasks)
    _check_gates(cfg, step, terms, grads, masks)
    # the candidates are a threshold on the bf16 SDF and its samples: the
    # two packages' own roundings may decide a point or two differently
    assert len(masks) == len(jmasks)
    flips = sum(int((m != j).sum()) for m, j in zip(masks, jmasks))
    assert flips <= MAX_OCC_FLIPS, flips

    assert sorted(terms) == sorted(jterms)
    for k, v in jterms.items():
        _held_bf16(terms[k], v, j32[k], BF16_RTOL_LOSS, k)
    assert sorted(grads) == sorted(jgrads)
    noise, left = {}, {}
    for k, v in jgrads.items():
        scale, gap = np.abs(jg32[k]).max(), np.abs(v - jg32[k]).max()
        if k.startswith(OCC_HEAD) and gap >= OWN_GAP * scale:
            left[k] = gap / max(scale, 1e-30)
            continue
        _held_bf16(grads[k], v, jg32[k], BF16_RTOL_GRAD, k)
        noise[k] = BF16_RTOL_GRAD * scale + K_BF16 * gap
    # what is left out is the occlusion head alone, where JAX's own bf16
    # gradient of it is rounding noise: before the occlusion loss starts
    assert all(k.startswith(OCC_HEAD) for k in left), left
    if step >= cfg["occ_loss_step"]:
        assert not left, left
    share = _adam_held(cfg, step, grads, jgrads, before, after, lr, noise)
    assert share >= ADAM_HELD_BF16, share
