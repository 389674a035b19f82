"""The port's training loop (``train/trainer.py``) against the JAX
package's, on the CPU.

* Three steps of the port's ``Trainer`` against the JAX ``Trainer``'s own
  jitted ``train_step`` on the same scene, from the same (jittered)
  parameters, given the same ray indices: the JAX step draws them inside
  itself (``r_sel, _ = jax.random.split(rng)``, then ``jax.random.randint``),
  the test recomputes them and hands them to the port through
  ``Trainer.sample_indices``.  ``perturb`` is 0 and the occlusion loss's
  top-K takes every point, so nothing else is drawn.  Held: the batch (atol
  1e-5, as ``sample_rays`` is held to the host batch), the learning rate of
  each step (equal: both evaluate the warm-up cosine in float32), the loss
  terms of each step (rtol 1e-4 of each term plus 1e-6 of the total: f32
  sums in another order, carried through two updates) and the parameters
  after the steps: each leaf's update over the steps within 5e-2 of its L2
  norm, and every element within twice the summed learning rates.  Adam
  divides each gradient element by its own running magnitude, so an element
  whose gradient lies within f32 noise of zero (the NeRF++ trunk's
  gradients here are 1e-6 and less, held to each other at 2e-5 of their
  scale) moves by up to a step either way; in this run such elements carry
  at most 1.5e-2 of a leaf's update norm.
* Save, then resume: a run cut at step 2 and resumed by a new trainer ends
  bit-equal to one that ran straight through.
* A checkpoint of the JAX trainer loads (parameters equal, Adam afresh at
  its step), and a port checkpoint's parameters are a JAX tree.
* Stage 2: the frozen stage-1 subtree is untouched by the loop.
* ``build_renderer``'s dispatch, the logger, the NaN check and the timer.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nunerf_tpu.data import device_rays as jdr
from nunerf_tpu.models.stage1 import ShapeRenderer as JShapeRenderer
from nunerf_tpu.train import trainer as jtrainer
from nunerf_tpu_torch.convert import flat_leaves, load_jax_params, to_jax_tree
from nunerf_tpu_torch.models.stage1 import PARAM_KEYS
from nunerf_tpu_torch.train import trainer as ttrainer
from port_helpers import jitter_tree
from scene_utils import make_test_scene


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small CPU tensors gain nothing from torch's threads, and the suite's
    workers share the machine's cores: one thread each keeps them from
    oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RN = 16
CFG = {
    "name": "tiny", "network": "shape", "database_name": "nerf/tiny", "is_nerf": True,
    "loss": ["nerf_render", "eikonal", "std", "init_sdf_reg", "occ", "mask", "outer_reg"],
    "n_samples": 8, "n_importance": 8, "up_sample_steps": 2,
    "n_bg_samples": 4, "n_front_samples": 2, "n_back_samples": 2,
    "sdf_n_layers": 4, "perturb": 0.0, "train_ray_num": RN, "test_ray_num": 64,
    "occ_loss_max_pn": 1 << 20, "mixed_precision": False, "sdf_mixed_precision": False,
    "lr_cfg": {"lr": 5e-4, "end_warm": 2, "end_iter": 100},
    "compilation_cache_dir": "", "downsample_ratio": 0.5,
    "total_step": 3, "train_log_step": 1, "save_interval": 1000, "val_interval": 1000,
}


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("datasets")
    make_test_scene(str(root / "tiny"), n_train=3, n_test=1, h=20, w=24)
    return str(root)


def _cfg(dataset, tmp_path, **kw):
    return dict(CFG, dataset_dir=dataset, model_dir=str(tmp_path / "model"), **kw)


def _indices(n_rays, n_steps, seed=0):
    rs = np.random.RandomState(seed)
    return [torch.as_tensor(rs.randint(0, n_rays, RN)) for _ in range(n_steps)]


def test_three_steps_match_the_jax_trainer(dataset, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    jtr = jtrainer.Trainer(_cfg(dataset, tmp_path / "jax"), n_devices=1)
    params = jitter_tree(jax.device_get(jtr.params), 1, 0.05)
    # the SDF about |x| - 1.2: the init-SDF regulariser's "large" term is live
    params["sdf"]["params"][f"lin{CFG['sdf_n_layers']}"]["b"][0] -= 0.7
    opt_state = jtr.optimizer.init(params)
    ttr = ttrainer.Trainer(_cfg(dataset, tmp_path / "port"), device="cpu")
    load_jax_params(ttr.renderer, params, PARAM_KEYS)
    before = flat_leaves(params)
    n_rays = jdr.num_rays(jtr.device_store)
    assert ttr.num_rays == n_rays
    for step in range(3):
        rng = jax.random.PRNGKey(100 + step)
        r_sel, _ = jax.random.split(rng)
        idx = np.asarray(jax.random.randint(r_sel, (RN,), 0, n_rays))
        jbatch = jdr.sample_rays(jtr.device_store, jnp.asarray(idx))
        params, opt_state, jterms = jtr.train_step(params, opt_state, jtr.device_store, rng,
                                                   jnp.asarray(step, jnp.int32))
        ttr.sample_indices = lambda s: torch.as_tensor(idx.copy())
        tbatch = ttr.batch(torch.as_tensor(idx.copy()))
        assert sorted(tbatch) == sorted(jbatch)
        for k in jbatch:
            np.testing.assert_allclose(tbatch[k].numpy(), np.asarray(jbatch[k]), atol=1e-5,
                                       err_msg=k)
        tterms = ttr.train_step(step)
        assert ttr.train.optimizer.param_groups[0]["lr"] == float(jtr.schedule(step))
        assert ttr.schedule(step) == jtr.schedule_host(step)
        jterms = {k: float(v) for k, v in jterms.items()}
        assert sorted(tterms) == sorted(jterms)
        total = abs(jterms["loss_total"])
        for k, v in jterms.items():
            assert abs(float(tterms[k]) - v) <= 1e-4 * abs(v) + 1e-6 * total, (step, k)
        assert jterms["loss_sdf_large"] > 1e-3
    got, want = flat_leaves(to_jax_tree(ttr.renderer, PARAM_KEYS)), flat_leaves(params)
    assert sorted(got) == sorted(want)
    lr_sum = sum(jtr.schedule_host(k) for k in range(3))
    moved = 0
    for k, w in want.items():
        w = np.asarray(w)
        upd = np.linalg.norm(w - before[k])
        moved += upd > 0
        assert np.linalg.norm(got[k] - w) <= 5e-2 * upd, k
        assert np.abs(got[k] - w).max() <= 2 * lr_sum, k
    assert moved > len(want) // 2


def test_precomputed_rays_give_the_compact_stores_batch(dataset, tmp_path):
    """``device_ray_synthesis: false`` keeps every ray's arrays on the device
    (the JAX trainer's precomputed path): the same batch as the compact
    store's for the same indices, at the atol of ``sample_rays``."""
    compact = ttrainer.Trainer(_cfg(dataset, tmp_path / "a"), device="cpu")
    flat = ttrainer.Trainer(_cfg(dataset, tmp_path / "b", device_ray_synthesis=False),
                            device="cpu")
    assert compact.compact and not flat.compact and flat.num_rays == compact.num_rays
    idx = _indices(flat.num_rays, 1)[0]
    a, b = compact.batch(idx), flat.batch(idx)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_allclose(b[k].numpy(), a[k].numpy(), atol=1e-5, err_msg=k)


def _run_straight_and_resumed(dataset, tmp_path, cfg_extra=None):
    cfg = _cfg(dataset, tmp_path, **(cfg_extra or {}))
    idx = None
    results = {}
    for name, cuts in (("straight", (4,)), ("resumed", (2, 4))):
        for total in cuts:
            tr = ttrainer.Trainer(dict(cfg, model_dir=str(tmp_path / name), total_step=total,
                                       save_interval=2), device="cpu")
            if idx is None:
                idx = _indices(tr.num_rays, 4)
            tr.sample_indices = lambda s: idx[s]
            tr.run()
            tr.logger.close()
        results[name] = tr
    return results


def test_resume_continues_the_same_run(dataset, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    res = _run_straight_and_resumed(dataset, tmp_path)
    assert "resumed from" in capsys.readouterr().out
    a, b = res["straight"], res["resumed"]
    assert a.train.n_updates == b.train.n_updates == 4
    for (na, pa), (nb, pb) in zip(a.renderer.named_parameters(), b.renderer.named_parameters()):
        assert na == nb and torch.equal(pa, pb), na
        sa, sb = a.train.optimizer.state[pa], b.train.optimizer.state[pb]
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa[key], sb[key]), (na, key)
    logs = [json.loads(line) for line in open(os.path.join(b.model_dir, "train_log.jsonl"))]
    assert [r["step"] for r in logs] == [1, 2, 3, 4]
    assert all(np.isfinite(r["loss_total"]) for r in logs)


def test_checkpoints_cross_between_the_packages(dataset, tmp_path, monkeypatch, capsys):
    """A JAX trainer's checkpoint loads into the port (Adam afresh at its
    step, which it says); a port checkpoint's ``params`` is the JAX tree,
    read by the JAX loader and by ``convert.load_jax_checkpoint``."""
    monkeypatch.chdir(tmp_path)
    from nunerf_tpu_torch.convert import load_jax_checkpoint

    jr = JShapeRenderer(_cfg(dataset, tmp_path))
    jparams = jitter_tree(jr.init_params(jax.random.PRNGKey(3)), 2, 0.05)
    path = str(tmp_path / "jax.ckpt")
    jtrainer.save_checkpoint(path, 7, jparams, optax.adam(1e-3).init(jparams), 12.5)
    tr = ttrainer.Trainer(_cfg(dataset, tmp_path), device="cpu")
    assert tr.load(path) == (7, 12.5)
    assert "cannot be read" in capsys.readouterr().out
    assert tr.train.n_updates == 7 and not tr.train.optimizer.state
    got = flat_leaves(to_jax_tree(tr.renderer, PARAM_KEYS))
    for k, v in flat_leaves(jparams).items():
        np.testing.assert_array_equal(got[k], np.asarray(v))

    tr.train_step(7)
    port_path = str(tmp_path / "port.ckpt")
    tr.save(port_path, 8, 13.0)
    step, params, opt_state, best = jtrainer.load_checkpoint(port_path)
    assert (step, best) == (8, 13.0) and opt_state["count"] == 8
    assert (jax.tree_util.tree_structure(params)
            == jax.tree_util.tree_structure(jax.device_get(jparams)))
    assert load_jax_checkpoint(port_path)[0] == 8
    again = ttrainer.Trainer(_cfg(dataset, tmp_path / "again"), device="cpu")
    assert again.load(port_path) == (8, 13.0) and again.train.n_updates == 8
    for (n, p), (_, q) in zip(tr.renderer.named_parameters(), again.renderer.named_parameters()):
        assert torch.equal(p, q)
        assert torch.equal(tr.train.optimizer.state[p]["exp_avg"],
                           again.train.optimizer.state[q]["exp_avg"]), n


def test_stage2_loop_leaves_the_frozen_subtree_untouched(dataset, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    from nunerf_tpu_torch.tracing.mesh_ops import extract_geometry, save_ply

    s1 = ttrainer.Trainer(_cfg(dataset, tmp_path, total_step=1), device="cpu")
    s1.run()
    mesh = str(tmp_path / "outer.ply")
    save_ply(mesh, *extract_geometry(lambda p: np.linalg.norm(p, axis=-1) - 0.5,
                                     resolution=12))
    s1_cfg = {k: CFG[k] for k in ("sdf_n_layers", "n_samples", "n_importance",
                                  "n_bg_samples", "mixed_precision", "sdf_mixed_precision")}
    cfg = dict(_cfg(dataset, tmp_path), name="tiny_s2", network="stage2", zero_thickness=True,
               stage1_cfg=s1_cfg, stage1_ckpt_dir=s1.ckpt_path, stage1_mesh_dir=mesh,
               loss=["eikonal", "std", "nerf_render"], n_samples_outer=16,
               n_bg_importance=4, n_samples_inner=8, inner_up_rounds=1, inner_up_each=4,
               total_step=2, val_interval=2, save_interval=2)
    tr = ttrainer.Trainer(cfg, device="cpu")
    assert tr.renderer.scene.kernel_tol == 1e-6
    frozen = {n: p.detach().clone() for n, p in tr.renderer.stage1.named_parameters()}
    trainable = {n: p.detach().clone() for n, p in tr.renderer.named_parameters()
                 if p.requires_grad}
    best = tr.run()
    for n, p in tr.renderer.stage1.named_parameters():
        assert torch.equal(frozen[n], p), n
    changed = [n for n, p in tr.renderer.named_parameters()
               if p.requires_grad and not torch.equal(trainable[n], p)]
    assert "sdf_inner.lin0.v" in changed
    assert np.isfinite(best)
    _, params, opt_state, _ = ttrainer.load_checkpoint(tr.ckpt_path)
    assert sorted(params) == ["frozen", "train"]
    assert sorted(opt_state["exp_avg"]) == ["train"] and opt_state["count"] == 2
    logs = [json.loads(line) for line in open(os.path.join(tr.model_dir, "train_log.jsonl"))]
    assert [r["prefix"] for r in logs] == ["train", "train", "val"]


def test_build_renderer_dispatch():
    from nunerf_tpu_torch.models import build_renderer, name2renderer
    from nunerf_tpu_torch.models.stage1 import ShapeRenderer

    from nunerf_tpu_torch.models.stage2 import Stage2Renderer
    from nunerf_tpu_torch.models.stage2_shell import Stage2ShellRenderer
    from nunerf_tpu_torch.tracing.mesh_ops import extract_geometry
    from nunerf_tpu_torch.tracing.scene import Scene

    r = build_renderer({"sdf_n_layers": 2}, device="cpu", seed=1)
    assert isinstance(r, ShapeRenderer) and name2renderer["shape"] is ShapeRenderer
    # stage 2: zero_thickness picks the renderer (run_training.py:16-20)
    scene = Scene(extract_geometry(lambda p: np.linalg.norm(p, axis=-1) - 0.5,
                                   resolution=8), device="cpu")
    s2 = {"network": "stage2", "stage1_cfg": {"sdf_n_layers": 2}, "sdf_n_layers": 2}
    for zero, cls in ((True, Stage2Renderer), (False, Stage2ShellRenderer)):
        r2 = build_renderer(dict(s2, zero_thickness=zero), scene=scene, stage1=r,
                            device="cpu", seed=1)
        assert type(r2) is cls
    with pytest.raises(NotImplementedError):
        build_renderer({"network": "what"}, device="cpu")
    assert name2renderer["stage2"].__name__ == "Stage2Renderer"


def test_logger_debug_and_profiling(tmp_path, monkeypatch):
    from nunerf_tpu_torch.utils import debug, profiling

    log = ttrainer.Logger(str(tmp_path), use_tb=False)
    log.log({"a": torch.tensor(1.5), "b": 2}, 3)
    log.close()
    assert json.loads(open(tmp_path / "train_log.jsonl").read()) == \
        {"step": 3, "prefix": "train", "a": 1.5, "b": 2.0}
    monkeypatch.setenv("NUNERF_DEBUG_NAN", "1")
    assert debug.debug_nan_enabled()
    debug.check_finite_tree({"x": torch.ones(3), "y": [np.zeros(2)]})
    with pytest.raises(FloatingPointError, match=r"terms\['y'\]\[1\]: 1/2 bad"):
        debug.check_finite_tree({"y": [1.0, np.array([0.0, np.nan])]}, "terms")
    timer = profiling.StepTimer(100, warmup=1, device="cpu")
    for _ in range(3):
        timer.tick()
    assert timer.steps_timed == 2 and timer.rays_per_sec > 0
    with profiling.profile_trace(None):
        pass
