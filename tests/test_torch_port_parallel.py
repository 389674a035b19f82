"""The port's data parallelism (``nunerf_tpu_torch/parallel/``) on two
``gloo`` ranks on the CPU.

Every group is two processes spawned by ``tests/torch_parallel_workers.py``
(no JAX there), meeting through a ``file://`` rendezvous under the test's
temporary directory (the CLI's group through torchrun's environment on a
free localhost port), one thread each; every join has a time limit
(``LIMIT``) and a rank that hangs fails the test.  The module's four groups
start together, and the JAX side and the one-process side run meanwhile.

* The sharded step against the JAX step on ``make_mesh(2)`` of the 8-device
  virtual CPU mesh, at step 0 (init-SDF regulariser) and 25000 (occlusion
  loss): the parameters of ``tests/test_torch_port_stage1.py``, its batch,
  its deterministic draws (``perturb`` 0, the occlusion top-K over every
  point) and its tolerances (``rtol * scale + 10 * |port_f32 - port_f64|``,
  rtol 1e-5 on the loss terms and 1e-4 on the gradients; the port's f64
  twin runs sharded too).
* The sharded step against the port's one-process step, at the bounds of
  ``tests/test_parallel.py``: the render at rtol 2e-4, atol 2e-5, the
  gradients at rtol 5e-3, atol 1e-5, with perturbed samples and an
  occlusion subset of 64 of 256 points drawn over the global batch (64
  marched in all); a stage-2 step, the loss at rtol 2e-4 and the frozen
  stage-1 subtree bit-equal.
* An uneven batch: shard 0's rays all hit the sphere, shard 1's all miss
  it but one, with the eikonal, occlusion, init-SDF and outer-reg terms on.
  The sharded gradients equal the one-process ones, and the average of the
  ranks' own local-loss gradients (the naive port) misses them by more
  than the tolerance.
* The ``Trainer`` on ``make_test_scene``: two ranks after 3 steps (with a
  validation) against one process with the same seed; the ranks
  bit-equal; only rank 0 writes; a resume of the two ranks continues as
  the one process's does, though each rank has a ``model_dir`` of its own
  (relative, under its working directory) and only rank 0's holds the
  checkpoint.
* ``train`` and ``eval-images`` through ``cli.main`` in torchrun's
  environment: the ranks join, agree, leave; rank 0 alone writes, and
  alone holds the checkpoint that both evaluate; the sharded evaluation
  equals one process's.
* The helpers: ``shard_batch`` keeps an undividable array whole,
  ``host_local_batch`` -> ``global_sharded_batch`` round-trips,
  ``init_multihost`` does nothing for one process.
"""

import json
import os
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_workers as W
import yaml
from nunerf_tpu_torch.convert import flat_leaves, to_jax_tree
from nunerf_tpu_torch.models.stage1 import PARAM_KEYS, ShapeRenderer
from port_helpers import jitter_tree
from scene_utils import make_test_scene

LIMIT = 300.0  # seconds a group may take from the moment a test waits on it
RTOL_LOSS, RTOL_GRAD, K_COND = 1e-5, 1e-4, 10.0
RENDER_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=5e-3, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_params():
    from nunerf_tpu.models.stage1 import ShapeRenderer as JShapeRenderer
    params = jitter_tree(JShapeRenderer(W.JAX_CFG).init_params(jax.random.PRNGKey(0)),
                         1, 0.05)
    p0 = jax.tree_util.tree_map(np.array, params)
    # the SDF about |x| - 1.2: the regulariser's "large" term is live
    p0["sdf"]["params"][f"lin{W.JAX_CFG['sdf_n_layers']}"]["b"][0] -= 0.7
    return {0: p0, 25000: jax.tree_util.tree_map(np.array, params)}


def _uneven_params():
    params = to_jax_tree(ShapeRenderer(W.UNEVEN_CFG, device="cpu", seed=2), PARAM_KEYS)
    # the SDF about |x| - 1: the regulariser's "large" term is live outside
    # 1.05, and the occlusion loss finds surface points inside the sphere
    params["sdf"]["params"][f"lin{W.UNEVEN_CFG['sdf_n_layers']}"]["b"][0] -= 0.5
    return params


TRAINER_CFG = {
    "name": "tiny", "network": "shape", "database_name": "nerf/tiny", "is_nerf": True,
    "loss": ["nerf_render", "eikonal", "std", "init_sdf_reg", "occ", "mask", "outer_reg"],
    "n_samples": 8, "n_importance": 8, "up_sample_steps": 2,
    "n_bg_samples": 4, "n_front_samples": 2, "n_back_samples": 2,
    "sdf_n_layers": 4, "train_ray_num": W.RN, "test_ray_num": 64,
    "occ_loss_step": 1, "occ_loss_max_pn": 64,
    "mixed_precision": False, "sdf_mixed_precision": False,
    "lr_cfg": {"lr": 5e-4, "end_warm": 2, "end_iter": 100},
    "downsample_ratio": 0.5, "train_log_step": 1, "save_interval": 1000,
    "val_interval": 3,
}


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """The module's four groups, started at once."""
    root = tmp_path_factory.mktemp("parallel")
    make_test_scene(str(root / "datasets" / "tiny"), n_train=3, n_test=1, h=20, w=24)
    jax_params = _jax_params()
    uneven = _uneven_params()
    # model_dir relative, as by default: each rank's own, under its working
    # directory; rank 0's alone holds the checkpoints
    trainer_cfg = dict(TRAINER_CFG, dataset_dir=str(root / "datasets"), model_dir="model")
    cli_cfg = dict(trainer_cfg, name="tiny_cli", model_dir="cli_model", total_step=2)
    with open(root / "cli.yaml", "w") as f:
        yaml.safe_dump(cli_cfg, f)
    socks = [socket.socket() for _ in range(2)]
    for sock in socks:
        sock.bind(("localhost", 0))
    ports = [sock.getsockname()[1] for sock in socks]
    for sock in socks:
        sock.close()
    started = {
        "jax": W.Ranks("stage1_vs_jax", dict(jax_params, batch=W.ray_batch()),
                       root / "jax"),
        "port": W.Ranks("port", {"params": uneven}, root / "port"),
        "trainer": W.Ranks("trainer", {"cfg": trainer_cfg, "n_steps": 3, "resume_to": 5,
                                       "cwd": [str(root / f"rank{r}") for r in range(2)]},
                           root / "trainer"),
        "cli": W.Ranks("cli", {"cfg": str(root / "cli.yaml"), "ports": ports,
                               "ckpt": os.path.join("cli_model", "tiny_cli", "model.ckpt"),
                               "cwd": [str(root / f"cli{r}") for r in range(2)]},
                       root / "cli"),
    }
    yield {"root": root, "jax_params": jax_params, "uneven_params": uneven,
           "trainer_cfg": trainer_cfg, **started}
    for g in started.values():
        for p in g.procs:
            if p.is_alive():
                p.kill()
                p.join(10)


@pytest.fixture(scope="module")
def jax_sharded(groups):
    """Loss terms and gradients of the JAX step on ``make_mesh(2)``."""
    from nunerf_tpu.models.stage1 import ShapeRenderer as JShapeRenderer
    from nunerf_tpu.parallel.mesh import make_mesh, replicate, shard_batch
    from nunerf_tpu.train.loss import compute_losses

    renderer = JShapeRenderer(W.JAX_CFG)
    mesh = make_mesh(2)
    batch = shard_batch(W.ray_batch(), mesh)

    def loss_fn(p, b, step):
        out = renderer.train_outputs(p, b, jax.random.PRNGKey(1), step)
        terms = compute_losses(out, b, step, renderer.cfg)
        return terms["loss_total"], terms

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    out = {}
    for step, params in groups["jax_params"].items():
        (_, terms), grads = grad_fn(replicate(params, mesh), batch,
                                    jnp.asarray(step, jnp.int32))
        out[step] = ({k: float(v) for k, v in terms.items()},
                     {k: np.asarray(v) for k, v in flat_leaves(grads).items()})
    return out


def _leaves_equal(a, b):
    return sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a)


def _bound(rtol, ref64, port32):
    return rtol * np.abs(ref64).max() + K_COND * np.abs(port32 - ref64).max()


@pytest.mark.parametrize("step", [0, 25000])
def test_sharded_step_matches_the_jax_mesh(groups, jax_sharded, step):
    jterms, jgrads = jax_sharded[step]
    ranks = groups["jax"].results(LIMIT)
    r32, r64 = (ranks[0][(step, str(d))] for d in (torch.float32, torch.float64))
    if step < 1000:
        assert jterms["loss_sdf_large"] > 1e-3
    else:
        assert jterms["loss_occ"] > 1e-3 and jterms["loss_outer_reg"] > 0
    t32, t64 = r32["terms"], r64["terms"]
    assert sorted(t32) == sorted(jterms)
    for k, v in jterms.items():
        bound = _bound(RTOL_LOSS, np.float64(t64[k]), np.float64(t32[k])) + 1e-9
        assert abs(t32[k] - v) <= bound, (k, t32[k], v, bound)
    g32, g64 = r32["grads"], r64["grads"]
    assert sorted(g32) == sorted(jgrads)
    for k, v in jgrads.items():
        err = np.abs(g32[k] - v).max()
        assert err <= _bound(RTOL_GRAD, g64[k], g32[k]), (k, err)
    # the ranks hold one global step
    other = ranks[1][(step, str(torch.float32))]
    assert other["terms"] == t32
    assert all(np.array_equal(other["grads"][k], g32[k]) for k in g32)


def test_sharded_render_and_grads_match_one_process(groups):
    ranks = groups["port"].results(LIMIT)
    single = W.stage1_grads(W.DRAW_CFG, None, W.ray_batch(), 25000, seed=3,
                            generator_seed=5)
    got = [r["draws"] for r in ranks]
    np.testing.assert_allclose(np.concatenate([g["rgb"] for g in got]), single["rgb"],
                               **RENDER_TOL)
    for k, v in single["terms"].items():
        np.testing.assert_allclose(got[0]["terms"][k], v, rtol=2e-4, atol=1e-7, err_msg=k)
    assert single["terms"]["loss_occ"] > 1e-3
    for k, v in single["grads"].items():
        np.testing.assert_allclose(got[0]["grads"][k], v, err_msg=k, **GRAD_TOL)
        assert np.array_equal(got[1]["grads"][k], got[0]["grads"][k]), k
    # the occlusion loss's 64 points are drawn over the global batch and
    # marched once in all, a share on each rank
    assert single["occ_selected"] == W.DRAW_CFG["occ_loss_max_pn"]
    assert sum(g["occ_selected"] for g in got) == W.DRAW_CFG["occ_loss_max_pn"]
    assert all(g["occ_selected"] > 0 for g in got)


def test_sharded_stage2_step_matches_one_process(groups):
    ranks = groups["port"].results(LIMIT)
    single = W.stage2_step()
    for r in ranks:
        got = r["stage2"]
        np.testing.assert_allclose(got["terms"]["loss_total"], single["terms"]["loss_total"],
                                   rtol=2e-4)
        assert got["frozen_untouched"]
        for k, v in single["grads"].items():
            np.testing.assert_allclose(got["grads"][k], v, err_msg=k, **GRAD_TOL)
    assert single["frozen_untouched"]


def test_uneven_shards_need_the_global_loss(groups):
    """Shard 1 holds almost none of the masked points: the global step is
    still the one-process step, where averaging the ranks' local-loss
    gradients is not."""
    params = groups["uneven_params"]
    ranks = groups["port"].results(LIMIT)
    batch = W.uneven_batch()
    single = W.stage1_grads(W.UNEVEN_CFG, params, batch, 0)
    for k in ("loss_eikonal", "loss_occ", "loss_sdf_large", "loss_outer_reg"):
        assert single["terms"][k] > 0, k
    got = ranks[0]["uneven"]
    for k, v in single["terms"].items():
        np.testing.assert_allclose(got["terms"][k], v, rtol=2e-4, atol=1e-7, err_msg=k)
    for k, v in single["grads"].items():
        np.testing.assert_allclose(got["grads"][k], v, err_msg=k, **GRAD_TOL)

    half = W.RN // 2
    local = [W.stage1_grads(W.UNEVEN_CFG, params,
                            {k: v[r * half:(r + 1) * half] for k, v in batch.items()}, 0)
             for r in range(2)]
    naive = {k: 0.5 * (local[0]["grads"][k] + local[1]["grads"][k]) for k in single["grads"]}
    off = [k for k, v in single["grads"].items()
           if not np.allclose(naive[k], v, **GRAD_TOL)]
    # the SDF's hidden layers feel the masked and count-normalised terms
    last = f"sdf/lin{W.UNEVEN_CFG['sdf_n_layers']}/"
    sdf = [k for k in naive if k.startswith("sdf/") and not k.startswith(last)]
    assert sdf and set(sdf) <= set(off), sorted(set(sdf) - set(off))


def test_two_rank_trainer_matches_one_process(groups, tmp_path, monkeypatch):
    ranks = groups["trainer"].results(LIMIT)
    cfg = dict(groups["trainer_cfg"], model_dir=str(tmp_path / "model"))
    monkeypatch.chdir(tmp_path)
    single = W.trainer_run(cfg, 3, 5)
    r0, r1 = ranks
    # the ranks are bit-equal, and within the one process's run as the JAX
    # trainer's test holds the port's: each leaf's update within 5e-2 of its
    # norm, every element within twice the summed learning rates (Adam
    # divides each gradient element by its own running magnitude, so an
    # element whose gradient lies in f32 noise may move a step either way)
    lr_sum = 5 * TRAINER_CFG["lr_cfg"]["lr"]
    for name in ("straight", "resumed"):
        assert _leaves_equal(r0[name], r1[name]), name
        for k, w in single[name].items():
            upd = np.linalg.norm(w - single["init"][k])
            assert np.linalg.norm(r0[name][k] - w) <= 5e-2 * upd, (name, k)
            assert np.abs(r0[name][k] - w).max() <= 2 * lr_sum, (name, k)
    np.testing.assert_allclose(r0["best_straight"], single["best_straight"], rtol=1e-4)
    # rank 0 alone writes: the checkpoints, the log, the validation images
    assert r0["saves"] and not r1["saves"]
    assert (r0["straight_logger"], r1["straight_logger"]) == ("Logger", "NullLogger")
    root = groups["root"]
    assert os.path.isdir(root / "rank0" / "data" / "train_vis")
    assert not os.listdir(root / "rank1")
    logs = [json.loads(line) for line in r0["log"].splitlines()]
    want = [json.loads(line) for line in single["log"].splitlines()]
    assert [(r["step"], r["prefix"]) for r in logs] == [(r["step"], r["prefix"]) for r in want]
    assert [r["step"] for r in logs if r["prefix"] == "train"] == [1, 2, 3, 4, 5]
    for a, b in zip(logs, want):
        if "loss_total" in b:
            np.testing.assert_allclose(a["loss_total"], b["loss_total"], rtol=1e-3)


def test_cli_under_torchrun_joins_renders_and_leaves(groups, monkeypatch):
    """``train`` and ``eval-images`` in torchrun's environment: both ranks
    join the group, train and evaluate the same model, leave the group; rank
    0 alone writes, and the sharded evaluation equals one process's."""
    from nunerf_tpu_torch import cli

    r0, r1 = groups["cli"].results(LIMIT)
    assert r0["left"] and r1["left"]
    assert r0["best"] == r1["best"] and r0["eval"] == r1["eval"]
    root = groups["root"]
    assert os.path.exists(root / "cli0" / "data" / "eval" / "tiny_cli" / "eval_test.json")
    assert not os.listdir(root / "cli1")
    cfg = yaml.safe_load(open(root / "cli.yaml"))
    monkeypatch.chdir(root)
    ckpt = root / "cli0" / "cli_model" / "tiny_cli" / "model.ckpt"
    assert ckpt.exists() and r0["eval"]["step"] == 2
    single = cli.eval_images(cfg, str(ckpt), "test", device="cpu")
    for a, b in zip(r0["eval"]["views"], single["views"]):
        assert a["view"] == b["view"]
        np.testing.assert_allclose([a["psnr"], a["ssim"]], [b["psnr"], b["ssim"]], rtol=1e-4)


def test_helpers_on_one_process_and_two(groups, monkeypatch):
    from nunerf_tpu_torch.parallel import multihost
    from nunerf_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_batch

    # shard_batch: rows of a dividing array, an undividable one whole
    mesh = Mesh(None, rank=1, size=2, device=torch.device("cpu"))
    out = shard_batch({"a": np.arange(8), "b": np.arange(3), "s": np.float32(2)}, mesh)
    assert out["a"].tolist() == [4, 5, 6, 7]
    assert out["b"].tolist() == [0, 1, 2] and float(out["s"]) == 2.0

    # one process: init_multihost does nothing, the mesh has no group
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert multihost.init_multihost() is None
    assert multihost.init_multihost(num_processes=1) is None
    assert not torch.distributed.is_initialized()
    one = make_mesh()
    assert (one.size, one.rank, one.distributed) == (1, 0, False)
    with pytest.raises(ValueError, match="processes"):
        make_mesh(2)
    b = W.ray_batch()
    assert multihost.host_local_batch(b)["rays_o"].shape[0] == W.RN

    # two: host_local_batch -> global_sharded_batch round-trips
    ranks = groups["port"].results(LIMIT)
    assert [r["local_rows"] for r in ranks] == [W.RN // 2] * 2
    assert all(r["round_trip"] for r in ranks)
