"""The rank processes of ``tests/test_torch_port_parallel.py``.

Each job runs in two spawned processes joined into one ``gloo`` group
through a ``file://`` rendezvous (``nunerf_tpu_torch.parallel.init_multihost``),
each on one thread.  A spawned child imports the module of its target, so
this module imports no JAX (``tests/port_helpers.py`` does).  ``Ranks``
launches a job and returns at once; ``Ranks.results`` joins the ranks within
a time limit, kills a rank that hangs and fails, and returns each rank's
result.
"""

import multiprocessing as mp
import os
import pickle
import sys
import time
import traceback

import numpy as np
import torch

WORLD = 2
RN = 16

# the stage-1 config of tests/test_torch_port_stage1.py: f32, no draws, the
# occlusion loss's top-K over every point
JAX_CFG = {
    "is_nerf": True,
    "loss": ["nerf_render", "eikonal", "std", "init_sdf_reg", "occ", "mask",
             "outer_reg"],
    "n_samples": 8, "n_importance": 8, "up_sample_steps": 2,
    "n_bg_samples": 4, "n_front_samples": 2, "n_back_samples": 2,
    "sdf_n_layers": 4, "perturb": 0.0, "train_ray_num": RN,
    "occ_loss_step": 20000, "occ_loss_max_pn": 1 << 20,
    "mixed_precision": False, "sdf_mixed_precision": False,
}
# the port against itself: perturbed samples and an occlusion subset of 64
# of the 16 x 16 inner points, both drawn over the global batch
DRAW_CFG = dict(JAX_CFG, perturb=1.0, occ_loss_max_pn=64)
# the uneven case: every gated term on at step 0
UNEVEN_CFG = dict(JAX_CFG, occ_loss_step=0, outer_reg_step=0)

S2_S1_CFG = {"is_nerf": True, "get_mask": False, "sdf_n_layers": 4,
             "shader_config": {"sphere_direction": False},
             "n_samples": 12, "n_bg_samples": 4, "n_importance": 4,
             "up_sample_steps": 2, "apply_occ_loss": False,
             "mixed_precision": False, "sdf_mixed_precision": False}
S2_CFG = {"is_nerf": True, "zero_thickness": True, "stage1_cfg": S2_S1_CFG,
          "sdf_n_layers": 4, "shader_config": {"sphere_direction": False},
          "n_samples_outer": 16, "n_bg_importance": 4,
          "n_samples_inner": 8, "inner_up_rounds": 1, "inner_up_each": 4,
          "loss": ["nerf_render", "eikonal", "std"], "eikonal_weight": 0.02,
          "mixed_precision": False, "sdf_mixed_precision": False}
S2_STEP = 10


def ray_batch(rn=RN, seed=0):
    """``tests/test_parallel.py``'s rays: from (0, 0, -2.5) towards Gaussian
    targets."""
    rs = np.random.RandomState(seed)
    origins = np.tile(np.array([[0.0, 0.0, -2.5]], np.float32), (rn, 1))
    dirs = rs.randn(rn, 3).astype(np.float32) * 0.3 - origins
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return {"rays_o": origins, "rays_d": dirs.astype(np.float32),
            "near": np.full((rn, 1), 0.8, np.float32),
            "far": np.full((rn, 1), 4.5, np.float32),
            "rgbs": rs.rand(rn, 3).astype(np.float32),
            "masks": np.ones((rn,), np.float32)}


def uneven_batch(rn=RN, seed=1):
    """Shard 0's rays go through the unit sphere with masks of 1; shard 1's
    all miss it but one, with masks of 0 but one: every masked mean sees
    most of its points on shard 0."""
    b = ray_batch(rn, seed)
    half = rn // 2
    rs = np.random.RandomState(seed + 1)
    away = np.array([0.0, 0.0, -1.0], np.float32) + 0.05 * rs.randn(half, 3).astype(np.float32)
    d = b["rays_d"].copy()
    d[half + 1:] = away[1:] / np.linalg.norm(away[1:], axis=-1, keepdims=True)
    b["rays_d"] = d
    b["masks"] = np.concatenate([np.ones(half), np.zeros(half)]).astype(np.float32)
    b["masks"][half] = 1.0
    return b


def stage2_mesh():
    from nunerf_tpu_torch.tracing.mesh_ops import extract_geometry
    return extract_geometry(lambda p: np.linalg.norm(p, axis=-1) - 0.5, resolution=16)


# ---------------------------------------------------------------------------
# steps, shared by the ranks and the one-process side of the tests

def floats(terms):
    return {k: float(torch.as_tensor(v).detach()) for k, v in terms.items()}


def stage1_grads(cfg, params, batch, step, mesh=None, dtype=torch.float32, seed=None,
                 generator_seed=None):
    """One stage-1 step's loss terms, gradients (JAX-tree leaves) and
    ``ray_rgb``, on this process's rows under ``mesh``; the weights are the
    JAX tree ``params`` or, with ``seed``, drawn from it."""
    from nunerf_tpu_torch.convert import flat_leaves, load_jax_params, to_jax_tree
    from nunerf_tpu_torch.models.stage1 import PARAM_KEYS, ShapeRenderer
    from nunerf_tpu_torch.parallel.mesh import shard_batch
    from nunerf_tpu_torch.train.trainer import TrainStep

    prev = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        renderer = ShapeRenderer(cfg, device="cpu", seed=seed or 0)
        if params is not None:
            load_jax_params(renderer, params, PARAM_KEYS)
        renderer.to(dtype)
        if mesh is not None:  # else the renderer's one-process mesh
            renderer.mesh = mesh
        selected = []
        select = renderer._occ_select

        def counted(*a):
            idx = select(*a)
            selected.append(len(idx))
            return idx

        renderer._occ_select = counted
        batch = shard_batch(batch, renderer.mesh)
        batch = {k: torch.as_tensor(v).to(dtype) for k, v in batch.items()}

        def gen():
            return (None if generator_seed is None
                    else torch.Generator().manual_seed(generator_seed))

        with torch.no_grad():
            rgb = renderer.train_outputs(batch, step, gen())["ray_rgb"].numpy()
        selected.clear()
        terms = TrainStep(renderer).compute_grads(batch, step, gen())
        grads = flat_leaves(to_jax_tree(renderer, PARAM_KEYS, "grad"))
    finally:
        torch.set_default_dtype(prev)
    return {"terms": floats(terms), "grads": grads, "rgb": rgb,
            "occ_selected": sum(selected)}


def stage2_step(mesh=None):
    """One Adam step of the small zero-thickness stage 2: loss terms, the
    trainable gradients, and whether the frozen stage-1 subtree came out
    bit-equal."""
    from nunerf_tpu_torch.models.stage1 import ShapeRenderer
    from nunerf_tpu_torch.models.stage2 import Stage2Renderer
    from nunerf_tpu_torch.parallel.mesh import shard_batch
    from nunerf_tpu_torch.tracing.scene import Scene
    from nunerf_tpu_torch.train.trainer import TrainStep

    scene = Scene(stage2_mesh(), tile=512, device="cpu")
    s1 = ShapeRenderer(S2_S1_CFG, device="cpu", seed=7)
    renderer = Stage2Renderer(S2_CFG, scene, s1, device="cpu", seed=8)
    if mesh is not None:
        renderer.mesh = mesh
    frozen = {n: p.detach().clone() for n, p in renderer.stage1.named_parameters()}
    b = ray_batch(32, seed=3)
    batch = {k: b[k] for k in ("rays_o", "rays_d", "rgbs")}
    batch = shard_batch(batch, renderer.mesh)
    train = TrainStep(renderer, 1e-3)
    terms = train(batch, S2_STEP)
    grads = {n: p.grad.numpy().copy() for n, p in renderer.named_parameters()
             if p.requires_grad}
    untouched = all(p.grad is None and torch.equal(frozen[n], p.detach())
                    for n, p in renderer.stage1.named_parameters())
    return {"terms": floats(terms), "grads": grads, "frozen_untouched": untouched}


def trainer_run(cfg, n_steps, resume_to):
    """A ``Trainer`` of ``cfg`` on the CPU: ``n_steps`` steps, then a new
    trainer resuming to ``resume_to``; the parameters after each, the log
    and the checkpoint saves made by this process."""
    from nunerf_tpu_torch.convert import flat_leaves, to_jax_tree
    from nunerf_tpu_torch.models.stage1 import PARAM_KEYS
    from nunerf_tpu_torch.train import trainer as ttrainer

    saves = []
    save = ttrainer.save_checkpoint
    ttrainer.save_checkpoint = lambda path, *a: saves.append(path) or save(path, *a)
    out = {}
    try:
        for name, total in (("straight", n_steps), ("resumed", resume_to)):
            tr = ttrainer.Trainer(dict(cfg, total_step=total), device="cpu")
            out.setdefault("init", flat_leaves(to_jax_tree(tr.renderer, PARAM_KEYS)))
            out[f"best_{name}"] = tr.run()
            out[name] = flat_leaves(to_jax_tree(tr.renderer, PARAM_KEYS))
            out[f"{name}_logger"] = type(tr.logger).__name__
            tr.logger.close()
    finally:
        ttrainer.save_checkpoint = save
    log = os.path.join(tr.model_dir, "train_log.jsonl")
    out["saves"] = saves
    out["log"] = open(log).read() if os.path.exists(log) else None
    return out


# ---------------------------------------------------------------------------
# the jobs: (rank, payload) -> a picklable result

def job_stage1_vs_jax(rank, payload):
    from nunerf_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(WORLD)
    return {(step, str(dtype)): stage1_grads(JAX_CFG, payload[step], payload["batch"], step,
                                             mesh, dtype)
            for step in (0, 25000) for dtype in (torch.float32, torch.float64)}


def job_port(rank, payload):
    """The port sharded: the drawn step, the uneven step, a stage-2 step, and
    the batch helpers."""
    from nunerf_tpu_torch.parallel import multihost
    from nunerf_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh()
    out = {"draws": stage1_grads(DRAW_CFG, None, ray_batch(), 25000, mesh, seed=3,
                                 generator_seed=5),
           "uneven": stage1_grads(UNEVEN_CFG, payload["params"], uneven_batch(), 0, mesh),
           "stage2": stage2_step(mesh)}
    b = ray_batch()
    local = multihost.host_local_batch(b)
    back = multihost.global_sharded_batch(local, mesh)
    out["round_trip"] = all(np.array_equal(back[k].numpy(), b[k]) for k in b)
    out["local_rows"] = local["rays_o"].shape[0]
    return out


def job_trainer(rank, payload):
    os.makedirs(payload["cwd"][rank], exist_ok=True)
    os.chdir(payload["cwd"][rank])  # validation images go to ./data
    return trainer_run(payload["cfg"], payload["n_steps"], payload["resume_to"])


def job_cli(rank, payload):
    """``train`` and ``eval-images`` through ``cli.main`` in torchrun's
    environment, as two launches (a rendezvous port each): the CLI joins the
    group itself, and leaves it."""
    import torch.distributed as dist
    from nunerf_tpu_torch import cli

    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(WORLD),
                      MASTER_ADDR="localhost", MASTER_PORT=str(payload["ports"][0]))
    os.makedirs(payload["cwd"][rank], exist_ok=True)
    os.chdir(payload["cwd"][rank])
    best = cli.main(["train", "--cfg", payload["cfg"], "--device", "cpu"])
    joined_and_left = not dist.is_initialized()
    os.environ["MASTER_PORT"] = str(payload["ports"][1])
    rec = cli.main(["eval-images", "--cfg", payload["cfg"], "--ckpt", payload["ckpt"],
                    "--split", "test", "--device", "cpu"])
    return {"best": best, "eval": rec,
            "left": joined_and_left and not dist.is_initialized()}


JOBS = {"stage1_vs_jax": job_stage1_vs_jax, "port": job_port, "trainer": job_trainer,
        "cli": job_cli}
# jobs whose processes join their group themselves
OWN_GROUP = {"cli"}


# ---------------------------------------------------------------------------

def _entry(job, rank, world, init_file, out_dir, payload):
    try:
        torch.set_num_threads(1)
        import torch.distributed as dist
        from nunerf_tpu_torch.parallel.multihost import init_multihost

        if job not in OWN_GROUP:
            init_multihost(f"file://{init_file}", world, rank, backend="gloo")
        try:
            res = JOBS[job](rank, payload)
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        with open(os.path.join(out_dir, f"{job}.{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    except BaseException:
        with open(os.path.join(out_dir, f"{job}.{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        sys.exit(1)


class Ranks:
    """The ``world`` processes of one job."""

    def __init__(self, job, payload, tmp_dir, world=WORLD):
        self.job, self.dir, self.world = job, str(tmp_dir), world
        os.makedirs(self.dir, exist_ok=True)
        init_file = os.path.join(self.dir, f"{job}.rendezvous")
        ctx = mp.get_context("spawn")
        self.procs = [ctx.Process(target=_entry, args=(job, r, world, init_file, self.dir,
                                                       payload))
                      for r in range(world)]
        for p in self.procs:
            p.start()
        self._results = None

    def results(self, timeout):
        """Each rank's result; fails when a rank raised, or is still running
        after ``timeout`` seconds from now (it is killed)."""
        if self._results is not None:
            return self._results
        deadline = time.monotonic() + timeout
        for p in self.procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(self.procs) if p.is_alive()]
        for r in hung:
            self.procs[r].kill()
            self.procs[r].join(10)
        errors = []
        for r, p in enumerate(self.procs):
            err = os.path.join(self.dir, f"{self.job}.{r}.err")
            if os.path.exists(err):
                errors.append(f"rank {r}:\n" + open(err).read())
            elif p.exitcode != 0 and r not in hung:
                errors.append(f"rank {r} exited with {p.exitcode}")
        if hung or errors:
            raise AssertionError(f"job {self.job}: ranks {hung} hung past {timeout} s; "
                                 + "\n".join(errors))
        self._results = []
        for r in range(self.world):
            with open(os.path.join(self.dir, f"{self.job}.{r}.pkl"), "rb") as f:
                self._results.append(pickle.load(f))
        return self._results

