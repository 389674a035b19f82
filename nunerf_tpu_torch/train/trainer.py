"""Training orchestration of both stages; counterpart of
``nunerf_tpu/train/trainer.py`` (reference ``train/trainer.py:21-239``).

* ``TrainStep``: one step, ``renderer.train_outputs`` -> ``compute_losses``
  -> backward -> one Adam update with optax.adam's constants (b1 0.9, b2
  0.999, eps 1e-8) of the parameters that require grad.  A
  ``Stage2Renderer`` holds its stage-1 weights with ``requires_grad_(False)``:
  they get no optimizer state and no update, the counterpart of
  ``optax.multi_transform`` with ``set_to_zero`` on the ``frozen`` subtree.
* ``Trainer``: the loop around it.  It builds the renderer the config names
  (``models.build_renderer``), the database and its compact ray store on the
  device, and the warm-up cosine schedule; each step samples its rays on the
  device (``data/device_rays.py``); ``run`` resumes, logs, validates, keeps
  the best-PSNR checkpoint and saves at the JAX trainer's intervals; with
  ``keep`` it also writes ``model_<step>.ckpt.gz`` (parameters only,
  gzip'd) at each of those steps, outside the step, so the run is the same.
* ``save_checkpoint`` / ``load_checkpoint`` (either a pickle or a gzip'd
  one) and ``Logger``.

Data parallelism (``Trainer(cfg, n_devices=...)`` in every process of a
``torch.distributed`` group, ``nunerf_tpu_torch.parallel``): the ranks run
the one-process step.  Every rank draws the same global ``train_ray_num``
indices and keeps its contiguous share; the renderer's reductions and draws
are global (``models/stage1.py``); ``TrainStep`` averages the gradients in
one flat all-reduce, so Adam takes the same update on every rank; the
parameters are broadcast from rank 0 at the start and after a load; rank 0
alone writes checkpoints, the log and validation images; ``render_image``
splits each chunk over the ranks and gathers it.

Differences of form from the JAX package, not of result:

* ray indices come from ``torch.randint`` on the device with the trainer's
  own generator (seeded ``random_seed + 1``), not from ``jax.random`` inside
  the jitted step; ``Trainer.sample_indices`` can be replaced to pass them
  in;
* there is no ``lax.scan``: a chunk is a loop of eager steps whose loss
  terms are summed on the device and leave it only at log steps, so the
  loop adds no synchronisation to the step;
* a checkpoint is a pickle of numpy only: ``params`` in the JAX tree's
  layout (``convert.to_jax_tree``), so the JAX package's loader and the
  port's ``Stage2Renderer(cfg['stage1_ckpt_dir'])`` read either package's
  checkpoints, and ``opt_state`` as Adam's moments by the same paths with
  the update count.  The JAX trainer's ``opt_state`` is flax msgpack, which
  the port cannot read: resuming from a JAX checkpoint starts Adam's moments
  afresh at its step and says so.  A port checkpoint also carries the
  trainer's draws (``rng``: the index generator's and the renderer's
  states), so a run resumed on the same kind of device draws what the run
  never stopped would have drawn;
* validation images are ``.png`` (``train/metrics.py``);
* the JAX-only config keys ``compilation_cache_dir``, ``matmul_precision``
  and ``scan_chunk``'s compile-time role have no counterpart: the first two
  are accepted and ignored, the last still caps the chunk of steps between
  two host reads.
"""

from __future__ import annotations

import gzip
import json
import os
import pickle
import time
from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch

from nunerf_tpu_torch.config import TRAINER_DEFAULTS, merge_cfg
from nunerf_tpu_torch.device import resolve_device
from nunerf_tpu_torch.parallel.mesh import gather_outputs, make_mesh, replicate
from nunerf_tpu_torch.train.loss import compute_losses


class TrainStep:
    """Owns the optimizer of ``renderer``'s parameters.

    ``lr`` is a constant or a schedule ``optimizer step -> lr`` evaluated at
    the number of updates taken so far, as optax evaluates its schedules.
    Under the renderer's data-parallel ``mesh`` the loss is the global one and
    the gradients are averaged over the ranks (``reduce_grads``)."""

    def __init__(self, renderer, lr: Union[float, Callable[[int], float]] = 5e-4):
        self.renderer = renderer
        self.lr = lr
        self.params = [p for p in renderer.parameters() if p.requires_grad]
        self.optimizer = torch.optim.Adam(self.params, lr=self._lr(0),
                                          betas=(0.9, 0.999), eps=1e-8)
        self.n_updates = 0
        self._flat_grad, self._grad_views = None, []

    def _lr(self, count: int) -> float:
        return self.lr(count) if callable(self.lr) else float(self.lr)

    def loss_fn(self, batch, step: int, generator: Optional[torch.Generator] = None):
        outputs = self.renderer.train_outputs(batch, step, generator)
        terms = compute_losses(outputs, batch, step, self.renderer.cfg, self.renderer.mesh)
        return terms["loss_total"], terms

    def compute_grads(self, batch, step: int, generator=None):
        """Loss terms after filling every parameter's ``.grad`` (zeros where
        the loss does not reach a parameter, as ``jax.grad`` gives; the
        ranks' average under a mesh)."""
        self.optimizer.zero_grad(set_to_none=False)
        loss, terms = self.loss_fn(batch, step, generator)
        loss.backward()
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.renderer.mesh.distributed:
            self.reduce_grads(self.renderer.mesh)
        return terms

    def reduce_grads(self, mesh):
        """Average every gradient over the ranks in one flat buffer: one
        collective a step (the average pairs with ``global_sum``'s backward,
        ``parallel/mesh.py``).  The gradients are views of the buffer, which
        the backward fills in place from the second step on; the first step,
        or one whose gradients were replaced, copies them in."""
        views = self._grad_views
        if len(views) != len(self.params) or any(p.grad is not v
                                                 for p, v in zip(self.params, views)):
            self._flat_grad = torch.cat([p.grad.reshape(-1) for p in self.params])
            self._grad_views, i = [], 0
            for p in self.params:
                p.grad = self._flat_grad[i:i + p.numel()].view_as(p)
                self._grad_views.append(p.grad)
                i += p.numel()
        mesh.average_(self._flat_grad)

    def load_state(self, opt_state, top):
        """Adam's update count and moments from ``opt_state`` (``count``,
        and ``exp_avg`` / ``exp_avg_sq`` as JAX trees, ``top`` mapping their
        heads to name prefixes), in each parameter's dtype."""
        from nunerf_tpu_torch.convert import jax_tree_to_named

        self.optimizer.state.clear()
        self.n_updates = int(opt_state["count"])
        names = {n: p for n, p in self.renderer.named_parameters()}
        moments = {key: jax_tree_to_named(opt_state[key], top)
                   for key in ("exp_avg", "exp_avg_sq")}
        for name, m in moments["exp_avg"].items():
            p = names[name]
            self.optimizer.state[p] = {
                "step": torch.tensor(float(opt_state["count"]), dtype=torch.float32),
                "exp_avg": torch.as_tensor(m, device=p.device, dtype=p.dtype).clone(),
                "exp_avg_sq": torch.as_tensor(moments["exp_avg_sq"][name], device=p.device,
                                              dtype=p.dtype).clone()}

    def apply(self):
        for group in self.optimizer.param_groups:
            group["lr"] = self._lr(self.n_updates)
        self.optimizer.step()
        self.n_updates += 1

    def __call__(self, batch, step: int, generator=None) -> Dict[str, torch.Tensor]:
        """One training step; returns the detached loss terms."""
        terms = self.compute_grads(batch, step, generator)
        self.apply()
        return {k: v.detach() if torch.is_tensor(v) else v for k, v in terms.items()}


class NullLogger:
    """The logger of the ranks other than 0: writes nothing."""

    def log(self, scalars, step, prefix="train"):
        pass

    def close(self):
        pass


class Logger:
    """Scalar logging: JSONL always, tensorboardX when it imports
    (reference train/train_tools.py:97-112)."""

    def __init__(self, log_dir: str, use_tb: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self.jsonl = open(os.path.join(log_dir, "train_log.jsonl"), "a")
        self.tb = None
        if use_tb:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                self.tb = SummaryWriter(log_dir)

    def log(self, scalars: Dict[str, float], step: int, prefix: str = "train"):
        rec = {"step": step, "prefix": prefix}
        rec.update({k: float(v) for k, v in scalars.items()})
        self.jsonl.write(json.dumps(rec) + "\n")
        self.jsonl.flush()
        if self.tb is not None:
            for k, v in scalars.items():
                self.tb.add_scalar(f"{prefix}/{k}", float(v), step)

    def close(self):
        self.jsonl.close()
        if self.tb is not None:
            self.tb.close()


def _opener(path: str):
    return gzip.open if path.endswith(".gz") else open


def save_checkpoint(path: str, step: int, params, opt_state, best_para: float, rng=None):
    """The reference's {step, best_para, network_state_dict,
    optimizer_state_dict} (train/trainer.py:218-225) as a pickle of numpy:
    ``params`` the JAX-layout tree, ``opt_state`` a dict (``count``,
    ``exp_avg``, ``exp_avg_sq``) or None, ``rng`` the trainer's draws
    (``Trainer.rng_state``) where given, written through ``.tmp`` and
    ``os.replace`` so that a crash never leaves half a checkpoint; gzip'd
    where ``path`` ends in ``.gz``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    blob = {"step": int(step), "best_para": float(best_para), "params": params,
            "opt_state": opt_state}
    if rng is not None:
        blob["rng"] = rng
    tmp = path + ".tmp"
    with _opener(path)(tmp, "wb") as f:
        pickle.dump(blob, f)
    os.replace(tmp, path)


def _read_blob(path: str):
    with _opener(path)(path, "rb") as f:
        return pickle.load(f)


def _unpack(blob):
    opt_state = blob.get("opt_state")
    if not isinstance(opt_state, dict):
        opt_state = None
    return blob["step"], blob["params"], opt_state, blob.get("best_para", 0.0)


def load_checkpoint(path: str):
    """(step, params, opt_state, best_para) of a checkpoint of either
    package; ``opt_state`` is the port's dict, or ``None`` for a JAX
    checkpoint (flax msgpack bytes).  Unpickling runs code: read only
    checkpoints this project wrote."""
    return _unpack(_read_blob(path))


class Trainer:
    """End-to-end trainer of stage 1 (``network: shape``) and stage 2
    (``network: stage2``: zero-thickness, or the curvature shell when
    ``zero_thickness`` is false), on ``device`` ("cuda" unless the caller
    asks for the CPU).  Stage 2's validation scores TIR-masked pixels, and
    the shell also masks its validation loss by the object mask.

    ``n_devices``: the data-parallel mesh's size (``parallel.make_mesh``),
    by default every rank of the initialised process group, one process
    where there is none.  ``train_ray_num`` and ``test_ray_num`` must divide
    by it.

    ``keep``: steps at which ``run`` also writes the parameters alone,
    gzip'd, to ``model_<step>.ckpt.gz`` beside ``model.ckpt``; each must
    end a chunk of the loop (a multiple of ``chunk_steps``)."""

    def __init__(self, cfg: Dict[str, Any], device="cuda", n_devices=None, keep=()):
        self.device = resolve_device(device)
        self.mesh = make_mesh(n_devices, device=self.device)
        self.cfg = merge_cfg(TRAINER_DEFAULTS, cfg)
        self.name = self.cfg["name"]
        self.model_dir = os.path.join(self.cfg["model_dir"], self.name)
        self.ckpt_path = os.path.join(self.model_dir, "model.ckpt")
        self.best_ckpt_path = os.path.join(self.model_dir, "model_best.ckpt")
        self.keep = sorted({int(k) for k in keep})
        off = [k for k in self.keep if k % self.chunk_steps]
        if off:
            raise ValueError(f"keep steps {off} end no chunk of {self.chunk_steps} steps")
        if self.writes:
            os.makedirs(self.model_dir, exist_ok=True)
            self.logger = Logger(self.model_dir)
        else:
            self.logger = NullLogger()

        self._build_network()
        self._build_dataset()
        self._build_optimizer()

    # ------------------------------------------------------------------
    def _build_network(self):
        from nunerf_tpu_torch.models import build_renderer
        from nunerf_tpu_torch.models.stage2 import tree_keys
        from nunerf_tpu_torch.models.stage1 import PARAM_KEYS

        self.renderer = build_renderer(self.cfg, device=self.device,
                                       seed=self.cfg["random_seed"])
        self.tree_top = (tree_keys() if self.cfg.get("network", "shape") == "stage2"
                         else PARAM_KEYS)
        for key in ("train_ray_num", "test_ray_num"):
            if self.renderer.cfg[key] % self.mesh.size:
                raise ValueError(f"{key} = {self.renderer.cfg[key]} does not divide "
                                 f"over {self.mesh.size} ranks")
        self.renderer.mesh = self.mesh
        replicate(self.renderer, self.mesh)

    def _build_dataset(self):
        from nunerf_tpu_torch.data.database import (get_database_split,
                                                    parse_database_name)
        from nunerf_tpu_torch.data.device_rays import build_compact_store, num_rays
        from nunerf_tpu_torch.data.ray_store import (build_imgs_info,
                                                     construct_nerf_ray_batch,
                                                     construct_ray_batch)

        cfg = self.renderer.cfg
        self.database = parse_database_name(cfg["database_name"], cfg["dataset_dir"])
        # cfg split_type 'test' trains on the eval holdout's complement
        self.train_ids, self.test_ids = get_database_split(
            self.database, cfg.get("split_type", "validation"))
        train_info = build_imgs_info(self.database, self.train_ids, with_mask=True)
        h, w = train_info["imgs"].shape[1:3]
        if cfg.get("device_ray_synthesis", True):
            self.store = build_compact_store(train_info, cfg["is_nerf"],
                                             cfg.get("fixed_camera", False),
                                             device=self.device)
            self.num_rays = num_rays(self.store)
            self.compact = True
        else:
            if cfg["is_nerf"]:
                store, h, w = construct_nerf_ray_batch(train_info)
            else:
                store, h, w = construct_ray_batch(train_info, cfg.get("fixed_camera", False))
            self.store = {k: torch.as_tensor(np.ascontiguousarray(v), device=self.device)
                          for k, v in store.items()}
            self.num_rays = self.store["rays_o"].shape[0]
            self.compact = False
        del train_info  # the f32 images: 768 MB at 100 views of 800x800
        self.train_hw = (h, w)
        self.val_info = build_imgs_info(self.database, self.test_ids, with_mask=True)
        self.index_generator = torch.Generator(device=self.device).manual_seed(
            self.cfg["random_seed"] + 1)

    def _build_optimizer(self):
        from nunerf_tpu_torch.train.lr import warm_up_cos_host

        lr_cfg = dict(self.cfg.get("lr_cfg") or {})
        lr_cfg.setdefault("end_iter", 300000)
        # one schedule for the update and the log, in float32 as the JAX
        # package's optax schedule evaluates it
        self.schedule = warm_up_cos_host(
            lr=lr_cfg.get("lr", 5e-4), end_warm=lr_cfg.get("end_warm", 5000),
            end_iter=lr_cfg["end_iter"])
        self.train = TrainStep(self.renderer, self.schedule)

    @property
    def writes(self) -> bool:
        """Whether this process writes checkpoints, logs and images: rank 0."""
        return self.mesh.rank == 0

    # ------------------------------------------------------------------
    def sample_indices(self, step: int) -> torch.Tensor:
        """The flat ray indices of ``step``'s global batch: int64
        [train_ray_num] on the device, the same on every rank.  Replace it
        (an attribute of the instance) to pass the indices in."""
        return torch.randint(0, self.num_rays, (self.renderer.cfg["train_ray_num"],),
                             generator=self.index_generator, device=self.device)

    def batch(self, idx: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The training batch of flat ray indices ``idx``."""
        if self.compact:
            from nunerf_tpu_torch.data.device_rays import sample_rays
            return sample_rays(self.store, idx)
        idx = idx.to(self.device)
        return {k: v[idx] for k, v in self.store.items()}

    def train_step(self, step: int) -> Dict[str, torch.Tensor]:
        """One optimizer step at ``step`` on this rank's rows of the global
        batch; the detached loss terms (global), on the device."""
        idx = self.sample_indices(step)
        idx = idx[self.mesh.rows(idx.shape[0] // self.mesh.size)]
        return self.train(self.batch(idx), step)

    # ------------------------------------------------------------------
    def params_tree(self):
        from nunerf_tpu_torch.convert import to_jax_tree
        return to_jax_tree(self.renderer, self.tree_top)

    def opt_state_tree(self):
        """Adam's moments of the trainable parameters by their JAX paths,
        and the update count."""
        from nunerf_tpu_torch.convert import named_to_jax_tree

        state = self.train.optimizer.state
        names = {p: n for n, p in self.renderer.named_parameters()}
        out = {"count": self.train.n_updates}
        for key in ("exp_avg", "exp_avg_sq"):
            named = {names[p]: (state[p][key].detach().cpu().numpy().copy() if p in state
                                else np.zeros(tuple(p.shape), np.float32))
                     for p in self.train.params}
            out[key] = named_to_jax_tree(named, self.tree_top)
        return out

    def rng_state(self):
        """The trainer's draws as they stand: the ray index generator's
        state and the renderer's (stage 1's sampler jitter and occlusion
        priorities), as uint8 arrays, with the device type they belong to."""
        out = {"device": self.device.type,
               "index": self.index_generator.get_state().numpy().copy()}
        gen = getattr(self.renderer, "generator", None)
        if gen is not None:
            out["renderer"] = gen.get_state().numpy().copy()
        return out

    def set_rng_state(self, rng, path):
        """Restore ``rng_state``'s draws; a checkpoint without them (older,
        or the JAX package's), or of another kind of device, leaves the
        draws at their seeds, and the trainer says so."""
        if rng is None or rng["device"] != self.device.type:
            if self.writes and self.train.n_updates:
                print(f"{path}: no {self.device.type} draws in the checkpoint; the ray "
                      f"indices and the sampler's draws start again from their seeds")
            return
        self.index_generator.set_state(torch.as_tensor(rng["index"]))
        if "renderer" in rng:
            self.renderer.generator.set_state(torch.as_tensor(rng["renderer"]))

    def save(self, path: str, step: int, best_para: float):
        """Write a checkpoint (rank 0 only)."""
        if self.writes:
            save_checkpoint(path, step, self.params_tree(), self.opt_state_tree(),
                            best_para, self.rng_state())

    def kept_path(self, step: int) -> str:
        return os.path.join(self.model_dir, f"model_{int(step)}.ckpt.gz")

    def read_checkpoint(self, path: str):
        """``load_checkpoint(path)`` and the checkpoint's draws (None where
        it has none) as rank 0 reads them, on every rank: no other rank
        opens the file, so ``model_dir`` need not be shared.  A read that
        fails on rank 0 raises on every rank."""
        sent = None
        if self.writes:
            try:
                blob = _read_blob(path)
                sent = _unpack(blob) + (blob.get("rng"),)
            except Exception as e:
                self.mesh.from_rank0(f"rank 0 could not read {path}: {e!r}")
                raise
        got = self.mesh.from_rank0(sent)
        if isinstance(got, str):
            raise RuntimeError(got)
        return got

    def load(self, path: str):
        """Restore the parameters and Adam from a checkpoint of either
        package; (step, best_para).  Rank 0 reads the file and sends every
        rank its contents (parameters, Adam's moments and count), so the
        ranks go on bit-equal.  The draws too, where the checkpoint holds
        them (``set_rng_state``)."""
        from nunerf_tpu_torch.convert import load_jax_params

        step, params, opt_state, best, rng = self.read_checkpoint(path)
        load_jax_params(self.renderer, params, self.tree_top)
        self.train.optimizer.state.clear()
        if opt_state is None:
            self.train.n_updates = int(step)
            if self.writes:
                print(f"{path}: a JAX checkpoint; its optimizer state (flax msgpack) "
                  f"cannot be read, so Adam starts afresh at step {step}")
            return step, best
        self.train.load_state(opt_state, self.tree_top)
        self.set_rng_state(rng, path)
        return step, best

    def _load_if_exists(self):
        # rank 0's file decides for every rank
        if self.mesh.from_rank0(os.path.exists(self.ckpt_path)):
            step, best = self.load(self.ckpt_path)
            if self.writes:
                print(f"resumed from {self.ckpt_path} at step {step}")
            return step, best
        return 0, 0.0

    @property
    def chunk_steps(self) -> int:
        """The JAX trainer's chunk, a jitted lax.scan there; here the span
        of eager steps whose loss terms are summed on the device between
        two host reads, with the same interval arithmetic."""
        cfg = self.cfg
        return max(1, min(cfg.get("scan_chunk", 25), cfg["train_log_step"],
                          cfg["save_interval"], cfg["val_interval"]))

    def run(self):
        """Train from the last checkpoint (or step 0) to ``total_step``;
        returns the best validation PSNR."""
        from nunerf_tpu_torch.utils.debug import (check_finite_tree,
                                                  debug_nan_enabled,
                                                  maybe_enable_debug_nans)
        maybe_enable_debug_nans()
        cfg = self.cfg
        start_step, best_para = self._load_if_exists()
        t0 = time.time()
        t0_step = start_step

        chunk = self.chunk_steps
        step = start_step
        while step < cfg["total_step"]:
            n = min(chunk, cfg["total_step"] - step)
            keys, acc = None, None
            for i in range(n):
                terms = self.train_step(step + i)
                if keys is None:
                    keys = list(terms)
                vals = torch.stack([torch.as_tensor(terms[k], dtype=torch.float32,
                                                    device=self.device) for k in keys])
                acc = vals if acc is None else acc + vals
            step += n

            if step % cfg["train_log_step"] < chunk:
                means = (acc / n).tolist()  # the one host read of the chunk
                scalars = dict(zip(keys, means))
                if debug_nan_enabled():
                    check_finite_tree(scalars, "loss_terms")
                scalars["lr"] = self.schedule(step)
                now = time.time()
                # the loop's wall time a step since the last log; 0 at the
                # first log, which holds the first step's warm-up
                timed = step > start_step + n
                scalars["rays_per_sec"] = (
                    (step - t0_step) * self.renderer.cfg["train_ray_num"]
                    / max(now - t0, 1e-6)) if timed else 0.0
                scalars["step_ms"] = (now - t0) / (step - t0_step) * 1e3 if timed else 0.0
                t0, t0_step = now, step
                self.logger.log(scalars, step)

            if step % cfg["val_interval"] < chunk and step > start_step:
                key_metric = self.validate(step)
                if key_metric >= best_para:
                    best_para = key_metric
                    self.save(self.best_ckpt_path, step, best_para)
            if step % cfg["save_interval"] < chunk:
                self.save(self.ckpt_path, step, best_para)
            if step in self.keep and self.writes:
                save_checkpoint(self.kept_path(step), step, self.params_tree(), None,
                                best_para)

        self.save(self.ckpt_path, cfg["total_step"], best_para)
        # no rank leaves before rank 0's last checkpoint is on disk: a run
        # that follows resumes from it
        self.mesh.barrier()
        return best_para

    # ------------------------------------------------------------------
    def _downsampled(self, info):
        from nunerf_tpu_torch.data.image_io import resize

        ratio = self.renderer.cfg.get("downsample_ratio", 1.0)
        if not self.renderer.cfg.get("test_downsample_ratio", True) or ratio == 1.0:
            return info
        h, w = info["imgs"].shape[1:3]
        dh, dw = int(h * ratio), int(w * ratio)
        K_scale = np.diag([dw / w, dh / h, 1]).astype(np.float32)
        out = {**info,
               "imgs": np.stack([resize(im, (dw, dh), "linear") for im in info["imgs"]]),
               "Ks": np.stack([K_scale @ K for K in info["Ks"]])}
        if "masks" in info:
            out["masks"] = np.stack([resize(m, (dw, dh), "nearest") for m in info["masks"]])
        return out

    @torch.no_grad()
    def render_image(self, info, step: int):
        """Chunked full-image render of one view's imgs_info, chunks of
        ``test_ray_num`` rays (the last padded with copies of its last ray),
        each split over the mesh's ranks and gathered on every rank.

        Returns (outputs dict incl. gt_rgb, h, w): numpy, on the host.
        Shared by per-step validation and the test-split evaluator
        (train/train_valid.py:19-53, dataset/database.py:667-679)."""
        from nunerf_tpu_torch.data.ray_store import (construct_nerf_ray_batch,
                                                     construct_ray_batch)

        cfg = self.renderer.cfg
        info = self._downsampled(dict(info))
        if cfg["is_nerf"]:
            batch, h, w = construct_nerf_ray_batch(info)
        else:
            batch, h, w = construct_ray_batch(info, cfg.get("fixed_camera", False))

        trn = cfg["test_ray_num"]
        n_local = trn // self.mesh.size
        rows = self.mesh.rows(n_local)
        rn = batch["rays_o"].shape[0]
        dev_batch = {k: torch.as_tensor(np.ascontiguousarray(v), device=self.device)
                     for k, v in batch.items()}
        chunks = []
        for i0 in range(0, rn, trn):
            cur = {}
            for k, v in dev_batch.items():
                sl = v[i0:i0 + trn]
                if sl.shape[0] < trn:  # fixed shapes: pad with the last ray
                    sl = torch.cat([sl, sl[-1:].expand(trn - sl.shape[0], *sl.shape[1:])])
                cur[k] = sl[rows]
            out = self.renderer.test_outputs(cur, step)
            out = gather_outputs({k: v.detach().float() for k, v in out.items()
                                  if torch.is_tensor(v)}, n_local, self.mesh)
            chunks.append({k: np.atleast_1d(v.cpu().numpy()) for k, v in out.items()})

        outputs = {k: np.concatenate([c[k] for c in chunks], 0)[:rn] for k in chunks[0]}
        outputs["gt_rgb"] = batch["rgbs"]
        return outputs, h, w

    def validate(self, step: int) -> float:
        """Per-step validation on one held-out view (the reference's
        validation split holds out a single image, database.py:667-674)."""
        from nunerf_tpu_torch.train.metrics import (compute_psnr, compute_ssim,
                                                    dump_validation_images)

        info = {k: v[:1] for k, v in self.val_info.items()}
        outputs, h, w = self.render_image(info, step)
        gt, pr = outputs["gt_rgb"], outputs["ray_rgb"]
        if "tir_mask" in outputs:
            # stage-2 scores TIR-masked pixels out of both images
            # (reference test_step, renderer_zerothick.py:1248-1250)
            tm = outputs["tir_mask"].reshape(-1, 1)
            gt, pr = gt * tm, pr * tm
        psnr = compute_psnr(gt, pr)
        ssim = compute_ssim(gt.reshape(h, w, 3), pr.reshape(h, w, 3))
        self.logger.log({"psnr": psnr, "ssim": ssim}, step, prefix="val")
        if not self.writes:
            return psnr
        try:
            dump_validation_images(outputs, h, w,
                                   os.path.join("data", "train_vis", self.name),
                                   self.name, step, 0)
        except (OSError, ValueError, KeyError) as e:  # vis must not kill training
            print(f"validation dump failed: {e}")
        print(f"[val] step {step} psnr {psnr:.3f} ssim {ssim:.4f}")
        return psnr
