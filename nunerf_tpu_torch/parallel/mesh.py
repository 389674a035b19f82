"""The data-parallel mesh on ``torch.distributed``; counterpart of
``nunerf_tpu/parallel/mesh.py``.

The scaling axis of this workload is rays: they are embarrassingly
parallel, so the mesh is one ``data`` axis of processes, one device each.
Every rank holds the same parameters and its contiguous share of each ray
batch.  Where the JAX step is one global program whose reductions XLA makes
global, this port says so itself: every reduction over rays reads through
``global_sum`` (``global_mean``, ``masked_mean`` of the models), and the
trainer all-reduces the gradients in one flat buffer a step.

Which reductions pair.  Every rank computes the same loss ``L`` from the
same global sums ``S = sum_r s_r``.  ``global_sum``'s backward all-reduces
its upstream gradient, so each rank sends ``N dL/dS`` into its own partial
sum ``s_r``: its local gradient is ``N`` times its share.  The trainer
therefore *averages* the ranks' gradients (``average_``): ``(1/N) sum_r N
dL/dS ds_r/dtheta`` is the gradient of ``L``, and a term that reads only
replicated values (a parameter, a step gate) keeps its gradient too, where
an identity backward summed over the ranks would count it ``N`` times.

JAX's ``batch_sharding`` and ``replicated`` name shardings for
``jax.device_put``.  A process of this port holds only its own rows, so
there is nothing to name: ``shard_batch`` and ``replicate`` do the work.

One process is the mesh with no process group (``one_process_mesh``, the
renderers' default): ``global_sum`` is the identity, ``gather_rows`` returns
its input, the draws are the local ones, and no collective runs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.distributed as dist


@dataclass
class Mesh:
    """One ``data`` axis: the process group (``None``: one process, no
    collectives), this process's rank in it, the world size and this rank's
    device."""

    group: Optional[object]
    rank: int
    size: int
    device: torch.device
    axis: str = "data"

    @property
    def distributed(self) -> bool:
        """True where collectives run: the mesh has a process group."""
        return self.group is not None

    @property
    def host_collectives(self) -> bool:
        """gloo takes CUDA tensors in ``broadcast`` and ``all_reduce`` only:
        every other collective of a CUDA tensor goes through the host."""
        return self.distributed and dist.get_backend(self.group) == "gloo"

    def rows(self, n: int) -> slice:
        """This rank's contiguous share of ``n * size`` global rows."""
        return slice(self.rank * n, (self.rank + 1) * n)

    def all_reduce_(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over the ranks, in place."""
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group)
        return x

    def barrier(self):
        """Wait for every rank (a no-op for one process)."""
        if self.distributed:
            dist.barrier(group=self.group)

    def average_(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' mean of ``x``, in place: the reduction of the gradients
        that pairs with ``global_sum``'s backward (module docstring)."""
        return self.all_reduce_(x).div_(self.size)

    def from_rank0(self, obj):
        """Rank 0's ``obj`` (any picklable value) on every rank; ``obj`` as it
        is for one process.  Rank 0 decides what only its files can tell (a
        checkpoint's presence and contents): the other ranks need not see
        them."""
        if not self.distributed:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self.group)
        return box[0]


def one_process_mesh(device="cpu", axis: str = "data") -> Mesh:
    """The mesh of one process: no group, no collectives."""
    return Mesh(None, 0, 1, torch.device(device), axis)


def make_mesh(n_devices: Optional[int] = None, axis: str = "data",
              device=None) -> Mesh:
    """The mesh of the initialised default process group, one device a rank;
    the one-process mesh where no group is initialised.  ``n_devices``, if
    given, must be the group's world size (one process drives one device).
    ``device`` is this rank's device: by default the current CUDA device
    under ``nccl`` and the CPU otherwise."""
    if dist.is_available() and dist.is_initialized():
        size, rank, group = dist.get_world_size(), dist.get_rank(), dist.group.WORLD
    else:
        size, rank, group = 1, 0, None
    if n_devices is not None and n_devices != size:
        raise ValueError(
            f"n_devices={n_devices}, but {size} process(es) run: one process drives "
            "one device, so start n_devices processes (torchrun --nproc_per_node)")
    if group is None:
        return one_process_mesh("cpu" if device is None else device, axis)
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend(group) == "nccl" else torch.device("cpu"))
    return Mesh(group, rank, size, torch.device(device), axis)


def shard_batch(batch: Dict, mesh: Mesh) -> Dict:
    """This rank's contiguous rows of every batch array, on the mesh's
    device.  An array whose leading dimension does not divide by the world
    size is kept whole (replicated), as the JAX function does."""
    n = mesh.size
    out = {}
    for k, v in batch.items():
        v = torch.as_tensor(v, device=mesh.device)
        if v.ndim >= 1 and v.shape[0] % n == 0:
            v = v[mesh.rows(v.shape[0] // n)]
        out[k] = v
    return out


def _flat(tensors):
    return torch.cat([t.detach().reshape(-1) for t in tensors])


def replicate(module_or_tensors, mesh: Mesh):
    """Broadcast rank 0's values to every rank, in place, in one flat buffer:
    an ``nn.Module``'s parameters, or a list of tensors of one dtype.
    Returns its argument."""
    if not mesh.distributed:
        return module_or_tensors
    tensors = (list(module_or_tensors.parameters())
               if isinstance(module_or_tensors, torch.nn.Module)
               else list(module_or_tensors))
    if not tensors:
        return module_or_tensors
    flat = _flat(tensors)
    dist.broadcast(flat, src=0, group=mesh.group)
    with torch.no_grad():
        i = 0
        for t in tensors:
            t.copy_(flat[i:i + t.numel()].view_as(t))
            i += t.numel()
    return module_or_tensors


class _GlobalSum(torch.autograd.Function):
    """Sum over the ranks forward; all-reduce of the upstream gradient
    backward, which gives each rank ``N`` times its share (module
    docstring)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce_(g.clone()), None


def global_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` summed over the ranks, differentiably; the identity, with no
    collective, for one process."""
    if not mesh.distributed:
        return x
    return _GlobalSum.apply(x, mesh)


def global_mean(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The mean of ``x`` over the global batch, each rank holding an equal
    share: the ranks' mean of their ``torch.mean`` (for one process the very
    value of ``torch.mean``: the sum of one, divided by 1)."""
    return global_sum(torch.mean(x), mesh) / mesh.size


def gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes), concatenated in rank order along the
    first dimension, on every rank; not differentiable.  Under gloo a CUDA
    tensor goes through the host; ``bool`` travels as ``uint8``."""
    if not mesh.distributed:
        return x
    src = x.to(torch.uint8) if x.dtype == torch.bool else x
    if mesh.host_collectives:
        src = src.cpu()
    src = src.contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    out = torch.cat(parts).to(x.device)
    return out.bool() if x.dtype == torch.bool else out


def rand_rows(shape, mesh: Mesh, generator=None, device=None) -> torch.Tensor:
    """``torch.rand(shape)`` for this rank's rows of the global batch: every
    rank draws the global shape (``shape[0] * size`` rows) from the same
    seeded ``generator`` and keeps its own rows, so a sharded step draws what
    the one-process step draws."""
    shape = tuple(shape)
    full = torch.rand((shape[0] * mesh.size,) + shape[1:], generator=generator,
                      device=device)
    return full[mesh.rows(shape[0])]


def gather_outputs(outputs: Dict[str, torch.Tensor], n: int, mesh: Mesh) -> Dict:
    """Every output with ``n`` leading rows (this rank's rays) gathered over
    the ranks in one collective (as float32); the rest, 0-d values already
    reduced over the global batch, as they are."""
    if not mesh.distributed:
        return dict(outputs)
    keys = [k for k, v in outputs.items() if v.ndim >= 1 and v.shape[0] == n]
    if not keys:
        return dict(outputs)
    flat = torch.cat([outputs[k].float().reshape(n, -1) for k in keys], 1)
    full = gather_rows(flat, mesh)
    out = dict(outputs)
    i = 0
    for k in keys:
        w = outputs[k].numel() // n
        out[k] = full[:, i:i + w].reshape((n * mesh.size,) + tuple(outputs[k].shape[1:]))
        i += w
    return out
