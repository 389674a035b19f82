"""Data parallelism on ``torch.distributed``: rays sharded over the ranks,
parameters replicated, the loss global (counterpart of
``nunerf_tpu/parallel/``)."""
from nunerf_tpu_torch.parallel.mesh import make_mesh, replicate, shard_batch
