"""Multi-process start-up and the batch helpers around it; counterpart of
``nunerf_tpu/parallel/multihost.py``.

Data-parallel training here means: every process calls ``init_multihost()``
at start (``torchrun`` sets its environment), builds the mesh
(``make_mesh``) and draws the same global ray batch from the same seed,
keeping its contiguous rows (``host_local_batch``); no ray data crosses
between processes.  Gradients are averaged in one flat all-reduce a step
(``train/trainer.py`` ``TrainStep``).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from nunerf_tpu_torch.parallel.mesh import Mesh, gather_rows, make_mesh


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def launched_by_torchrun() -> bool:
    """True when ``torchrun`` (or another launcher) set this process's rank
    and world size."""
    return _env_int("RANK") is not None and _env_int("WORLD_SIZE") is not None


def local_device(device="cuda") -> torch.device:
    """This process's device: ``cuda:LOCAL_RANK`` for a CUDA run started by
    ``torchrun``, else ``device`` as given."""
    dev = torch.device(device)
    local = _env_int("LOCAL_RANK")
    if dev.type == "cuda" and dev.index is None and local is not None:
        return torch.device("cuda", local)
    return dev


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   backend: Optional[str] = None) -> None:
    """Join the process group; a no-op for one process.

    Unset arguments come from ``torchrun``'s environment (``WORLD_SIZE``,
    ``RANK``, ``MASTER_ADDR``/``MASTER_PORT``).  ``coordinator_address`` is
    ``host:port`` or an ``init_method`` URL (``tcp://``, ``file://``).
    ``backend`` defaults to ``nccl`` where CUDA is available and ``gloo``
    otherwise; ``gloo`` may be asked for on CUDA (two ranks sharing one card:
    ``nccl`` refuses two ranks on one device).  Under ``nccl`` the process is
    bound to ``cuda:LOCAL_RANK`` (else ``cuda:process_id``) before anything
    touches the card.  A failed initialisation raises: nothing falls back to
    another backend or to one process."""
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE")
    if num_processes is None or num_processes <= 1:
        return
    if process_id is None:
        process_id = _env_int("RANK")
    if process_id is None:
        raise ValueError("init_multihost: process_id (or RANK) is needed for "
                         f"{num_processes} processes")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        local = _env_int("LOCAL_RANK")
        torch.cuda.set_device(process_id if local is None else local)
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id)


def host_local_batch(global_batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """This process's contiguous rows of a batch every process holds whole:
    ``global_rn / world_size`` rays each (the whole batch for one process)."""
    if not (dist.is_available() and dist.is_initialized()):
        return dict(global_batch)
    n, idx = dist.get_world_size(), dist.get_rank()
    out = {}
    for k, v in global_batch.items():
        per = v.shape[0] // n
        out[k] = v[idx * per:(idx + 1) * per]
    return out


def global_sharded_batch(local_batch: Dict,
                         mesh: Optional[Mesh] = None) -> Dict[str, torch.Tensor]:
    """Every process's rows gathered into the global arrays, on every rank
    and on the mesh's device (through the host under ``gloo``)."""
    mesh = make_mesh() if mesh is None else mesh
    return {k: gather_rows(torch.as_tensor(v, device=mesh.device), mesh)
            for k, v in local_batch.items()}
