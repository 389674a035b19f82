"""Device selection for the port's entry points: CUDA unless the caller asks
for the CPU, and no silent fallback."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the port on the CPU")
    return dev
