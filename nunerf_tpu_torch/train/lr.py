"""Learning-rate schedules (reference ``train/lr_common_manager.py:22-46``);
counterpart of ``nunerf_tpu/train/lr.py``."""

from __future__ import annotations

import math

import numpy as np


def warm_up_cos_schedule(lr: float = 5e-4, end_warm: int = 5000,
                         end_iter: int = 300000, alpha: float = 0.05):
    """Linear warm-up then cosine decay to ``alpha * lr``: step -> lr."""

    def schedule(step):
        step = float(step)
        if step < end_warm:
            return lr * step / end_warm
        progress = (step - end_warm) / (end_iter - end_warm)
        return lr * ((math.cos(math.pi * progress) + 1.0) * 0.5 * (1 - alpha) + alpha)

    return schedule


def warm_up_cos_host(lr: float = 5e-4, end_warm: int = 5000,
                     end_iter: int = 300000, alpha: float = 0.05):
    """The same schedule evaluated as ``nunerf_tpu/train/lr.py``'s host twin
    evaluates it, in float32 numpy: step -> lr (a Python float).  The trainer
    uses it for both the update and the log."""

    def schedule(step):
        step = np.float32(step)
        warm = step / end_warm
        progress = (step - end_warm) / (end_iter - end_warm)
        cos = (np.cos(np.pi * progress) + 1.0) * 0.5 * (1 - alpha) + alpha
        return float(lr * np.where(step < end_warm, warm, cos))

    return schedule


name2lr_schedule = {"warm_up_cos": warm_up_cos_schedule}
