"""Learning-rate schedules (reference ``train/lr_common_manager.py:22-46``);
counterpart of ``nunerf_tpu/train/lr.py``."""

from __future__ import annotations

import math


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


name2lr_schedule = {"warm_up_cos": warm_up_cos_schedule}
