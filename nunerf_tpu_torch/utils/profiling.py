"""Profiling hooks: ``torch.profiler`` traces and a throughput counter;
counterpart of ``nunerf_tpu/utils/profiling.py``.

``profile_trace`` wraps a region in a ``torch.profiler`` trace of the host
and the card, written as a Chrome trace into ``log_dir``; ``StepTimer``
tracks steady-state rays/s with warm-up exclusion, on the host clock, after
``torch.cuda.synchronize`` on a CUDA device (the step's kernels run
asynchronously, so an unsynchronised clock measures their enqueue).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """Capture a ``torch.profiler`` trace into ``log_dir/trace.json``
    (no-op if None)."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Rays/s over the steps after the first ``warmup`` ticks."""

    def __init__(self, rays_per_step: int, warmup: int = 2, device=None):
        self.rays_per_step = rays_per_step
        self.warmup = warmup
        self.sync = device is not None and torch.device(device).type == "cuda"
        self.count = 0
        self.t0 = self.t1 = None
        self.steps_timed = 0

    def _now(self):
        if self.sync:
            torch.cuda.synchronize()
        return time.perf_counter()

    def tick(self):
        self.count += 1
        if self.count == self.warmup:
            self.t0 = self._now()
            self.steps_timed = 0
        elif self.count > self.warmup:
            self.steps_timed += 1
            self.t1 = self._now()

    @property
    def rays_per_sec(self) -> float:
        if not self.t0 or not self.steps_timed:
            return 0.0
        return self.steps_timed * self.rays_per_step / (self.t1 - self.t0)
