"""Failure detection; counterpart of ``nunerf_tpu/utils/debug.py``.

The reference's approach is NaN tripwires that dump tensors and raise
(renderer.py:1637-1641, 1890-1906).  Here, on ``NUNERF_DEBUG_NAN=1``:

* ``check_finite_tree``: a host-side check of a nested dict of tensors or
  arrays (the trainer runs it on the loss terms at its log steps), raising
  with the offending leaf's path;
* ``maybe_enable_debug_nans``: ``torch.autograd.set_detect_anomaly``, which
  names the forward operation whose backward produced a NaN (the counterpart
  of ``jax_debug_nans``).
"""

from __future__ import annotations

import os

import numpy as np
import torch


def debug_nan_enabled() -> bool:
    return os.environ.get("NUNERF_DEBUG_NAN", "0") == "1"


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def check_finite_tree(tree, name: str = "tree"):
    """Raise FloatingPointError naming the first non-finite leaf."""
    for path, leaf in _leaves(tree):
        arr = (leaf.detach().float().cpu().numpy() if torch.is_tensor(leaf)
               else np.asarray(leaf))
        if not np.all(np.isfinite(arr)):
            bad = int(np.sum(~np.isfinite(arr)))
            raise FloatingPointError(
                f"non-finite values in {name}{path}: {bad}/{arr.size} bad, "
                f"shape {arr.shape}")


def maybe_enable_debug_nans():
    if debug_nan_enabled():
        torch.autograd.set_detect_anomaly(True)
