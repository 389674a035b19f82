"""Carry weights between the JAX parameter tree and the port's modules.

The JAX tree is nested dicts of arrays, with flax's ``{'params': ...}`` level
under each network.  A port module names its parameters as the JAX leaves
(``v``/``g``/``b`` of a ``WNDense`` with ``v`` kept ``[in, out]``,
``kernel``/``bias`` of a ``Dense``), so a leaf's path is its parameter's
dotted name once the ``params`` levels are dropped.  Two names differ:

* the renderer's submodules (``PARAM_KEYS``: JAX ``sdf`` is ``sdf_net``, ...);
* the shader's human-light head, ``human_light`` in JAX (where the name is
  free) and ``human_light_predictor`` in the port (where ``human_light`` is
  the flag).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

_RENAMES = {"human_light": "human_light_predictor"}


def _flatten(tree, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flatten(v, prefix if k == "params" else prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _torch_name(path, top: Optional[Dict[str, str]]):
    parts = list(path)
    if top is not None:
        parts[0] = top[parts[0]]
    return ".".join(_RENAMES.get(p, p) for p in parts)


def _jax_path(name: str, top: Optional[Dict[str, str]]):
    inv = {v: k for k, v in _RENAMES.items()}
    parts = [inv.get(p, p) for p in name.split(".")]
    if top is not None:
        parts[0] = {v: k for k, v in top.items()}[parts[0]]
    return tuple(parts)


def load_jax_params(module: torch.nn.Module, tree, top: Optional[Dict[str, str]] = None):
    """Copy every leaf of the JAX ``tree`` into ``module``'s parameters.
    ``top`` maps the tree's first-level keys to submodule names (the
    renderer's ``PARAM_KEYS``).  Every parameter must be covered."""
    params = dict(module.named_parameters())
    seen = set()
    for path, arr in _flatten(tree).items():
        name = _torch_name(path, top)
        if name not in params:
            raise KeyError(f"JAX leaf {'/'.join(path)} has no parameter {name}")
        p = params[name]
        if tuple(p.shape) != arr.shape:
            raise ValueError(f"{name}: shape {tuple(p.shape)} vs {arr.shape}")
        with torch.no_grad():
            p.copy_(torch.as_tensor(arr, dtype=p.dtype))
        seen.add(name)
    missing = set(params) - seen
    if missing:
        raise KeyError(f"parameters not in the JAX tree: {sorted(missing)}")


def to_jax_tree(module: torch.nn.Module, top: Optional[Dict[str, str]] = None,
                what: str = "param") -> Dict:
    """The module's parameters (``what='param'``) or gradients
    (``what='grad'``, zeros where none) as a nested dict of numpy arrays in
    the JAX tree's layout, ``params`` levels included."""
    tree: Dict = {}
    for name, p in module.named_parameters():
        t = p if what == "param" else p.grad
        arr = (np.zeros(tuple(p.shape), np.float32) if t is None
               else t.detach().float().cpu().numpy().copy())
        path = _jax_path(name, top)
        if top is not None:
            node = tree.setdefault(path[0], {}).setdefault("params", {})
            rest = path[1:]
        else:
            node = tree.setdefault("params", {})
            rest = path
        for k in rest[:-1]:
            node = node.setdefault(k, {})
        node[rest[-1]] = arr
    return tree


def flat_leaves(tree) -> Dict[str, np.ndarray]:
    """``'a/b/c' -> array`` over a JAX-layout tree (``params`` levels
    dropped), for leaf-by-leaf comparisons."""
    return {"/".join(k): v for k, v in _flatten(tree).items()}
