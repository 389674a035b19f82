"""Carry weights between the JAX parameter tree and the port's modules.

The JAX tree is nested dicts of arrays, with flax's ``{'params': ...}`` level
under each network.  A port module names its parameters as the JAX leaves
(``v``/``g``/``b`` of a ``WNDense`` with ``v`` kept ``[in, out]``,
``kernel``/``bias`` of a ``Dense``), so a leaf's path is its parameter's
dotted name once the ``params`` levels are dropped.  Two kinds of name differ:

* the heads of the tree.  ``top`` maps a path prefix of the tree to a name
  prefix of the module: a key (``'sdf' -> 'sdf_net'``, the stage-1
  renderer's ``PARAM_KEYS``) or a tuple of keys (``('frozen', 'sdf') ->
  'stage1.sdf_net'``, ``('train', 'iors_vec') -> 'iors_vec'``: the stage-2
  tree is two levels deep, ``models.stage2.tree_keys()``).  A prefix that is
  a whole path names a bare leaf, which has no ``params`` level;
* the shader's human-light head, ``human_light`` in JAX (where the name is
  free) and ``human_light_predictor`` in the port (where ``human_light`` is
  the flag).

``load_jax_checkpoint`` reads a checkpoint written by the JAX trainer.
"""

from __future__ import annotations

import pickle
from typing import Dict, Optional

import numpy as np
import torch

_RENAMES = {"human_light": "human_light_predictor"}
_UNRENAMES = {v: k for k, v in _RENAMES.items()}


def _flatten(tree, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flatten(v, prefix if k == "params" else prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _prefixes(top) -> Dict[tuple, str]:
    return {(k,) if isinstance(k, str) else tuple(k): v for k, v in (top or {}).items()}


def _torch_name(path, prefixes: Dict[tuple, str]):
    if not prefixes:
        return ".".join(_RENAMES.get(p, p) for p in path)
    for n in range(len(path), 0, -1):
        if path[:n] in prefixes:
            parts = [prefixes[path[:n]]] + [_RENAMES.get(p, p) for p in path[n:]]
            return ".".join(parts)
    raise KeyError(f"JAX leaf {'/'.join(path)} is under no known head")


def _jax_path(name: str, prefixes: Dict[tuple, str]):
    """(head path, rest) of a parameter name; the head is () without ``top``."""
    for head, mod in sorted(prefixes.items(), key=lambda kv: -len(kv[1])):
        if name == mod or name.startswith(mod + "."):
            rest = name[len(mod) + 1:]
            return head, tuple(_UNRENAMES.get(p, p) for p in rest.split(".") if p)
    if prefixes:
        raise KeyError(f"parameter {name} is under no known head")
    return (), tuple(_UNRENAMES.get(p, p) for p in name.split("."))


def load_jax_params(module: torch.nn.Module, tree, top: Optional[Dict] = None):
    """Copy every leaf of the JAX ``tree`` into ``module``'s parameters.
    ``top`` maps the tree's heads to name prefixes (see the module
    docstring).  Every parameter must be covered."""
    params = dict(module.named_parameters())
    prefixes = _prefixes(top)
    seen = set()
    for path, arr in _flatten(tree).items():
        name = _torch_name(path, prefixes)
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


def to_jax_tree(module: torch.nn.Module, top: Optional[Dict] = None,
                what: str = "param") -> Dict:
    """The module's parameters (``what='param'``) or gradients
    (``what='grad'``, zeros where none) as a nested dict of numpy arrays in
    the JAX tree's layout, ``params`` levels included."""
    tree: Dict = {}
    prefixes = _prefixes(top)
    for name, p in module.named_parameters():
        t = p if what == "param" else p.grad
        arr = (np.zeros(tuple(p.shape), np.float32) if t is None
               else t.detach().float().cpu().numpy().copy())
        head, rest = _jax_path(name, prefixes)
        if not rest:  # a bare leaf
            head, rest = head[:-1], head[-1:]
        else:
            rest = ("params",) + rest
        node = tree
        for k in head + rest[:-1]:
            node = node.setdefault(k, {})
        node[rest[-1]] = arr
    return tree


def flat_leaves(tree) -> Dict[str, np.ndarray]:
    """``'a/b/c' -> array`` over a JAX-layout tree (``params`` levels
    dropped), for leaf-by-leaf comparisons."""
    return {"/".join(k): v for k, v in _flatten(tree).items()}


def load_jax_checkpoint(path: str):
    """(step, params, best_para) of a checkpoint written by the JAX trainer's
    ``save_checkpoint``: a pickle whose ``params`` is the parameter tree as
    numpy arrays.  The optimizer state (flax msgpack bytes) is ignored.
    Unpickling runs code: read only checkpoints this project wrote."""
    with open(path, "rb") as f:
        blob = pickle.load(f)
    return blob["step"], blob["params"], blob.get("best_para", 0.0)
