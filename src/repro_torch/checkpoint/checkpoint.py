"""Checkpointing: trees -> .npz (params/opt state), league state -> .json;
counterpart of `repro.checkpoint.checkpoint`.

Leaf names are `repro`'s: the dict keys and sequence indices on the way to
the leaf, joined with "/" in `jax.tree_util`'s order (dict keys sorted,
`None` an empty subtree), so an `.npz` written by either package loads in
the other. Tensors on the card are written from one host copy of them all
(`utils/host.py:to_host`); a bf16 leaf is stored as fp32, which holds it
exactly, and `load_pytree` casts every leaf back to its template's dtype.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.utils.host import to_host


def _named_leaves(tree, prefix=()) -> List[Tuple[str, Any]]:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _named_leaves(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in _named_leaves(v, prefix + (str(i),))]
    return [("/".join(prefix), tree)]


def save_pytree(path: str, tree: Any) -> None:
    named = _named_leaves(tree)
    arrays = to_host([x for _, x in named])
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **{name: np.asarray(a) for (name, _), a in zip(named, arrays)})


def load_pytree(path: str, template: Any) -> Any:
    """`template`'s structure with every leaf read from `path`: a tensor on
    the template leaf's device with its dtype (a numpy leaf stays numpy)."""
    with np.load(path) as data:
        loaded: Dict[str, Any] = {}
        for name, leaf in _named_leaves(template):
            arr = data[name]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{name}: saved {arr.shape}, template {tuple(leaf.shape)}")
            if isinstance(leaf, torch.Tensor):
                loaded[name] = torch.from_numpy(arr).to(device=leaf.device, dtype=leaf.dtype)
            else:
                loaded[name] = arr.astype(np.asarray(leaf).dtype)

    def rebuild(tree, prefix=()):
        if tree is None:
            return None
        if isinstance(tree, dict):
            return {k: rebuild(v, prefix + (str(k),)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(rebuild(v, prefix + (str(i),)) for i, v in enumerate(tree))
        return loaded["/".join(prefix)]
    return rebuild(template)


def save_league(path: str, state: dict) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(state, f, indent=1,
                  default=lambda o: o.tolist() if hasattr(o, "tolist") else str(o))


def load_league(path: str) -> dict:
    with open(path) as f:
        return json.load(f)
