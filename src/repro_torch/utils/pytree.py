"""Helpers over nested-dict param trees (the subset of `repro.utils.pytree`
the port needs)."""
from __future__ import annotations

from typing import Any, Callable, List

import torch


def tree_map(fn: Callable, tree: Any) -> Any:
    """Map `fn` over the leaves of nested dicts (the params layout)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_stack(trees: List[Any]) -> Any:
    """Stack same-structured trees leaf-wise on a new leading axis."""
    if isinstance(trees[0], dict):
        return {k: tree_stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)
