"""Helpers over nested-dict param trees (the subset of `repro.utils.pytree`
the port needs). As in JAX, a `None` is an empty subtree: `tree_map`
passes it through and `tree_leaves` skips it (sgd without momentum keeps
`"mu": None` in its state)."""
from __future__ import annotations

from typing import Any, Callable, List

import torch


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Map `fn` over the leaves of nested dicts (the params layout); with
    several trees of the same structure, `fn` takes one leaf of each."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves in `tree_map`'s order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_stack(trees: List[Any]) -> Any:
    """Stack same-structured trees leaf-wise on a new leading axis."""
    if isinstance(trees[0], dict):
        return {k: tree_stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def tree_global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree)))
