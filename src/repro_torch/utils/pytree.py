"""Helpers over param and trajectory trees; counterpart of `repro.utils.pytree`.

Trees are nested dicts, lists and tuples of tensors (or numpy arrays). As in
JAX, a `None` is an empty subtree: `tree_map` passes it through and
`tree_leaves` skips it (sgd without momentum keeps `"mu": None` in its
state).

Two orders exist, on purpose:

* `tree_map`/`tree_leaves` walk dicts in insertion order, so a map keeps
  the layout the params were built with;
* `tree_flatten_with_path`/`tree_unflatten` reproduce `jax.tree_util`: dict
  keys sorted, paths in `jax.tree_util.keystr`'s form (`"['blocks']['wq']"`,
  `"[0]"` for a list or tuple entry). The DataServer's ring layout and the
  param manifests' leaf paths depend on this order, so a manifest minted
  here has the same paths and hashes as one minted by `repro`.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import numpy as np
import torch

_SEQ = (list, tuple)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Map `fn` over the leaves of nested dicts, lists and tuples; with
    several trees of the same structure, `fn` takes one leaf of each."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, _SEQ):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves in `tree_map`'s order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, _SEQ):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_flatten_with_path(tree: Any) -> Tuple[List[Tuple[str, Any]], Any]:
    """`(keystr-path, leaf)` pairs in `jax.tree_util`'s flatten order, and
    the tree's structure (a hashable value; two trees have equal structures
    exactly when JAX's treedefs would compare equal for these containers)."""
    flat: List[Tuple[str, Any]] = []

    def walk(node, path):
        if node is None:
            return None
        if isinstance(node, dict):
            keys = sorted(node)
            return ("dict", tuple(keys),
                    tuple(walk(node[k], f"{path}[{k!r}]") for k in keys))
        if isinstance(node, _SEQ):
            return (type(node).__name__,
                    tuple(walk(v, f"{path}[{i}]") for i, v in enumerate(node)))
        flat.append((path, node))
        return "*"

    return flat, walk(tree, "")


def tree_unflatten(treedef: Any, leaves) -> Any:
    """Inverse of `tree_flatten_with_path`: rebuild the tree from its
    structure and leaves in flatten order (dicts come back key-sorted, as
    `jax.tree_util.tree_unflatten` gives them)."""
    it = iter(leaves)

    def build(d):
        if d is None:
            return None
        if d == "*":
            return next(it)
        if d[0] == "dict":
            return {k: build(c) for k, c in zip(d[1], d[2])}
        return {"list": list, "tuple": tuple}[d[0]](build(c) for c in d[1])

    out = build(treedef)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def tree_stack(trees: List[Any]) -> Any:
    """Stack same-structured trees leaf-wise on a new leading axis."""
    if isinstance(trees[0], dict):
        return {k: tree_stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def tree_global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree)))


def _numel(x) -> int:
    return x.numel() if isinstance(x, torch.Tensor) else int(np.size(x))


def _itemsize(x) -> int:
    return x.element_size() if isinstance(x, torch.Tensor) else np.asarray(x).dtype.itemsize


def tree_count_params(tree) -> int:
    return sum(_numel(x) for x in tree_leaves(tree))


def tree_bytes(tree) -> int:
    return sum(_numel(x) * _itemsize(x) for x in tree_leaves(tree))


def tree_copy(tree):
    """Deep-copy every array leaf (`clone()` for tensors, `.copy()` for
    numpy); immutable leaves pass through. The defensive snapshot used
    wherever a tree crosses an ownership boundary (ModelPool pulls, PBT
    exploits, seed stashes), so no two owners share a buffer."""
    def copy(x):
        if isinstance(x, torch.Tensor):
            return x.detach().clone()
        return x.copy() if hasattr(x, "copy") else x
    return tree_map(copy, tree)


def tree_zeros_like(tree, dtype=None):
    return tree_map(lambda x: torch.zeros_like(x, dtype=dtype or x.dtype), tree)


def tree_cast(tree, dtype):
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, tree)


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_scale(tree, s):
    return tree_map(lambda x: x * s, tree)


def tree_lerp(a, b, t):
    """a + t * (b - a), used for polyak-style parameter mixing."""
    return tree_map(lambda x, y: x + t * (y - x), a, b)
