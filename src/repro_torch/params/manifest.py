"""Versioned, content-addressed parameter manifests (the param plane);
counterpart of `repro.params.manifest`.

Every tree the ModelPool hosts gets a `ParamManifest`: a monotonic per-key
version plus one content hash per leaf (blake2b over dtype, shape and raw
bytes), minted by the pool and shipped to every consumer. It makes the
cheap synchronisations possible: `NotModified` tags, changed-leaf deltas,
cross-key hash references, and hash-gated InfServer hot-swaps.

Leaves are addressed by their `jax.tree_util.keystr`-form path
(`utils.pytree.tree_flatten_with_path`), and a leaf hashes to the same
digest as in `repro` for the same values: the numpy dtype string (`'<f4'`;
`'<V2'` for bfloat16, as ml_dtypes names it), `repr` of the shape as a
tuple (a 0-d leaf as `(1,)`, which is what `np.ascontiguousarray` makes of
it in `repro`), then the bytes. So manifests minted by either package diff
against each other. (`repro`'s own `leaf_hash` raises on a bf16 leaf,
whose dtype the buffer protocol refuses; the port hashes its bytes under
the same recipe.)

Tensors on the card are hashed from one batched device-to-host copy of all
of them into a pinned buffer: the pool mints under its global lock, and a
`.cpu()` per leaf would wait once per leaf for the train step still queued
on the device.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.utils.host import host_bytes
from repro_torch.utils.pytree import tree_flatten_with_path, tree_unflatten

_BF16 = "<V2"          # ml_dtypes' bfloat16 dtype string


def _dtype_str(dtype: torch.dtype) -> str:
    if dtype == torch.bfloat16:
        return _BF16
    return torch.empty(0, dtype=dtype).numpy().dtype.str


def _host_bytes(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor's raw bytes as a flat uint8 array (no copy when it is
    contiguous; bf16 read through a 16-bit view)."""
    t = t.detach().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().reshape(-1).view(np.uint8)


def _digest(dtype_str: str, shape: Tuple[int, ...], data) -> str:
    h = hashlib.blake2b(digest_size=16)
    h.update(dtype_str.encode())
    h.update(repr(tuple(shape) or (1,)).encode())
    h.update(data)
    return h.hexdigest()


def leaf_hash(x) -> str:
    """Content hash of one array leaf: dtype + shape + raw bytes. A CUDA
    tensor is copied to the host first; a CPU tensor or numpy array is
    hashed through the buffer protocol, without a byte copy."""
    if isinstance(x, torch.Tensor):
        return _digest(_dtype_str(x.dtype), tuple(x.shape), _host_bytes(x.cpu()))
    a = np.ascontiguousarray(np.asarray(x))
    return _digest(a.dtype.str, a.shape, a.reshape(-1).view(np.uint8))


def _leaf_hashes(leaves: List[Tuple[str, Any]]) -> Dict[str, str]:
    """`{path: leaf_hash}`, with every CUDA leaf brought over in one copy."""
    dev = [(p, x) for p, x in leaves if isinstance(x, torch.Tensor) and x.is_cuda]
    host: Dict[str, Any] = {}
    if dev:
        for (p, x), raw in zip(dev, host_bytes([x for _, x in dev])):
            host[p] = _digest(_dtype_str(x.dtype), tuple(x.shape), raw)
    return {p: host[p] if p in host else leaf_hash(x) for p, x in leaves}


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return int(np.asarray(x).nbytes)


def flatten_with_paths(tree) -> List[Tuple[str, Any]]:
    """(keystr-path, leaf) pairs in canonical flatten order."""
    return tree_flatten_with_path(tree)[0]


@dataclasses.dataclass(frozen=True)
class ParamManifest:
    """The version identity of one hosted tree: per-leaf content hashes
    keyed by leaf path, a whole-tree hash over them, and the pool's
    monotonic per-key version counter."""
    version: int
    leaf_hashes: Dict[str, str]
    tree_hash: str
    nbytes: int

    def changed_paths(self, old: "ParamManifest") -> Optional[List[str]]:
        """Leaf paths whose hash differs from `old`. None means the leaf
        SET itself changed (a reshaped/renamed tree): no delta exists and
        the consumer needs a full pull."""
        if set(self.leaf_hashes) != set(old.leaf_hashes):
            return None
        return [p for p, h in self.leaf_hashes.items()
                if old.leaf_hashes[p] != h]

    def __eq__(self, other):
        return (isinstance(other, ParamManifest)
                and self.version == other.version
                and self.tree_hash == other.tree_hash)

    def __hash__(self):
        return hash((self.version, self.tree_hash))


def build_manifest(params, version: int) -> ParamManifest:
    leaves = flatten_with_paths(params)
    hashes = _leaf_hashes(leaves)
    nbytes = int(sum(_nbytes(x) for _, x in leaves))
    top = hashlib.blake2b(digest_size=16)
    for p in sorted(hashes):
        top.update(p.encode())
        top.update(hashes[p].encode())
    return ParamManifest(version=version, leaf_hashes=hashes,
                         tree_hash=top.hexdigest(), nbytes=nbytes)


@dataclasses.dataclass(frozen=True)
class NotModified:
    """`pull_if_changed` answer when the caller's version is current:
    nothing crosses the seam but this tag."""
    version: int


@dataclasses.dataclass
class ParamDelta:
    """`pull_if_changed` answer when the caller is stale. `full=True`
    carries the whole tree in `params` (caller's version unknown to the
    server, or the leaf set changed); otherwise `leaves` maps the changed
    leaf paths to their new arrays and the caller grafts them onto its
    cached copy with `apply_delta`.

    `by_hash` is the cross-key content-addressing channel: leaf paths whose
    content the caller advertised it already holds (under ANY key) map to
    their content hash instead of shipping bytes; the caller resolves them
    from its own hash store."""
    manifest: ParamManifest
    full: bool
    params: Any = None
    leaves: Optional[Dict[str, Any]] = None
    by_hash: Optional[Dict[str, str]] = None


def apply_delta(base, leaves: Dict[str, Any]):
    """Graft `leaves` (path -> new array) onto `base` FUNCTIONALLY: the
    returned tree shares every unchanged leaf with `base`, and `base`
    itself is never mutated."""
    flat, treedef = tree_flatten_with_path(base)
    out, seen = [], set()
    for p, leaf in flat:
        if p in leaves:
            out.append(leaves[p])
            seen.add(p)
        else:
            out.append(leaf)
    missing = set(leaves) - seen
    if missing:
        raise KeyError(f"delta carries leaves absent from the base pytree: "
                       f"{sorted(missing)[:3]}...")
    return tree_unflatten(treedef, out)
