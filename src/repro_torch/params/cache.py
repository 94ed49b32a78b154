"""Version-cached parameter pulls: the consumer side of the param plane;
counterpart of `repro.params.cache`, with the same logic.

`CachedPuller` wraps anything with the ModelPool pull surface — the
in-process `repro_torch.core.ModelPool` or any test double — and turns
every `get` into the cheapest sufficient operation:

* cache current  -> one `NotModified` tag crosses the seam, the cached
  pytree is returned as-is (zero copies, zero bytes of params);
* cache stale    -> only the changed leaves cross, grafted functionally
  onto the cached copy (`apply_delta` never mutates the old object, so
  a copy the caller handed elsewhere — e.g. hosted live by an
  InfServer — is never written through);
* cache empty / pool without `pull_if_changed` -> a plain full pull;
* answer OLDER than the cache (a failover landed on a lagging read
  replica) -> ignored, the cached newer params win (`stale_answers`).

On top of the per-key version cache sits a CROSS-KEY hash store: every
cached leaf is indexed by its content hash, the set of held hashes is
advertised with each `pull_if_changed` (pools that predate the protocol
just ignore the extra keyword, via a TypeError retry), and a delta whose
`by_hash` references held content is resolved locally — so a fresh key
whose content the cache already holds under another key (an exploiter
reset to the seed, a PBT exploit of the leader) costs zero param bytes.
Hash-resolved leaves alias the cache's own arrays (tensors on the card
included: the store maps a hash to the leaf object, never to bytes),
which is exactly the read-only-by-reference contract cached objects
already carry.

The cached object is returned by reference: callers must treat it as
immutable (every producer in this codebase does — the ModelPool replaces
entries, never mutates them). Callers that feed a donating train step
must snapshot first, exactly as they must after a plain `pull`.
"""
from __future__ import annotations

from typing import Any, Dict, Hashable, Optional, Tuple

from repro_torch.params.manifest import (NotModified, ParamManifest,
                                         apply_delta, flatten_with_paths)


class CachedPuller:
    def __init__(self, pool, copy: Optional[bool] = None):
        self._pool = pool
        self._copy = copy
        self._cache: Dict[Hashable, Tuple[ParamManifest, Any]] = {}
        self._hashes: Dict[str, Any] = {}    # content hash -> cached leaf
        self._cross_key_supported = True     # cleared on TypeError retry
        self.stale_answers = 0               # lagging-replica answers ignored

    def get(self, key) -> Any:
        return self.get_with_manifest(key)[0]

    def get_with_manifest(self, key) -> Tuple[Any, Optional[ParamManifest]]:
        """Current params for `key` plus their manifest (None when the
        pool predates the param plane and only `pull` exists)."""
        pull_if_changed = getattr(self._pool, "pull_if_changed", None)
        if pull_if_changed is None:
            return self._pool.pull(key), None
        ent = self._cache.get(key)
        have = ent[0].version if ent is not None else None
        r = None
        if self._hashes and self._cross_key_supported:
            try:
                r = pull_if_changed(key, have, copy=self._copy,
                                    have_hashes=sorted(self._hashes))
            except TypeError:                # legacy pool / test double
                self._cross_key_supported = False
        if r is None:
            r = pull_if_changed(key, have, copy=self._copy)
        if isinstance(r, NotModified):
            return ent[1], ent[0]
        if ent is not None and r.manifest.version < ent[0].version:
            # a LAGGING pool answered (failover landed on a replica that
            # has not caught up): versions are monotonic per key, so the
            # cached entry is strictly newer — keep it, never regress
            self.stale_answers += 1
            return ent[1], ent[0]
        params = self._reconstruct(r, ent)
        if params is None:
            # unresolvable (hash store raced an eviction, or a cross-key
            # delta with no structural scaffold): take the full answer,
            # re-asking WITHOUT have_hashes so it cannot divert again
            r = pull_if_changed(key, None, copy=self._copy)
            params = r.params
        self._cache[key] = (r.manifest, params)
        self._reindex()
        return params, r.manifest

    def _reconstruct(self, r, ent) -> Optional[Any]:
        """Params for a ParamDelta answer; None when it cannot be built
        from local state (caller falls back to a full pull)."""
        if r.full:
            return r.params
        leaves = dict(r.leaves or {})
        for p, h in (getattr(r, "by_hash", None) or {}).items():
            leaf = self._hashes.get(h)
            if leaf is None:
                return None
            leaves[p] = leaf
        if ent is not None:
            return apply_delta(ent[1], leaves)
        # cross-key answer with no same-key base: every leaf must be in
        # hand, grafted onto any cached entry with the same leaf-path
        # set (the structural scaffold — values all come from `leaves`)
        want = set(r.manifest.leaf_hashes)
        if set(leaves) != want:
            return None
        for man2, params2 in self._cache.values():
            if set(man2.leaf_hashes) == want:
                return apply_delta(params2, leaves)
        return None

    def _reindex(self) -> None:
        """Rebuild the content-hash index from live cache entries (old
        versions' leaves drop out here — the store never outgrows the
        cache)."""
        self._hashes = {
            man.leaf_hashes[p]: leaf
            for man, params in self._cache.values()
            for p, leaf in flatten_with_paths(params)
        }

    def manifest(self, key) -> Optional[ParamManifest]:
        """The cached manifest (None if `key` was never pulled)."""
        ent = self._cache.get(key)
        return ent[0] if ent is not None else None

    def drop(self, key) -> None:
        if self._cache.pop(key, None) is not None:
            self._reindex()

    def clear(self) -> None:
        self._cache.clear()
        self._hashes.clear()
