"""ModelPool: the concrete neural-net parameter store (§3.2); counterpart
of `repro.core.model_pool`, with the same protocol and the port's
`tree_copy` and manifests (tensor leaves, on the card or not).

The paper runs M_M replicas behind a load balancer with everything
in-memory for instantaneous read/write. On one host that collapses to a
dict, but the API is the paper's: `pull`/`push` for the current learning
params (Actors pull theta and phi periodically; the Learner pushes theta),
`freeze` at learning-period end (theta joins the opponent pool M), and a
replica-pick hook preserved so the microservice semantics stay visible.

The pool is also the mint of the **param plane** (`repro_torch.params`): every
push bumps a monotonic per-key `version`, and the first consumer that
asks gets a `ParamManifest` (per-leaf content hashes) for it — computed
lazily and cached per version, so a run that never syncs by version (the
`--sync` loop) never pays for hashing. `pull_if_changed(key,
have_version)` is the hash-gated pull: `NotModified` when the caller is
current, a changed-leaves `ParamDelta` when the server still holds the
manifest of the caller's version (a bounded history), a full pytree
otherwise.

Concurrency contract (the async league runtime hits this from every
worker thread):

* every operation is serialized under one lock — push/pull/freeze are
  linearizable, and a `pull_if_changed` can never observe a version
  whose params it does not also see;
* `snapshot_on_pull=True` makes `pull` (and the leaves of a
  `ParamDelta`) return deep copies of the stored pytree, so no caller
  can ever alias a buffer that another owner later changes or hands to
  a train step. Callers can override per
  call with `copy=...`.
* `membership_version` bumps whenever the key set changes — cheap
  signatures for callers (LeagueMgr's opponent cache) that want to
  revalidate membership incrementally instead of rescanning per task.
  Per-key `version` counters are independent of it: re-pushing an
  existing key bumps that key's version but not `membership_version`.
"""
from __future__ import annotations

import collections
import random
import threading
import time
from typing import Any, Dict, Optional, Union

from repro_torch.core.types import ModelKey
from repro_torch.params.manifest import (NotModified, ParamDelta, ParamManifest,
                                   build_manifest, flatten_with_paths)
from repro_torch.utils.pytree import tree_copy

_MANIFEST_HISTORY = 16       # past manifests kept per key (hashes only)


class ModelPool:
    def __init__(self, num_replicas: int = 1, seed: int = 0,
                 snapshot_on_pull: bool = False):
        self.num_replicas = max(1, num_replicas)
        self.snapshot_on_pull = snapshot_on_pull
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._params: Dict[ModelKey, Any] = {}
        self._frozen: Dict[ModelKey, bool] = {}
        self._step: Dict[ModelKey, int] = {}
        self._versions: Dict[ModelKey, int] = {}          # monotonic per key
        self._manifest: Dict[ModelKey, ParamManifest] = {}  # current, lazy
        self._history: Dict[ModelKey, "collections.OrderedDict[int, ParamManifest]"] = {}
        self.membership_version = 0          # bumps when the key set changes
        self.read_counts = [0] * self.num_replicas  # replica load-balance bookkeeping
        # param-plane telemetry: how pulls were actually served
        # ("cross_key" counts answers where content addressing let some
        # leaves ride as hash references instead of bytes)
        self.pull_stats = {"full": 0, "delta": 0, "noop": 0, "cross_key": 0}

    def _pick_replica(self) -> int:
        r = self._rng.randrange(self.num_replicas)
        self.read_counts[r] += 1
        return r

    # -- API (paper protocol) -------------------------------------------------
    # Contract: every method here takes the pool lock and returns without
    # waiting on anything else — no pool call ever blocks beyond lock
    # contention (there is no capacity limit to wait on). Manifest hashing
    # happens lazily under the lock, once per (key, version), on the first
    # call that needs it.

    def push(self, key: ModelKey, params: Any, step: int = 0) -> None:
        """Store `params` under `key` and bump its version. Never blocks
        (lock only). The stored object is the caller's pytree, LIVE — the
        pool does not copy on push, so callers must hand over a snapshot
        if they keep mutating (the Learner's `_snapshot` does exactly
        that) and must never push buffers a train step may later
        change."""
        with self._lock:
            if self._frozen.get(key):
                raise ValueError(f"model {key} is frozen; push refused")
            if key not in self._params:
                self.membership_version += 1
            self._params[key] = params
            self._step[key] = step
            self._versions[key] = self._versions.get(key, -1) + 1
            self._manifest.pop(key, None)    # re-minted lazily on next ask

    def pull(self, key: ModelKey, copy: Optional[bool] = None) -> Any:
        """Read `key`'s params. Never blocks (lock only). Snapshot vs live:
        with `copy=True` (or `copy=None` under a `snapshot_on_pull` pool)
        the caller gets a deep copy it can own outright; with `copy=False`
        it gets the LIVE stored object — read-only, and never safe to feed
        to a train step. Raises KeyError for unknown keys."""
        with self._lock:
            self._pick_replica()
            self.pull_stats["full"] += 1
            params = self._params[key]
            if self.snapshot_on_pull if copy is None else copy:
                params = tree_copy(params)
            return params

    def pull_if_changed(self, key: ModelKey,
                        have_version: Optional[int] = None,
                        copy: Optional[bool] = None,
                        have_hashes=None
                        ) -> Union[NotModified, ParamDelta]:
        """The hash-gated pull. With `have_version` equal to the current
        version the answer is a `NotModified` tag (nothing else moves).
        Otherwise a `ParamDelta`: changed leaves only, when the manifest
        of `have_version` is still in the bounded per-key history (it is
        whenever the caller obtained that version through this method);
        the full pytree when the caller's version is unknown, prehistoric,
        or the leaf set itself changed. Copy semantics of the returned
        arrays match `pull`. Raises KeyError for unknown keys.

        `have_hashes` (an iterable of leaf content hashes the caller
        holds — under ANY key) enables cross-key content addressing:
        leaves whose hash the caller advertised are answered as
        path->hash references (`ParamDelta.by_hash`) instead of bytes,
        on both the delta path and the would-be-full path. An exploiter
        reset that re-mints the seed pytree under a fresh key thus ships
        nothing to a consumer that ever held the seed."""
        with self._lock:
            self._pick_replica()
            params = self._params[key]          # KeyError for unknown keys
            man = self._current_manifest_locked(key)
            if have_version is not None and have_version == man.version:
                self.pull_stats["noop"] += 1
                return NotModified(version=man.version)
            snap = self.snapshot_on_pull if copy is None else copy
            have = frozenset(have_hashes) if have_hashes else frozenset()

            def split(paths, by_path):
                """Partition into shipped bytes vs hash references."""
                ship, by_hash = {}, {}
                for p in paths:
                    h = man.leaf_hashes[p]
                    if h in have:
                        by_hash[p] = h
                    else:
                        ship[p] = (tree_copy(by_path[p]) if snap
                                   else by_path[p])
                return ship, (by_hash or None)

            old = (self._history.get(key, {}).get(have_version)
                   if have_version is not None else None)
            if old is not None:
                changed = man.changed_paths(old)
                if changed is not None:
                    self.pull_stats["delta"] += 1
                    leaves, by_hash = split(changed,
                                            dict(flatten_with_paths(params)))
                    if by_hash:
                        self.pull_stats["cross_key"] += 1
                    return ParamDelta(manifest=man, full=False,
                                      leaves=leaves, by_hash=by_hash)
            if have:
                leaves, by_hash = split(list(man.leaf_hashes),
                                        dict(flatten_with_paths(params)))
                if by_hash:      # at least one leaf rides as a reference
                    self.pull_stats["cross_key"] += 1
                    return ParamDelta(manifest=man, full=False,
                                      leaves=leaves, by_hash=by_hash)
            self.pull_stats["full"] += 1
            return ParamDelta(manifest=man, full=True,
                              params=tree_copy(params) if snap else params)

    def _current_manifest_locked(self, key: ModelKey) -> ParamManifest:
        man = self._manifest.get(key)
        if man is None:
            man = build_manifest(self._params[key], self._versions[key])
            self._manifest[key] = man
            hist = self._history.setdefault(key, collections.OrderedDict())
            hist[man.version] = man
            while len(hist) > _MANIFEST_HISTORY:
                hist.popitem(last=False)
        return man

    def manifest(self, key: ModelKey) -> ParamManifest:
        """Current `ParamManifest` for `key` (minted now if needed)."""
        with self._lock:
            return self._current_manifest_locked(key)

    def version(self, key: ModelKey) -> int:
        """Current monotonic version of `key` (no hashing)."""
        with self._lock:
            if key not in self._params:
                raise KeyError(key)
            return self._versions[key]

    def pull_attr(self, key: ModelKey) -> dict:
        """Metadata snapshot (step counter, frozen flag, param-plane
        version); non-blocking."""
        with self._lock:
            return {"step": self._step.get(key, 0),
                    "frozen": self._frozen.get(key, False),
                    "version": self._versions.get(key, 0)}

    def install(self, key: ModelKey, params: Any, version: int,
                manifest: Optional[ParamManifest] = None, step: int = 0,
                frozen: bool = False) -> bool:
        """Replica-side adopt: store `params` AT an explicit version (the
        primary's), so a replica answers `pull_if_changed` with versions
        and hashes coherent with the primary — a client that cached v5
        from the primary gets a valid v5→v7 delta from a replica at v7.

        Monotonic guard: an install at or below the key's current version
        is refused (returns False) — a lagging sync can never regress the
        replica. Passing the primary's `manifest` skips local re-hashing
        and seeds the delta history. `frozen` mirrors the primary's
        write-bar only when set (never un-freezes)."""
        with self._lock:
            if key in self._params and version <= self._versions[key]:
                return False
            if key not in self._params:
                self.membership_version += 1
            self._params[key] = params
            self._step[key] = step
            self._versions[key] = version
            if manifest is not None:
                assert manifest.version == version, (manifest.version, version)
                self._manifest[key] = manifest
                hist = self._history.setdefault(key, collections.OrderedDict())
                hist[version] = manifest
                while len(hist) > _MANIFEST_HISTORY:
                    hist.popitem(last=False)
            else:
                self._manifest.pop(key, None)
            if frozen:
                self._frozen[key] = True
            return True

    def freeze(self, key: ModelKey) -> None:
        """Mark `key` immutable: later `push`es to it raise. Non-blocking;
        the params themselves are not copied — freezing is a write-bar,
        not a snapshot (and its version stops advancing, so every later
        `pull_if_changed` on it is a NotModified no-op)."""
        with self._lock:
            if key not in self._params:
                raise KeyError(key)
            self._frozen[key] = True

    def keys(self):
        """Snapshot list of hosted keys (stale the moment the lock drops —
        use `membership_version` to detect changes cheaply)."""
        with self._lock:
            return list(self._params)

    def __contains__(self, key: ModelKey):
        return key in self._params

    def __len__(self):
        return len(self._params)


class ModelPoolReplica:
    """A read replica: the paper's M_M ModelPool instances (§3.2), grown
    from one primary via the existing manifest/delta protocol.

    Wraps a *primary* (anything with the ModelPool pull surface; in `repro`
    usually a `ModelPoolClient` over RPC, not ported yet) and keeps a local
    `ModelPool` in sync: each `sync_once` lists the primary's keys and runs every key through a
    `CachedPuller`, so an unchanged key costs one `NotModified` tag and a
    Learner publish arrives as a changed-leaves delta. Params are
    installed at the PRIMARY's version with the primary's manifest
    (`ModelPool.install`), so a consumer that cached v5 from the primary
    and fails over here gets a version-coherent v5→v7 delta, and a
    lagging replica can never regress below what it already serves.

    The replica object itself exposes the READ half of the pool protocol
    (in `repro` it is served under the "pool" RPC namespace); writes
    raise — learners must push to the primary.
    """

    def __init__(self, primary, sync_interval_s: float = 0.5):
        from repro_torch.params.cache import CachedPuller
        self._primary = primary
        self.pool = ModelPool(snapshot_on_pull=False)
        self._puller = CachedPuller(primary, copy=False)
        self.sync_interval_s = sync_interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.sync_stats = {"cycles": 0, "keys_installed": 0, "frozen_mirrored": 0,
                           "errors": 0, "last_ok_t": None}

    # -- follower ------------------------------------------------------------
    def sync_once(self) -> int:
        """One catch-up pass against the primary; returns how many keys
        changed locally. Raises whatever the primary transport raises —
        the follower loop counts and retries, one-shot callers decide."""
        installed = 0
        for key in self._primary.keys():
            params, man = self._puller.get_with_manifest(key)
            if man is None:
                continue                      # primary predates the param plane
            if self.pool.install(key, params, man.version, manifest=man):
                installed += 1
            attr = self._primary.pull_attr(key)
            # freeze only once the final weights are in hand: a frozen key
            # at an older local version keeps syncing until versions match
            if attr.get("frozen") and self.pool.version(key) >= attr["version"] \
                    and not self.pool.pull_attr(key)["frozen"]:
                self.pool.freeze(key)
                self.sync_stats["frozen_mirrored"] += 1
        self.sync_stats["cycles"] += 1
        self.sync_stats["keys_installed"] += installed
        self.sync_stats["last_ok_t"] = time.monotonic()
        return installed

    def _follow(self):
        while not self._stop.is_set():
            try:
                self.sync_once()
            except Exception:
                self.sync_stats["errors"] += 1
            self._stop.wait(self.sync_interval_s)

    def start_following(self) -> "ModelPoolReplica":
        assert self._thread is None, "already following"
        self._thread = threading.Thread(target=self._follow,
                                        name="pool-replica-sync", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    # -- read half of the pool protocol (servable under ns "pool") -----------
    def pull(self, key, copy=None):
        return self.pool.pull(key, copy=copy)

    def pull_if_changed(self, key, have_version=None, copy=None,
                        have_hashes=None):
        return self.pool.pull_if_changed(key, have_version, copy=copy,
                                         have_hashes=have_hashes)

    def manifest(self, key):
        return self.pool.manifest(key)

    def version(self, key):
        return self.pool.version(key)

    def pull_attr(self, key):
        return self.pool.pull_attr(key)

    def keys(self):
        return self.pool.keys()

    @property
    def membership_version(self):
        return self.pool.membership_version

    @property
    def pull_stats(self):
        return self.pool.pull_stats

    def __contains__(self, key):
        return key in self.pool

    def __len__(self):
        return len(self.pool)

    # -- writes are refused: this is a READ replica ---------------------------
    def push(self, key, params, step: int = 0):
        raise ValueError("read replica: push refused — write to the primary")

    def freeze(self, key):
        raise ValueError("read replica: freeze refused — write to the primary")
