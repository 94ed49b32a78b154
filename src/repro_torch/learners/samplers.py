"""Pluggable replay sampling: the strategy seam under `DataServer`.

`DataServer._sample_idx` used to hard-code one policy (newest segment in
blocking mode, uniform otherwise). The uniform branch is now a
`Sampler` object the server delegates to, with two more strategies for
off-policy / value-based workloads:

* **UniformSampler** — the default; draws from the server's own
  `np.random.Generator` with the exact pre-refactor call sequence
  (``rng.integers(size, size=k)`` then the head-relative ring mapping),
  so the slot stream is bit-identical to the old `DataServer` and the
  `--sync` oracle stays deterministic.
* **PrioritizedSampler** — proportional prioritized replay on a
  vectorized array segment tree. Semantics are pinned to tianshou's
  `PrioritizedReplayBuffer` (the reference this repo's tests encode):
  new rows enter at ``max_priority ** alpha``; sampling draws
  ``rng.random(k) * tree_total`` prefix-sum lookups; importance weights
  are ``(tree_weight / min_priority) ** (-beta)``; consumer updates set
  ``(|p| + eps) ** alpha`` and widen the max/min trackers.
* **EpisodeSampler** — episode-granularity sampling per AlphaFIRST's
  episode replay: rows are chained into episodes as they arrive (lane =
  producer source × row offset, terminal rows close an episode, ring
  overwrites invalidate), and sampling returns whole episodes' rows —
  contiguous in time even when the episode's rows straddle the ring
  wraparound point.

Samplers deal purely in *ring slots*; the blocking-mode newest-segment
fast path stays in `DataServer` (it is a freshness contract, not a
sampling strategy).

Counterpart of `repro.learners.samplers`, carried over unchanged: it is framework-free,
so the same seeds make the same decisions in both packages.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class SegmentTree:
    """Array-backed sum tree over `size` slots (vectorized set/query).

    Layout: `_value[bound:bound+size]` are the leaves, internal node i
    sums its children 2i/2i+1, `_value[1]` is the total. All operations
    take numpy index/value arrays and run level-synchronously — no
    per-element Python loops."""

    def __init__(self, size: int):
        self._size = size
        bound = 1
        while bound < size:
            bound *= 2
        self._bound = bound
        self._value = np.zeros(2 * bound, np.float64)

    def __getitem__(self, index):
        return self._value[np.asarray(index) + self._bound]

    def __setitem__(self, index, value):
        index = np.asarray(index).reshape(-1) + self._bound
        self._value[index] = value
        while index[0] > 1:
            index = np.unique(index // 2)
            self._value[index] = (self._value[2 * index]
                                  + self._value[2 * index + 1])

    def reduce(self) -> float:
        return float(self._value[1])

    def get_prefix_sum_idx(self, value) -> np.ndarray:
        """For each scalar v, the smallest leaf i with prefix_sum(i) > v —
        the proportional-sampling lookup."""
        value = np.asarray(value, np.float64).copy().reshape(-1)
        index = np.ones_like(value, np.int64)
        while index[0] < self._bound:
            index *= 2
            left = self._value[index]
            go_right = value >= left
            value -= left * go_right
            index += go_right
        return np.minimum(index - self._bound, self._size - 1)


class Sampler:
    """Strategy interface. `bind(ds)` attaches the owning DataServer
    (ring geometry + rng live there); `on_allocate` fires once when the
    ring is sized; `on_write` observes every segment as it lands (ring
    slots + per-row terminal flags + producer source); `sample(k)`
    returns k ring slots; `weights`/`update_priorities` are the
    prioritized-replay consumer loop and no-op elsewhere."""

    name = "base"

    def bind(self, ds) -> None:
        self.ds = ds

    def on_allocate(self, row_slots: int) -> None:
        pass

    def on_write(self, slots: np.ndarray, *, row_done=None, source=None) -> None:
        pass

    def sample(self, k: int) -> np.ndarray:
        raise NotImplementedError

    def weights(self, slots: np.ndarray) -> Optional[np.ndarray]:
        return None

    def update_priorities(self, slots: np.ndarray, priorities) -> None:
        pass

    def _uniform(self, k: int) -> np.ndarray:
        """The pre-refactor uniform draw, bit-for-bit: same generator,
        same call, same head-relative mapping onto ring slots."""
        ds = self.ds
        idx = ds.rng.integers(ds._size, size=k)
        return (ds._head - ds._size + idx) % ds._row_slots


class UniformSampler(Sampler):
    name = "uniform"

    def sample(self, k: int) -> np.ndarray:
        return self._uniform(k)


class PrioritizedSampler(Sampler):
    """Proportional prioritized replay, tianshou-pinned semantics."""

    name = "prioritized"
    reweights = True          # priority updates invalidate staged batches

    def __init__(self, alpha: float = 0.6, beta: float = 0.4):
        assert alpha > 0.0 and beta >= 0.0
        self.alpha, self.beta = alpha, beta
        self._eps = np.finfo(np.float32).eps.item()
        self._max_prio = 1.0
        self._min_prio = 1.0
        self._tree: Optional[SegmentTree] = None

    def on_allocate(self, row_slots: int) -> None:
        self._tree = SegmentTree(row_slots)

    def on_write(self, slots, *, row_done=None, source=None) -> None:
        # init_weight: fresh rows enter at the running max priority so
        # every row is consumed at least once before its TD error rules
        self._tree[slots] = self._max_prio ** self.alpha

    def sample(self, k: int) -> np.ndarray:
        total = self._tree.reduce()
        assert total > 0.0, "prioritized sample from an empty tree"
        scalar = self.ds.rng.random(k) * total
        return self._tree.get_prefix_sum_idx(scalar)

    def weights(self, slots) -> np.ndarray:
        # tianshou's get_weight: tree value (already ** alpha) over the
        # raw min priority, to the -beta — unnormalized IS weights; the
        # consumer divides by weights.max() if it wants the stable form
        return (np.asarray(self._tree[slots])
                / self._min_prio) ** (-self.beta)

    def update_priorities(self, slots, priorities) -> None:
        w = np.abs(np.asarray(priorities, np.float64)) + self._eps
        self._tree[slots] = w ** self.alpha
        self._max_prio = max(self._max_prio, float(w.max()))
        self._min_prio = min(self._min_prio, float(w.min()))


class EpisodeSampler(Sampler):
    """Episode-granularity sampling over ring rows.

    Rows arrive segment-by-segment; row i of consecutive segments from
    one producer is the same env slot, so each (source, i) lane chains
    rows in episode order. A row whose `done` fires closes the lane's
    open chain into a complete episode; a ring overwrite of any chained
    slot invalidates whatever contained it (episode or open chain) —
    stale boundaries are never sampled.

    `sample(k)` draws complete episodes uniformly (with replacement),
    concatenates their rows in temporal order, and truncates to exactly
    k — callers get whole-episode runs, reconstructable across the ring
    wraparound. Before any episode completes it falls back to the
    uniform draw so the learner never starves."""

    name = "episode"

    def __init__(self):
        self._episodes: Dict[int, np.ndarray] = {}
        self._open: Dict[tuple, list] = {}
        self._owner: Dict[int, tuple] = {}   # slot -> ("ep", id) | ("open", lane)
        self._next_id = 0

    def _invalidate(self, slot: int) -> None:
        owner = self._owner.pop(slot, None)
        if owner is None:
            return
        kind, key = owner
        members = (self._episodes.pop(key, None) if kind == "ep"
                   else self._open.pop(key, None))
        if members is not None:
            for s in members:
                self._owner.pop(int(s), None)

    def on_write(self, slots, *, row_done=None, source=None) -> None:
        slots = np.asarray(slots)
        rows = len(slots)
        if row_done is None:
            row_done = np.ones(rows, bool)   # no done signal: row == episode
        for s in slots:
            self._invalidate(int(s))
        for i in range(rows):
            lane = (source, i)
            chain = self._open.setdefault(lane, [])
            chain.append(int(slots[i]))
            self._owner[int(slots[i])] = ("open", lane)
            if row_done[i]:
                ep_id, self._next_id = self._next_id, self._next_id + 1
                ep = np.array(chain, np.int64)
                self._episodes[ep_id] = ep
                for s in chain:
                    self._owner[s] = ("ep", ep_id)
                self._open[lane] = []

    def episodes(self):
        """Complete episodes as ring-slot arrays (temporal order)."""
        return [ep.copy() for ep in self._episodes.values()]

    def sample(self, k: int) -> np.ndarray:
        eps = list(self._episodes.values())
        if not eps:
            return self._uniform(k)
        out: list = []
        while len(out) < k:
            e = eps[int(self.ds.rng.integers(len(eps)))]
            out.extend(e.tolist())
        return np.asarray(out[:k], np.int64)


SAMPLERS = {
    "uniform": UniformSampler,
    "prioritized": PrioritizedSampler,
    "episode": EpisodeSampler,
}


def make_sampler(name, **kwargs) -> Sampler:
    """`name` may already be a Sampler instance (passed through)."""
    if isinstance(name, Sampler):
        assert not kwargs, "kwargs only apply when constructing by name"
        return name
    if name not in SAMPLERS:
        raise KeyError(f"unknown sampler {name!r}; have {sorted(SAMPLERS)}")
    return SAMPLERS[name](**kwargs)
