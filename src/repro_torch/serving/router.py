"""Routing policies for the serving gateway (the dispatcher idiom); a copy
of `repro.serving.router`, which is framework-free. `lineage_of` and
`LineageRouter.home_index` hash with `zlib`, so both packages send a
lineage to the same home replica.

One abstract `Router` interface, per-policy implementations — the same
shape vLLM uses for its token dispatchers: the gateway never branches on
which policy is active, it just calls `route()` against a snapshot of
per-replica load.

Routers are PURE decision functions over `ReplicaView`s: they hold only
their own counters, never replica handles, so the same router drives an
in-process fleet and an RPC fleet identically and a seeded request
sequence routes identically on every run (the determinism the serving
tests pin).

* `RoundRobinRouter` — rotate over alive replicas; the baseline.
* `LeastLoadedRouter` — min outstanding rows; pure occupancy.
* `LineageRouter` — the league-aware default. A league serves many
  concurrent policies (MALib's population-serving argument), and every
  replica hosting every lineage would blow the stacked-model group and
  the param footprint. So each model lineage (the `ModelKey.agent_id` —
  versions within a lineage share weights structure and actors) hashes
  to a home replica; requests follow the lineage unless the home's
  outstanding load exceeds `spill_factor` x the least-loaded replica's
  (plus a small absolute floor so an idle fleet never spills), at which
  point the request spills to the least-loaded replica — occupancy wins
  over affinity under pressure.
"""
from __future__ import annotations

import abc
import zlib
from typing import Hashable, List, Optional, Sequence


def lineage_of(model: Hashable) -> str:
    """The affinity key for a model route: `ModelKey.agent_id` (all
    versions of one agent land together), else the stringified route."""
    agent = getattr(model, "agent_id", None)
    if agent is not None:
        return str(agent)
    return str(model)


class ReplicaView:
    """What a router is allowed to see about one replica: index, liveness
    and load. `load` folds the gateway's own outstanding-row ledger with
    the replica-reported queue depth from the last telemetry refresh —
    the `InfServer.stats()` occupancy signal crossing the RPC seam."""
    __slots__ = ("index", "alive", "inflight_rows", "queue_depth",
                 "ewma_latency_s")

    def __init__(self, index: int, alive: bool = True,
                 inflight_rows: int = 0, queue_depth: int = 0,
                 ewma_latency_s: float = 0.0):
        self.index = index
        self.alive = alive
        self.inflight_rows = inflight_rows
        self.queue_depth = queue_depth
        self.ewma_latency_s = ewma_latency_s

    @property
    def load(self) -> int:
        return self.inflight_rows + self.queue_depth

    def __repr__(self):
        return (f"ReplicaView({self.index}, alive={self.alive}, "
                f"load={self.load})")


class Router(abc.ABC):
    """One routing decision per submit: pick the replica index for
    (`model`, `rows`) given the fleet's current load views. Implementations
    must be deterministic in their inputs and must only return the index
    of an ALIVE view; `NoReplicas` is raised for them when none is."""

    @abc.abstractmethod
    def route(self, model: Hashable, rows: int,
              replicas: Sequence[ReplicaView]) -> int:
        ...


class NoReplicas(RuntimeError):
    """Every replica in the fleet is marked dead."""


def _alive(replicas: Sequence[ReplicaView]) -> List[ReplicaView]:
    alive = [r for r in replicas if r.alive]
    if not alive:
        raise NoReplicas("no alive replicas in the fleet")
    return alive


class RoundRobinRouter(Router):
    def __init__(self):
        self._i = 0

    def route(self, model, rows, replicas) -> int:
        alive = _alive(replicas)
        pick = alive[self._i % len(alive)]
        self._i += 1
        return pick.index


class LeastLoadedRouter(Router):
    def route(self, model, rows, replicas) -> int:
        alive = _alive(replicas)
        return min(alive, key=lambda r: (r.load, r.index)).index


class LineageRouter(Router):
    """Lineage affinity with occupancy spill (see module docstring).

    `spill_factor` — spill when home.load > factor x min load;
    `spill_min_rows` — but never below this absolute home load, so a
    quiet fleet keeps perfect affinity (min load 0 would otherwise make
    any nonzero home load spill)."""

    def __init__(self, spill_factor: float = 2.0, spill_min_rows: int = 64):
        assert spill_factor >= 1.0
        self.spill_factor = spill_factor
        self.spill_min_rows = spill_min_rows
        self.spills = 0          # routed away from home by occupancy
        self.affinity_hits = 0   # routed to the lineage's home replica

    def home_index(self, model: Hashable, n_replicas: int) -> int:
        """The lineage's home slot over the FULL fleet size (stable when
        a replica dies — other lineages don't reshuffle)."""
        h = zlib.crc32(lineage_of(model).encode("utf-8"))
        return h % max(1, n_replicas)

    def route(self, model, rows, replicas) -> int:
        alive = _alive(replicas)
        by_index = {r.index: r for r in alive}
        # walk forward from the home slot to the first alive replica, so
        # a dead home only moves ITS lineages (consistent-hashing-lite)
        n = len(replicas)
        home = None
        start = self.home_index(model, n)
        for k in range(n):
            cand = by_index.get((start + k) % n)
            if cand is not None:
                home = cand
                break
        least = min(alive, key=lambda r: (r.load, r.index))
        if (home.load + rows > self.spill_min_rows
                and home.load > self.spill_factor * least.load
                and least.index != home.index):
            self.spills += 1
            return least.index
        self.affinity_hits += 1
        return home.index


ROUTERS = {
    "round_robin": RoundRobinRouter,
    "least_loaded": LeastLoadedRouter,
    "lineage": LineageRouter,
}


def make_router(name: str, **kwargs) -> Router:
    """Registry constructor: `make_router('lineage', spill_factor=1.5)`.
    Accepts a ready Router instance pass-through for callers that built
    their own."""
    if isinstance(name, Router):
        return name
    try:
        cls = ROUTERS[name]
    except KeyError:
        raise ValueError(f"unknown router {name!r}; "
                         f"have {sorted(ROUTERS)}") from None
    return cls(**kwargs)
