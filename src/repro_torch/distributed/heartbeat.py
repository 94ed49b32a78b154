"""Liveness: heartbeats so workers can tell slow from dead; a copy of the
framework-free part of `repro.distributed.heartbeat` (the port imports
nothing of `repro`).

* **`Heartbeat`** — a monotonic beat counter. The league runtime's
  coordinator thread beats it every loop, and worker threads call
  `stalled(timeout_s)`: a beat gap longer than that means the coordinator
  is dead, and they exit their loops cleanly. A busy-but-alive coordinator
  still advances it (its thread needs only the interpreter lock), a dead
  or frozen one cannot. `start_beating` bumps it from a daemon thread.
* **`BeatRegistry`** — the coordinator-side inverse: per-WORKER beat
  counters, classified into alive vs stale by wall age, the signal that
  feeds the lease reaper.

`repro`'s `HeartbeatMonitor` and `probe` watch a coordinator over the RPC
transport, which the port does not have yet (ROADMAP queue 1 item 7); they
come with it.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple


class Heartbeat:
    """A thread-safe beat counter with wall-age bookkeeping."""

    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0
        self._t = time.monotonic()
        self._beater: Optional[threading.Thread] = None
        self._beater_stop = threading.Event()

    def beat(self) -> int:
        with self._lock:
            self._n += 1
            self._t = time.monotonic()
            return self._n

    def ping(self) -> int:
        """The RPC-served read: current beat count."""
        with self._lock:
            return self._n

    def age_s(self) -> float:
        with self._lock:
            return time.monotonic() - self._t

    def stalled(self, timeout_s: float) -> bool:
        """True when no beat landed for `timeout_s` — the in-process
        worker's dead-coordinator test."""
        return self.age_s() > timeout_s

    # -- background beater ---------------------------------------------------
    def start_beating(self, interval_s: float = 1.0) -> "Heartbeat":
        """Bump the counter from a daemon thread every `interval_s`.
        Idempotent; `stop_beating` (or process exit) ends it."""
        if self._beater is None:
            self._beater_stop.clear()
            self._beater = threading.Thread(
                target=self._beat_loop, args=(interval_s,),
                name="heartbeat-beater", daemon=True)
            self._beater.start()
        return self

    def _beat_loop(self, interval_s: float):
        while not self._beater_stop.wait(interval_s):
            self.beat()

    def stop_beating(self) -> None:
        if self._beater is not None:
            self._beater_stop.set()
            self._beater.join(timeout=5.0)
            self._beater = None


class BeatRegistry:
    """Per-worker beat counters, the coordinator-side liveness ledger.

    `beat(name)` is cheap enough to ride every ctrl-plane report; `ages()`
    snapshots wall age per worker; `split(stale_s)` partitions into
    (alive, stale) name lists. A worker never beats itself out of the
    registry — `forget(name)` removes one deliberately (e.g. after its
    process was reaped and respawned under a new name)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._beats: Dict[str, Tuple[int, float]] = {}   # name -> (count, t)

    def beat(self, name: str) -> int:
        with self._lock:
            n = self._beats.get(name, (0, 0.0))[0] + 1
            self._beats[name] = (n, time.monotonic())
            return n

    def ages(self) -> Dict[str, float]:
        now = time.monotonic()
        with self._lock:
            return {name: now - t for name, (_, t) in self._beats.items()}

    def split(self, stale_s: float) -> Tuple[List[str], List[str]]:
        """(alive, stale) worker names at the `stale_s` age threshold."""
        alive, stale = [], []
        for name, age in self.ages().items():
            (alive if age <= stale_s else stale).append(name)
        return alive, stale

    def forget(self, name: str) -> None:
        with self._lock:
            self._beats.pop(name, None)

    def __len__(self):
        with self._lock:
            return len(self._beats)
