"""Liveness: heartbeats so workers can tell slow from dead; a copy of
`repro.distributed.heartbeat`, which is framework-free (the port imports
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

* **`HeartbeatMonitor`** — the worker-process side over the RPC
  transport: a thread that probes the coordinator's `ctrl.ping` on its own
  connection and declares it dead when the count stops advancing.
* **`probe`** / **`main`** — a one-shot liveness check, the k8s exec-probe
  entry point (`python -m repro_torch.distributed.heartbeat host:port`).

Both import `RpcClient` lazily, as `repro`'s do: the transport imports
nothing of this module, and this module needs it only when they run.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple


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


class HeartbeatMonitor(threading.Thread):
    """Watch a remote heartbeat over the worker's own probe connection.

    Declares the peer dead when `ping` fails to advance for `timeout_s`
    (transport errors count as no-advance: the monitor keeps retrying —
    a restarting coordinator that comes back within the window is never
    declared dead). `on_dead` runs exactly once, then the thread exits.
    """

    def __init__(self, address: str, *, interval_s: float = 1.0,
                 timeout_s: float = 10.0, ns: str = "ctrl",
                 on_dead: Optional[Callable[[], None]] = None):
        super().__init__(name=f"heartbeat-monitor@{address}", daemon=True)
        from repro_torch.distributed.transport import RpcClient

        self.address = address
        self.interval_s = interval_s
        self.timeout_s = timeout_s
        self.dead = False
        self._ns = ns
        self._on_dead = on_dead
        self._halt = threading.Event()
        # short socket timeout: a wedged peer must not wedge the probe
        self._client = RpcClient(address, timeout=max(2.0, interval_s),
                                 connect_retries=1, retry_delay_s=0.05)

    def run(self):
        last_n: Optional[int] = None
        last_advance = time.monotonic()
        while not self._halt.is_set():
            try:
                n = self._client.call(f"{self._ns}.ping")
                if n != last_n:
                    last_n = n
                    last_advance = time.monotonic()
            except Exception:             # noqa: BLE001 — ANY probe failure
                # (TransportError, RemoteError from a version-skewed peer
                # without ctrl.ping, decode errors) counts as no-advance
                # and is retried: the monitor thread must never die
                # silently, or the worker loses wedge detection entirely
                pass
            if time.monotonic() - last_advance > self.timeout_s:
                self.dead = True
                try:
                    if self._on_dead is not None:
                        self._on_dead()
                finally:
                    self._client.close()
                return
            self._halt.wait(self.interval_s)
        self._client.close()

    def stop(self) -> None:
        self._halt.set()


def probe(address: str, *, timeout_s: float = 5.0, ns: str = "ctrl") -> bool:
    """One-shot liveness check: True iff `ns.ping` answers within
    `timeout_s`. The k8s exec-probe entrypoint."""
    from repro_torch.distributed.transport import RpcClient

    client = RpcClient(address, timeout=timeout_s, connect_retries=1,
                       retry_delay_s=0.05)
    try:
        client.call(f"{ns}.ping")
        return True
    except Exception:                            # noqa: BLE001 — probe is binary
        return False
    finally:
        client.close()


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="liveness probe against a coordinator heartbeat")
    ap.add_argument("address", help="coordinator host:port")
    ap.add_argument("--timeout", type=float, default=5.0)
    args = ap.parse_args()
    addr = args.address.removeprefix("tcp://")
    return 0 if probe(addr, timeout_s=args.timeout) else 1


if __name__ == "__main__":
    raise SystemExit(main())
