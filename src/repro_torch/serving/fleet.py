"""Replica-fleet process management for the serving gateway; counterpart
of `repro.serving.fleet`.

Spawns standalone InfServer replica processes (`python -m
repro_torch.launch.serve --replica`, each in a fresh interpreter),
discovers their bound addresses from the `REPLICA host:port` line each
prints on startup, and hands back handles the smoke/chaos harnesses can
`kill -9` — a gateway test against replicas that can't really die isn't a
gateway test.

Unlike `repro`'s, a replica's stderr is passed through rather than sent to
`DEVNULL`: a replica that dies on CUDA initialisation or on a kernel error
says why. `device` is passed to every replica (CUDA when None).
"""
from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
from typing import List, Optional

from repro_torch.distributed.transport import (InfServerClient, RetryPolicy,
                                               RpcClient)

_BANNER = "REPLICA "


class ReplicaProc:
    """One spawned replica process + its serving address."""

    def __init__(self, proc: subprocess.Popen, address: str):
        self.proc = proc
        self.address = address

    @property
    def alive(self) -> bool:
        return self.proc.poll() is None

    def kill(self) -> None:
        """SIGKILL — the chaos path; no cleanup runs in the replica."""
        if self.alive:
            os.kill(self.proc.pid, signal.SIGKILL)
        self.proc.wait(timeout=10)

    def terminate(self) -> None:
        if self.alive:
            self.proc.terminate()
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:          # pragma: no cover
            self.kill()

    def __repr__(self):
        return f"ReplicaProc(pid={self.proc.pid}, address={self.address!r})"


def _src_pythonpath() -> str:
    """PYTHONPATH for a child that must import `repro_torch` like we do."""
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))               # .../src
    prev = os.environ.get("PYTHONPATH", "")
    return here + (os.pathsep + prev if prev else "")


def spawn_replica(*, arch: str = "tleague-policy-s", env_name: str = "rps",
                  seed: int = 0, max_batch: int = 256,
                  bind: str = "127.0.0.1:0", device: Optional[str] = None,
                  startup_timeout_s: float = 60.0) -> ReplicaProc:
    """Start one standalone replica and wait for its address banner."""
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--replica",
           "--bind", bind, "--arch", arch, "--env", env_name,
           "--seed", str(seed), "--max-batch", str(max_batch)]
    if device is not None:
        cmd += ["--device", str(device)]
    env = dict(os.environ, PYTHONPATH=_src_pythonpath())
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True, env=env)
    deadline = time.monotonic() + startup_timeout_s
    address = None
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            break                                  # child died
        if line.startswith(_BANNER):
            address = line[len(_BANNER):].strip()
            break
    if address is None:
        proc.kill()
        proc.wait(timeout=10)
        raise RuntimeError(
            f"replica failed to start within {startup_timeout_s}s "
            f"(exit={proc.poll()})")
    return ReplicaProc(proc, address)


def spawn_fleet(n: int, *, base_seed: int = 0, **kwargs) -> List[ReplicaProc]:
    """N replicas, distinct seeds (distinct serving RNG streams)."""
    fleet: List[ReplicaProc] = []
    try:
        for i in range(n):
            fleet.append(spawn_replica(seed=base_seed + i, **kwargs))
    except BaseException:
        shutdown(fleet)                            # no orphans on a failed start
        raise
    return fleet


def connect(address: str, *, retry: Optional[RetryPolicy] = None,
            timeout: Optional[float] = 30.0) -> InfServerClient:
    """An `InfServerClient` for one replica address. The default retry
    gives up fast — the GATEWAY owns failover across replicas, so a dead
    replica should surface as TransportError quickly, not after a long
    single-endpoint backoff."""
    retry = retry or RetryPolicy(base_s=0.05, cap_s=0.2, max_attempts=4,
                                 deadline_s=1.0)
    return InfServerClient(RpcClient(address, timeout=timeout, retry=retry))


def shutdown(fleet: List[ReplicaProc]) -> None:
    for r in fleet:
        try:
            r.terminate()
        except Exception:                          # pragma: no cover
            pass
