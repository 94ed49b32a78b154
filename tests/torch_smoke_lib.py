"""Process plumbing shared by the port's fault smokes (`smoke_torch_*.py`).

Each smoke starts real processes, faults them (SIGKILL, SIGSTOP) and reads
what they print. The pieces here:

- `Child`: one child process in a process group of its own, its merged
  stdout drained on a thread into lines stamped with the seconds since the
  smoke started (a filled pipe would wedge the child), its exit time taken
  by a waiter thread. `kill_group()` ends the child and whatever it started
  (`kill_group(pid)`: SIGCONT first, as a stopped process must be continued
  before it is killed); the smokes call it in a `finally`, so no child
  outlives them. `chip_smoke.py` ends its own subprocesses with it too.
- `records(lines)`: the `{"process": ...}` JSON objects the port's roles
  print, also where two objects share a line of a pipe (`chip_smoke.py`
  decodes its league runs' lines with it too); `report(child)`
  the kernel report of the last one, with the child's exit.
- `progress(address)`: the coordinator's `ctrl.progress()`, the events
  the smokes fire their faults on.
- `result(...)`: the smoke's final JSON line.

Imports neither jax nor the JAX package `repro`.
"""
from __future__ import annotations

import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

REPO = Path(__file__).resolve().parent.parent
SRC = REPO / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))

def child_env(extra: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """This process's environment with the port's `src` first on
    PYTHONPATH, plus `extra`."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(SRC), os.environ.get("PYTHONPATH")) if p)
    env.update(extra or {})
    return env


class Child:
    """One child process in its own session (so its own process group)."""

    def __init__(self, name: str, cmd: List[str], t0: float,
                 extra_env: Optional[Dict[str, str]] = None):
        self.name, self.cmd, self._t0 = name, cmd, t0
        self.lines: List[tuple] = []            # (seconds since t0, line)
        self.exit_s: Optional[float] = None
        self._eof = False
        self._new_line = threading.Condition()
        self.proc = subprocess.Popen(
            cmd, env=child_env(extra_env), cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, start_new_session=True)
        threading.Thread(target=self._drain, daemon=True).start()
        threading.Thread(target=self._wait, daemon=True).start()

    @property
    def pid(self) -> int:
        return self.proc.pid

    def _drain(self):
        for line in self.proc.stdout:
            with self._new_line:
                self.lines.append((time.monotonic() - self._t0, line))
                self._new_line.notify_all()
        with self._new_line:
            self._eof = True
            self._new_line.notify_all()

    def _wait(self):
        self.proc.wait()
        self.exit_s = time.monotonic() - self._t0

    def wait_for(self, pattern: str, timeout: float) -> Optional[str]:
        """Group 1 of the first line matching `pattern`, waiting up to
        `timeout` seconds; None when it never came or the child ended."""
        deadline = time.monotonic() + timeout
        seen = 0
        with self._new_line:
            while True:
                for _, line in self.lines[seen:]:
                    m = re.search(pattern, line)
                    if m:
                        return m.group(1)
                seen = len(self.lines)
                left = deadline - time.monotonic()
                if left <= 0 or self._eof:
                    return None
                self._new_line.wait(timeout=min(left, 0.5))

    def wait(self, timeout: float) -> Optional[int]:
        """The exit code, or None if the child still runs after `timeout`."""
        try:
            return self.proc.wait(timeout=max(0.0, timeout))
        except subprocess.TimeoutExpired:
            return None

    def text(self) -> str:
        return "".join(line for _, line in list(self.lines))

    def tail(self, n: int = 12) -> str:
        return "\n".join(self.text().splitlines()[-n:])

    def signal(self, sig: int) -> None:
        """Signal the child itself, not its group (a killed producer's
        resource tracker, in its group, must live on to unlink its
        segments)."""
        if self.proc.poll() is None:
            os.kill(self.proc.pid, sig)

    def kill_group(self) -> None:
        kill_group(self.proc.pid)
        try:
            self.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:        # pragma: no cover
            pass

    def records(self) -> List[dict]:
        return records(line for _, line in list(self.lines))


def kill_group(pid: int) -> None:
    """SIGCONT, then SIGKILL, the process group led by `pid` (a stopped
    process must be continued before it is killed); a group already gone is
    no error."""
    for sig in (signal.SIGCONT, signal.SIGKILL):
        try:
            os.killpg(pid, sig)
        except (ProcessLookupError, PermissionError):
            pass


def records(lines) -> List[dict]:
    """The `{"process": ...}` objects among `lines` (a line that holds two
    objects back to back yields both; a line cut by a kill yields none)."""
    out, dec = [], json.JSONDecoder()
    for line in lines:
        at = 0
        while line.startswith("{", at):
            try:
                rec, at = dec.raw_decode(line, at)
            except json.JSONDecodeError:
                break
            if isinstance(rec, dict) and "process" in rec:
                out.append(rec)
    return out


def progress(address: str) -> Optional[dict]:
    """The coordinator's `ctrl.progress()` over a short-lived connection,
    or None when it does not answer."""
    from repro_torch.distributed.transport import RpcClient, TransportError

    try:
        client = RpcClient(address, timeout=5.0, connect_retries=1)
    except (TransportError, OSError):
        return None
    try:
        return client.call("ctrl.progress")
    except (TransportError, OSError):
        return None
    finally:
        client.close()


def wait_until(pred, timeout: float, poll: float = 0.1):
    """Poll `pred()` until it returns a truthy value or `timeout` passes;
    returns the last value."""
    deadline = time.monotonic() + timeout
    while True:
        v = pred()
        if v or time.monotonic() >= deadline:
            return v
        time.sleep(poll)


def device_of(name: str) -> str:
    """Resolve the smokes' `--device` as the port's entry points do: CUDA
    unless the CPU is asked for by name, raising where there is no card."""
    from repro_torch.utils import resolve_device
    return str(resolve_device(name))


def result(smoke: str, ok: bool, **fields) -> None:
    """The smoke's last line: one JSON object of what it measured."""
    print(json.dumps({"smoke": smoke, "ok": ok, **fields}, default=str), flush=True)


def report(child: Child) -> dict:
    """A child's pid, exit code, exit time and the kernel report of the
    last role record it printed (None when it was killed first)."""
    recs = child.records()
    return {"pid": child.pid, "rc": child.proc.returncode, "exit_s": child.exit_s,
            "kernels": recs[-1].get("kernels") if recs else None}
