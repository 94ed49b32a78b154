"""The port's own spans and phases, on `torch.profiler`'s clock.

Tracing is on while `torch.profiler` records, on the threads it records:
the one that started it, and those autograd runs a backward on; an
InfServer flushing on another thread is traced only where that thread
runs its own profiler. Off, `span` and `phase` hand back one shared null
context: a call costs the profiler's flag and a global write.

- `span(name)` is a `record_function("repro_torch." + name)`: a kernel
  launched inside it on its thread links to it in a trace, and a host gap
  inside it carries its name. `name` may end in `#<n>` to number the
  calls of one span (`infserver.flush#<n>`).
- `phase(name, like)` is a span around stream-ordered work whose kernels
  another thread may launch (the backward's come from autograd's device
  thread, which a span on the caller's thread does not own). On CUDA it
  adds an event pair on the current stream of `like`'s device, so it
  times the device's work between the two; on the CPU, which runs
  synchronously, the host clock does.

Tracing writes to the process's `Recorder`, `profiled`, which keeps by
name (the part before `#`) each call's host seconds and each phase's
milliseconds, and each request's queue wait in an InfServer flush. It
holds the records of the last profiler session: the first span or phase
opened under the profiler, after one opened without it, clears it.
"""
from __future__ import annotations

import collections
import contextlib
import threading
import time

import torch

PREFIX = "repro_torch."
_NULL = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled


class Recorder:
    """What spans and phases recorded; see the module's docstring."""

    def __init__(self):
        self.clear()

    def clear(self):
        self.host_s = collections.defaultdict(list)    # name -> seconds a call
        self.queue_waits_s = []                         # submit -> flush start, a request
        self._phases = collections.defaultdict(list)   # name -> [ms or (start, end) events]

    def phase_ms(self, name: str) -> list:
        """Each call's milliseconds of phase `name`, waiting for the device
        where its events are still pending."""
        out = []
        for p in self._phases.get(name, ()):
            if isinstance(p, tuple):
                p[1].synchronize()
                p = p[0].elapsed_time(p[1])
            out.append(p)
        return out


profiled = Recorder()
_session = False             # a span has seen the current profiler session
_lock = threading.Lock()


def active():
    """`profiled` while the profiler records, else None; the first call
    of a profiler session clears `profiled`."""
    global _session
    if not _profiling():
        _session = False
        return None
    if not _session:
        with _lock:
            if not _session:
                profiled.clear()
                _session = True
    return profiled


class _Span:
    __slots__ = ("rec", "name", "key", "phase", "dev", "fn", "t0", "events")

    def __init__(self, rec, name, phase=False, dev=None):
        self.rec, self.name, self.key = rec, name, name.split("#", 1)[0]
        self.phase, self.dev = phase, dev          # dev: the CUDA device a phase is timed on

    def __enter__(self):
        self.fn = torch.profiler.record_function(PREFIX + self.name)
        self.fn.__enter__()
        self.events = None
        if self.dev is not None:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(torch.cuda.current_stream(self.dev))
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        if self.events is not None:
            self.events[1].record(torch.cuda.current_stream(self.dev))
            self.rec._phases[self.key].append(self.events)
        elif self.phase:
            self.rec._phases[self.key].append(1e3 * dt)
        self.rec.host_s[self.key].append(dt)
        self.fn.__exit__(*exc)
        return False


def span(name: str):
    """A named host span; see the module's docstring."""
    rec = active()
    return _NULL if rec is None else _Span(rec, name)


def phase(name: str, like):
    """A span timed on the device of `like` (a tensor or device): CUDA
    events there, the host clock on the CPU."""
    rec = active()
    if rec is None:
        return _NULL
    dev = like if isinstance(like, torch.device) else like.device
    return _Span(rec, name, True, dev if dev.type == "cuda" else None)
