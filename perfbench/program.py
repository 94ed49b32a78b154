"""What the port records about itself over a traced window: the readers of
the program's own spans and counters (`metrics/*.py`, source
`program_span` or `program_counter`) take it from here.

While `torch.profiler` runs, the port's tracing (`repro_torch/utils/trace.py`)
is on and writes to its process-wide recorder `trace.profiled`: each
phase's device milliseconds (a CUDA event pair on the stream), each span's
host seconds, and the InfServer's queue waits. The cells profile only
their traced window, so what it holds is that window's. A port without
that module gives nothing, and so does a window that recorded nothing.
"""
from __future__ import annotations


def recorder(summary, kind):
    """The port's recorder for a traced summary of `kind`, or None."""
    if not summary or summary.get("kind") != kind:
        return None
    try:
        from repro_torch.utils import trace
    except ImportError:
        return None
    return trace.profiled


def mean_phase_ms(summary, name):
    """The mean milliseconds of a learner step's phase over the window's calls."""
    rec = recorder(summary, "learn")
    ms = rec.phase_ms(name) if rec else []
    return sum(ms) / len(ms) if ms else None


def flushes(rec) -> int:
    return len(rec.host_s.get("infserver.flush", ()))


def phase_ms_per_flush(summary, *names):
    """The milliseconds of the named phases summed over the window, per flush."""
    rec = recorder(summary, "serve")
    if not rec or not flushes(rec):
        return None
    ms = [m for n in names for m in rec.phase_ms(n)]
    return sum(ms) / flushes(rec) if ms else None


def host_ms_per_flush(summary, *names):
    """The host milliseconds of the named spans summed over the window, per flush."""
    rec = recorder(summary, "serve")
    if not rec or not flushes(rec):
        return None
    s = [t for n in names for t in rec.host_s.get(n, ())]
    return 1e3 * sum(s) / flushes(rec) if s else None
