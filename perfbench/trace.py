"""Spans around the port's layers, and the reduction of a `torch.profiler`
trace to the numbers the per-layer metrics read.

Spans are recorded from the benchmark's own files: `install` wraps the
module attributes `dispatch.attention`, `dispatch.rmsnorm` and
`moe.moe_apply`, which the models call through their modules, in a
`record_function` named `perfbench.<span>#<call>`, and keeps each
attention call's shapes by its call number. A kernel launched while a span
is open on its thread belongs to that span (the profiler links a launch
to the innermost open op), so the span's device time is that of whatever
implements the call. The backward of a call is found by the autograd
sequence numbers of the ops inside its span: the backward nodes that
carry the same number and name the span's thread as their forward thread.
(Sequence numbers count per thread, and a remat recompute runs on the
autograd engine's thread, so a number alone would match the wrong ops.)

`summarize` reads, over the traced window (from the first unit span's
start to the end of the last device activity after it): the union of
device intervals (`busy_s`), each span's calls and device seconds, the
device operations that took most time, and the longest idle gaps, each
named by the innermost host op open across its middle.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import itertools

import torch

SPAN = "perfbench."
UNIT = "perfbench.unit"


class Spans:
    """The wrappers' record: each attention call's (q shape, k shape,
    element size, causal, window) by call number."""

    def __init__(self):
        self.attention = []
        self.undo = []

    def restore(self):
        for mod, attr, fn in reversed(self.undo):
            setattr(mod, attr, fn)
        self.undo.clear()


def _wrap(spans, mod, attr, span, record=None):
    """Wrap `mod.attr` in the span; `record(*args, **kw)`, where given, is
    called with each call's arguments."""
    fn = getattr(mod, attr)
    calls = itertools.count()

    @functools.wraps(fn)
    def wrapper(*args, **kw):
        if record:
            record(*args, **kw)
        with torch.profiler.record_function(f"{SPAN}{span}#{next(calls)}"):
            return fn(*args, **kw)

    setattr(mod, attr, wrapper)
    spans.undo.append((mod, attr, fn))


def install() -> Spans:
    """Wrap the port's attention, RMSNorm and MoE entry points."""
    from repro_torch.kernels import dispatch
    from repro_torch.models import moe
    spans = Spans()

    def attention_args(q, k, v, *, scale, causal=True, window=0, cap=0.0):
        spans.attention.append(
            (tuple(q.shape), tuple(k.shape), q.element_size(), bool(causal), int(window)))

    _wrap(spans, dispatch, "attention", "attention", attention_args)
    _wrap(spans, dispatch, "rmsnorm", "rmsnorm")
    _wrap(spans, moe, "moe_apply", "moe")
    return spans


@contextlib.contextmanager
def profiled(device):
    """The harness's spans and `torch.profiler` (with the device's activity
    on CUDA) over the enclosed units; yields (spans, profiler), whose
    events are read once the block has closed."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    spans = install()
    try:
        with torch.profiler.profile(activities=acts) as prof:
            yield spans, prof
    finally:
        spans.restore()


@contextlib.contextmanager
def unit():
    """One unit of the traced window (a train step, a served round)."""
    with torch.profiler.record_function(UNIT):
        yield


def _union(intervals):
    total, end = 0.0, None
    start = None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                total += end - start
            start, end = s, e
        else:
            end = max(end, e)
    if end is not None:
        total += end - start
    return total


def _gaps(intervals, t0, t1):
    out, cur = [], t0
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if t1 > cur:
        out.append((cur, t1))
    return out


def _is_span(e):
    return e.name.startswith(SPAN) and "#" in e.name


def _under_span(c, top):
    """Whether a span lies inside another span below `top`."""
    p = c.cpu_parent
    while p is not None and p is not top:
        if _is_span(p):
            return True
        p = p.cpu_parent
    return False


def _descendants(ev):
    stack = list(ev.cpu_children)
    while stack:
        e = stack.pop()
        yield e
        stack.extend(e.cpu_children)


def summarize(events) -> dict:
    """The traced window's numbers from `prof.events()` (module docstring).
    Times in seconds."""
    cpu = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    # device work only: not the profiler's mirror of the host annotations
    dev = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)
           and not e.name.startswith(SPAN)]
    units = [e for e in cpu if e.name == UNIT]
    if not units:
        raise RuntimeError("the trace holds no unit span")
    t0 = min(u.time_range.start for u in units)
    t1 = max(u.time_range.end for u in units)
    iv = [(max(e.time_range.start, t0), e.time_range.end) for e in dev
          if e.time_range.end > t0]
    if iv:
        t1 = max(t1, max(e for _, e in iv))
    busy = _union(iv)

    spans = collections.defaultdict(lambda: {"calls": 0, "device_s": 0.0, "ids": [],
                                             "bwd_device_s": 0.0, "bwd_ids": []})
    seq_of, inside = {}, set()
    for e in cpu:
        if not _is_span(e) or e.time_range.start < t0:
            continue
        span, i = e.name[len(SPAN):].split("#")
        s = spans[span]
        s["calls"] += 1
        s["device_s"] += e.device_time_total / 1e6
        s["ids"].append(int(i))
        for c in _descendants(e):
            inside.add(id(c))
            if c.sequence_nr >= 0:
                seq_of.setdefault((c.thread, c.sequence_nr), (span, int(i)))
    # backward nodes: the outermost events of a forward op's (thread, sequence
    # number) outside every forward span, less any span recomputed inside them
    key = lambda e: (getattr(e, "fwd_thread", 0) or e.thread, e.sequence_nr)
    bwd = [e for e in cpu if e.sequence_nr >= 0 and key(e) in seq_of and id(e) not in inside
           and not _is_span(e) and e.time_range.start >= t0]
    chosen = set(map(id, bwd))
    for e in bwd:
        p = e.cpu_parent
        while p is not None and id(p) not in chosen:
            p = p.cpu_parent
        if p is not None:
            continue
        span, i = seq_of[key(e)]
        nested = sum(c.device_time_total for c in _descendants(e)
                     if _is_span(c) and not _under_span(c, e))
        spans[span]["bwd_device_s"] += (e.device_time_total - nested) / 1e6
        if i not in spans[span]["bwd_ids"]:
            spans[span]["bwd_ids"].append(i)

    by_op = collections.Counter()
    for e in dev:
        if e.time_range.start >= t0:
            by_op[e.name] += (e.time_range.end - e.time_range.start) / 1e6
    gaps = sorted(_gaps(iv, t0, t1), key=lambda g: g[0] - g[1])[:10]
    named = []
    for a, b in gaps:
        mid = (a + b) / 2
        open_ = [e for e in cpu if e.time_range.start <= mid <= e.time_range.end
                 and e.name != UNIT]
        inner = min(open_, key=lambda e: e.time_range.end - e.time_range.start, default=None)
        named.append([inner.name if inner else "host idle", (b - a) / 1e6])
    return {
        "units": len(units), "window_s": (t1 - t0) / 1e6, "busy_s": busy / 1e6,
        "spans": {k: dict(v) for k, v in spans.items()},
        "device_ops": [[n, s] for n, s in by_op.most_common(10)],
        "idle_gaps": named,
    }
