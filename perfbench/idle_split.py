#!/usr/bin/env python3
"""A traced run of a serve cell whose device idle is split by the port's
own spans: each idle gap of the traced window goes, part by part, to the
InfServer's step span (`repro_torch.infserver.pad`, `.h2d`, `.forward`,
`.d2h`, `.scatter`) open over that part, to the flush span between its
steps, or to the time outside the program; a gap whose middle falls in
the profiler's own buffer request goes to that.

    python3 perfbench/idle_split.py --workload <serve cell> --seed <n> --seconds <s> --trace 1

It prints the run's own lines, then one line `idle_split {...}`: the
window's ms, its flushes, the idle ms, and each part's idle ms a flush.
"""
import collections
import json
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench import harness  # noqa: E402
from perfbench import trace as TR  # noqa: E402

FLUSH = "repro_torch.infserver.flush#"
STEP = "repro_torch.infserver."
BUFFER = "Activity Buffer Request"


def _overlap(a, b, e):
    return max(0.0, min(b, e.time_range.end) - max(a, e.time_range.start))


def split(events) -> dict:
    """The idle split of a traced serve window's profiler events (µs in,
    ms out)."""
    import torch
    cpu = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    dev = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)
           and not e.name.startswith((TR.SPAN, "repro_torch."))]
    units = [e for e in cpu if e.name == TR.UNIT]
    t0 = min(u.time_range.start for u in units)
    iv = [(max(e.time_range.start, t0), e.time_range.end) for e in dev if e.time_range.end > t0]
    t1 = max([u.time_range.end for u in units] + [e for _, e in iv])
    flushes = [e for e in cpu if e.name.startswith(FLUSH)]
    steps = [e for e in cpu if e.name.startswith(STEP) and e not in flushes]
    buf = [e for e in cpu if e.name == BUFFER]
    parts = collections.Counter()
    for a, b in TR._gaps(iv, t0, t1):
        mid = (a + b) / 2
        if any(e.time_range.start <= mid <= e.time_range.end for e in buf):
            parts["profiler buffer request"] += (b - a) / 1e3
            continue
        in_flush = sum(_overlap(a, b, e) for e in flushes)
        in_steps = 0.0
        for e in steps:
            parts[e.name] += _overlap(a, b, e) / 1e3
            in_steps += _overlap(a, b, e)
        parts["repro_torch.infserver.flush (between its steps)"] += (in_flush - in_steps) / 1e3
        parts["outside the program"] += ((b - a) - in_flush) / 1e3
    n = len(units)
    return {"window_ms": (t1 - t0) / 1e3, "flushes": n, "idle_ms": sum(parts.values()),
            "per_flush_ms": {k: v / n for k, v in parts.most_common()}}


def main(argv) -> int:
    kept = []
    summarize = TR.summarize

    def keep(events):
        kept.append(list(events))
        return summarize(events)

    TR.summarize = keep
    try:
        rc = harness.main(argv, T_START)
    finally:
        TR.summarize = summarize
    if rc == 0 and kept:
        print("idle_split", json.dumps(split(kept[-1])))
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
