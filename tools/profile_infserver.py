#!/usr/bin/env python3
"""Where one InfServer flush of the port spends its time on the card.

    python3 tools/profile_infserver.py [--flushes 20]

For tleague-policy-s and tleague-policy-m at a full 256-row flush of
26-token observations (random weights from a seed), single-model and
grouped (theta + phi): the flush's wall time on the host clock, and from
`torch.profiler` the device time by kernel, the kernel launches per flush
and the device's idle share. Busy time and wall time both come from the
profiled window: idle share = 1 - (device busy time summed over the
profiled flushes) / (host wall time of those flushes). The profiler slows
the host, so the line also gives its overhead: the profiled flushes'
median wall time over the unprofiled ones'. Prints one JSON line per
(arch, flush kind), then one short digest line. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

ROWS, OBS_LEN, ACTORS = 256, 26, 8


# the port's own kernels, by a part of their names
PORT_KERNELS = ("rmsnorm", "scan", "flash_fwd", "bwd_dq", "bwd_dkv")


def port_kernels(dev, n):
    """[name, launches, device ms] per flush of each of the port's own
    kernels among the profiler's device events `dev` over n flushes."""
    return [[e.key[:80], e.count / n, e.self_device_time_total / 1e3 / n] for e in dev
            if any(k in e.key for k in PORT_KERNELS)]


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_infserver: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.configs import get_arch
    from repro_torch.infserver import InfServer
    from repro_torch.models import init_params

    ap = argparse.ArgumentParser()
    ap.add_argument("--flushes", type=int, default=20)
    args = ap.parse_args()
    rng = np.random.default_rng(0)
    rows = []
    for arch in ("tleague-policy-s", "tleague-policy-m"):
        cfg = get_arch(arch)
        gen = torch.Generator(device="cuda").manual_seed(0)
        server = InfServer(cfg, 6, init_params(gen, cfg), max_batch=ROWS)
        server.register_model("phi", init_params(gen, cfg))
        for kind, models in (("single", [None] * ACTORS),
                             ("grouped", [None] * 4 + ["phi"] * 4)):
            obs = rng.integers(0, cfg.vocab_size, (ACTORS, ROWS // ACTORS, OBS_LEN))

            def one_flush():
                tickets = [server.submit(obs[i], model=models[i]) for i in range(ACTORS)]
                for t in tickets:
                    server.get(t)
                return server.last_batch_latency_s

            for _ in range(3):
                one_flush()
            wall = [one_flush() for _ in range(args.flushes)]
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                prof_wall = [one_flush() for _ in range(args.flushes)]
                torch.cuda.synchronize()
                prof_s = time.perf_counter() - t0
            dev = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
            busy_us = sum(e.self_device_time_total for e in dev)
            launches = sum(e.count for e in dev)
            top = sorted(dev, key=lambda e: -e.self_device_time_total)[:8]
            n = args.flushes
            median_ms = 1e3 * statistics.median(wall)
            median_prof_ms = 1e3 * statistics.median(prof_wall)
            row = {
                "arch": arch, "flush": kind, "rows": ROWS, "obs_len": OBS_LEN,
                "device": torch.cuda.get_device_name(0),
                "median_flush_ms": median_ms,
                "median_flush_ms_profiled": median_prof_ms,
                "profiler_overhead_x": median_prof_ms / median_ms,
                "profiled_window_s": prof_s,
                "device_busy_ms_per_flush": busy_us / 1e3 / n if busy_us else None,
                "device_ops_per_flush": launches / n,
                "idle_share": (1 - busy_us / 1e6 / prof_s) if busy_us else None,
                "port_kernels": port_kernels(dev, n),
                "top_device_ops": [{"name": e.key[:80], "count_per_flush": e.count / n,
                                    "ms_per_flush": e.self_device_time_total / 1e3 / n}
                                   for e in top],
            }
            rows.append(row)
            print(json.dumps(row), flush=True)
    keys = ("median_flush_ms", "median_flush_ms_profiled", "device_busy_ms_per_flush",
            "device_ops_per_flush", "idle_share")
    print(json.dumps({"digest": {f"{r['arch']}/{r['flush']}": [r[k] for k in keys]
                                 for r in rows}, "keys": keys}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
