#!/usr/bin/env python3
"""Where one learner train step of the port spends its time on the card.

    python3 tools/profile_learner.py [--steps 10]

For tleague-policy-s (random weights from a seed), the two train steps
`chip_smoke.py` drives: the env step (PPO + GAE over 32 x 16 rows of
26-token observations, bf16 compute) and the sequence step (V-trace over
4096 tokens, every layer local with window 512, softcap 30, fp32, remat).
Gives the step's wall time on the host clock, and from `torch.profiler`
the device time by kernel, the device ops per step and the device's idle
share. Busy time and wall time both come from the profiled window:
idle share = 1 - (device busy time summed over the profiled steps) / (host
wall time of those steps). The profiler slows the host, so the line also
gives its overhead: the profiled steps' median wall time over the
unprofiled ones'. Prints one JSON line per step kind, then one short digest
line. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


# the port's own kernels, by a part of their names
PORT_KERNELS = ("rmsnorm", "scan", "flash_fwd", "bwd_dq", "bwd_dkv")


def port_kernels(dev, n):
    """[name, launches, device ms] per step of each of the port's own
    kernels among the profiler's device events `dev` over n steps."""
    return [[e.key[:80], e.count / n, e.self_device_time_total / 1e3 / n] for e in dev
            if any(k in e.key for k in PORT_KERNELS)]


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_learner: needs a CUDA card", file=sys.stderr)
        return 2
    from chip_smoke import ENV_B, ENV_T, NUM_ACTIONS, SEQ_T, env_batch, seq_batch, seq_config
    from repro_torch.configs import get_arch
    from repro_torch.learners import build_env_train_step, build_seq_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import adamw

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    rows = []
    for which in ("env", "seq"):
        opt = adamw(3e-4, clip_norm=1.0)
        if which == "env":
            cfg = get_arch("tleague-policy-s")
            step = build_env_train_step(cfg, NUM_ACTIONS, opt)
            batch = env_batch(rng, ENV_B, ENV_T, "cuda")
        else:
            cfg = seq_config(get_arch)
            step = build_seq_train_step(cfg, opt, loss="vtrace", remat=True)
            batch = seq_batch(rng, SEQ_T, cfg.vocab_size, "cuda")
        params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
        state = opt.init(params)

        def one_step():
            nonlocal params, state
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, _ = step(params, state, batch)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        for _ in range(3):
            one_step()
        wall = [one_step() for _ in range(args.steps)]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            prof_wall = [one_step() for _ in range(args.steps)]
            prof_s = time.perf_counter() - t0
        dev = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_us = sum(e.self_device_time_total for e in dev)
        launches = sum(e.count for e in dev)
        top = sorted(dev, key=lambda e: -e.self_device_time_total)[:10]
        n = args.steps
        median_ms = 1e3 * statistics.median(wall)
        median_prof_ms = 1e3 * statistics.median(prof_wall)
        row = {
            "step": which, "arch": cfg.name, "compute_dtype": cfg.compute_dtype,
            "batch": [ENV_B, ENV_T, 26] if which == "env" else [1, SEQ_T],
            "device": torch.cuda.get_device_name(0),
            "median_step_ms": median_ms,
            "median_step_ms_profiled": median_prof_ms,
            "profiler_overhead_x": median_prof_ms / median_ms,
            "profiled_window_s": prof_s,
            "device_busy_ms_per_step": busy_us / 1e3 / n if busy_us else None,
            "device_ops_per_step": launches / n,
            "idle_share": (1 - busy_us / 1e6 / prof_s) if busy_us else None,
            "port_kernels": port_kernels(dev, n),
            "top_device_ops": [{"name": e.key[:80], "count_per_step": e.count / n,
                                "ms_per_step": e.self_device_time_total / 1e3 / n}
                               for e in top],
        }
        rows.append(row)
        print(json.dumps(row), flush=True)
    keys = ("median_step_ms", "median_step_ms_profiled", "device_busy_ms_per_step",
            "device_ops_per_step", "idle_share")
    print(json.dumps({"digest": {r["step"]: [r[k] for k in keys] for r in rows},
                      "keys": keys}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
