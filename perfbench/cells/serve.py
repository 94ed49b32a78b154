"""Runner of the `serve` traffic kind: actors in a closed loop on one
in-process InfServer, driven through `submit` and `get` as the collector
drives it.

Set-up (counted in `setup_s` from the process's start): the port's kernels
built or loaded, the weights drawn on the device from the seed and hosted
by `InfServer(cfg, num_actions, params, max_batch)`, a pool of
`pool_rounds` rounds of observations drawn on the host from the seed (each
actor's `slots` rows of `obs_len` ids, uniform over the env's
`obs_vocab` ids, as the env's observations are), and `warm_rounds` rounds
served to warm the flush's one shape.

A round: each of the `actors` actors submits its rows, the last submit
fills the `max_batch`-row flush and runs it, then each actor `get`s its
actions. A request's latency runs from its `submit` to the return of its
`get`. Window: rounds from the pool in turn until `seconds` have passed.
`infer_rows_per_s` is every answered row over the window's seconds and
`infer_p95_ms` the 95th percentile (nearest rank) of every request's
latency; a request that fails counts as 1e9 ms.

Traced (`--trace 1`): `trace_rounds` rounds under the profiler with the
harness's spans.

Check: once the port's state is freed, `check_rounds` of the window's
rounds (drawn from the seed, the last one among them) are served again by
the plain reference (`reference/serve.py`), whole flush by whole flush.
"""
from __future__ import annotations

import math
import random
import time

import numpy as np
import torch

from perfbench import trace as TR
from perfbench import weights as W
from perfbench import work
from perfbench.harness import Outcome, phase
from perfbench.reference import serve as RS

FAILED_MS = 1e9


def observations(cell):
    tr = cell.traffic
    rng = np.random.default_rng(W.derive(cell.seed, "obs"))
    return rng.integers(0, tr["obs_vocab"], (tr["pool_rounds"], tr["actors"], tr["slots"],
                                             tr["obs_len"]), dtype=np.int64)


def serve_round(server, obs):
    """One round of every actor: (latencies ms, (actions, logp, values) of
    every row in submit order or None, failures)."""
    t_sub, tickets, lat, parts, failed = [], [], [], [], 0
    for rows in obs:
        t_sub.append(time.perf_counter())
        try:
            tickets.append(server.submit(rows))
        except Exception:                       # noqa: BLE001 - a failed request
            tickets.append(None)
    for t0, tk in zip(t_sub, tickets):
        try:
            if tk is None:
                raise RuntimeError("submit failed")
            parts.append(server.get(tk))
            lat.append((time.perf_counter() - t0) * 1e3)
        except Exception:                       # noqa: BLE001
            lat.append(FAILED_MS)
            parts.append(None)
            failed += 1
    if failed:
        return lat, None, failed
    return lat, tuple(np.concatenate([p[i] for p in parts]) for i in range(3)), 0


def p95(values):
    s = sorted(values)
    return s[max(math.ceil(0.95 * len(s)) - 1, 0)]


def run(cell) -> Outcome:
    from repro_torch.infserver import InfServer
    from repro_torch.kernels import _build

    dev, cfg, tr = cell.device, cell.cfg, cell.traffic
    if dev.type == "cuda":
        _build.library()
        torch.zeros(1, device=dev)              # the allocator, before its peak is reset
        torch.cuda.reset_peak_memory_stats(dev)
    from repro_torch import models
    W.check_layout(cfg, cell.arch, models.init_params)
    phase(cell, "kernels")
    params = W.program_tree(cfg, W.make(cfg, cell.seed, dev))
    pool = observations(cell)
    server = InfServer(cell.arch, tr["num_actions"], params, device=dev,
                       max_batch=tr["max_batch"], seed=W.derive(cell.seed, "server"))
    del params
    phase(cell, "weights")
    for i in range(tr["warm_rounds"]):
        serve_round(server, pool[i % len(pool)])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    phase(cell, "warm rounds")

    rows = tr["actors"] * tr["slots"]
    if rows != tr["max_batch"]:
        raise ValueError("a round must fill exactly one flush")
    lat, served, failed = [], [], 0
    metrics, summary = {}, None
    i = tr["warm_rounds"]
    if cell.trace:
        b0, l0 = server.batches_run, server._latency_sum
        with TR.profiled(dev) as (_, prof):
            for _ in range(tr["trace_rounds"]):
                with TR.unit():
                    la, res, f = serve_round(server, pool[i % len(pool)])
                lat += la
                served.append((i % len(pool), res))
                failed += f
                i += 1
        flushes = server.batches_run - b0
        summary = TR.summarize(prof.events())
        summary.update(kind="serve", flushes=flushes,
                       flush_s=(server._latency_sum - l0) / max(flushes, 1),
                       required_flops_per_flush=work.serve_flush_flops(
                           cfg, rows, tr["obs_len"], tr["num_actions"]))
    else:
        b0 = server.batches_run
        t0 = time.perf_counter()
        setup_s = t0 - cell.t_start
        while time.perf_counter() - t0 < cell.seconds:
            la, res, f = serve_round(server, pool[i % len(pool)])
            lat += la
            served.append((i % len(pool), res))
            failed += f
            i += 1
        wall = time.perf_counter() - t0
        answered = sum(rows for _, res in served if res is not None)
        metrics = {"infer_rows_per_s": answered / wall, "infer_p95_ms": p95(lat),
                   "setup_s": setup_s}
        if server.batches_run - b0 != len(served):
            raise RuntimeError("each round must run exactly one flush")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del server
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    phase(cell, "window closed")
    pick = random.Random(W.derive(cell.seed, "check"))
    idx = sorted(set(pick.sample(range(len(served) - 1), min(tr["check_rounds"] - 1,
                                                           len(served) - 1)))
                 | {len(served) - 1})
    chosen = [served[j] for j in idx]
    if any(res is None for _, res in chosen):
        checks = {"logp": float("nan"), "value": float("nan"), "bad_actions": float("nan")}
    else:
        ref = RS.readings(cfg, cell.seed, [pool[p].reshape(rows, -1) for p, _ in chosen],
                          tr["num_actions"], dev)
        checks = RS.compare([res for _, res in chosen], ref)
    phase(cell, "reference")
    return Outcome(attempted=len(lat), failed=failed, metrics=metrics, checks=checks,
                   memory_peak=peak, summary=summary)
