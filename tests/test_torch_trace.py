"""The port's own tracing (`repro_torch/utils/trace.py`) on the CPU.

Off (no profiler), a span is one shared null context and nothing is
recorded. On, under `torch.profiler`, the spans appear in the trace and
record into `trace.profiled`, on the threads the profiler records, and a
new profiler session starts it empty. An InfServer flush is `infserver.flush#<n>` over its
pad, h2d, forward, d2h and scatter spans in that order, and the
queue-wait counters hold the waits a test clocks around the submits; a
learner step is its four phases once each and in order; a MoE forward is
three MoE phases a layer and one `model.head`.
"""
import dataclasses
import time

import numpy as np
import pytest
import torch

from repro_torch import learners, optim
from repro_torch.configs import get_arch
from repro_torch.infserver import InfServer
from repro_torch.models import forward_train, init_params
from repro_torch.rl.vtrace_loss import VTraceConfig
from repro_torch.utils import trace

A, L_OBS = 6, 26
SERVER = ("pad", "h2d", "forward", "d2h", "scatter")
STEP = ("learner.forward", "learner.backward", "optim.norm", "optim.update")


def _params(cfg, seed=0):
    return init_params(torch.Generator().manual_seed(seed), cfg)


def _server(max_batch=64):
    cfg = dataclasses.replace(get_arch("tleague-policy-s"), compute_dtype="float32")
    return InfServer(cfg, A, _params(cfg), device="cpu", max_batch=max_batch)


def _obs(rng, n):
    return rng.integers(0, 512, (n, L_OBS)).astype(np.int32)


def _step(inplace):
    cfg = dataclasses.replace(get_arch("tleague-policy-s"), compute_dtype="float32")
    opt = optim.adamw(1e-3, clip_norm=1.0, inplace=inplace)
    step = learners.build_seq_train_step(cfg, opt, hp=VTraceConfig(), loss="vtrace")
    g = torch.Generator().manual_seed(1)
    B, T = 2, 12
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, T), generator=g),
             "actions": torch.randint(0, cfg.vocab_size, (B, T), generator=g),
             "behavior_logp": -torch.rand((B, T), generator=g) * 6,
             "behavior_values": torch.randn((B, T), generator=g),
             "rewards": torch.randn((B, T), generator=g),
             "discounts": torch.full((B, T), 0.99),
             "bootstrap_value": torch.randn((B,), generator=g)}
    params = _params(cfg)
    return lambda: step(params, opt.init(params), batch)


@pytest.fixture(autouse=True)
def _off_between_sessions():
    """Each test's profiler session follows a span opened without one, as a
    traced window follows its warm-up: so it starts `trace.profiled` afresh."""
    assert trace.active() is None


def _program_events(prof, prefix=trace.PREFIX):
    """The program's span events of a CPU profile, by start time."""
    evs = [e for e in prof.events() if e.name.startswith(prefix)]
    return sorted(evs, key=lambda e: e.time_range.start)


def test_off_a_span_is_one_shared_null_and_nothing_is_recorded():
    trace.profiled.clear()
    assert trace.active() is None
    assert trace.span("a") is trace.span("b") is trace.phase("c", torch.zeros(1))
    server = _server()
    server.submit(_obs(np.random.default_rng(0), 4))
    server.flush()
    _step(inplace=True)()
    assert not trace.profiled.host_s and not trace.profiled.queue_waits_s


def test_a_profiler_session_starts_afresh_on_the_threads_it_records():
    import threading
    with torch.profiler.profile():
        with trace.span("x#3"):
            pass
    assert trace.active() is None and list(trace.profiled.host_s) == ["x"]
    with torch.profiler.profile():
        seen = []

        def other():
            seen.append(trace.active())
            with trace.span("y"):
                pass
        t = threading.Thread(target=other)
        t.start()
        t.join()
        assert seen == [None]                       # a thread the profiler does not record
        with trace.span("y"):
            pass
    assert list(trace.profiled.host_s) == ["y"]
    trace.profiled.clear()


def test_a_flush_is_its_five_spans_in_order():
    server = _server(max_batch=64)
    rng = np.random.default_rng(1)
    server.submit(_obs(rng, 8))
    server.flush()                                    # flush 0, untraced
    with torch.profiler.profile() as prof:
        tickets = [server.submit(_obs(rng, n)) for n in (5, 7, 4)]
        server.flush()                                # flush 1
    rec = trace.profiled
    evs = _program_events(prof, trace.PREFIX + "infserver.")
    flush = [e for e in evs if e.name.startswith(trace.PREFIX + "infserver.flush#")]
    assert [e.name for e in flush] == [trace.PREFIX + "infserver.flush#1"]
    inside = [e.name[len(trace.PREFIX + "infserver."):] for e in evs
              if flush[0].time_range.start <= e.time_range.start
              and e.time_range.end <= flush[0].time_range.end and e is not flush[0]]
    assert tuple(inside) == SERVER
    assert len(rec.host_s["infserver.flush"]) == 1 and len(rec.queue_waits_s) == 3
    assert all(len(rec.host_s["infserver." + s]) == 1 for s in SERVER)
    assert all(server.get(t)[0].shape == (t.rows,) for t in tickets)


def test_queue_wait_counters_hold_the_waits_clocked_by_hand():
    server = _server(max_batch=64)
    rng = np.random.default_rng(2)
    spans = []                                        # (before, after) each submit
    with torch.profiler.profile():
        for n in (3, 5, 2):
            t0 = time.perf_counter()
            server.submit(_obs(rng, n))
            spans.append((t0, time.perf_counter()))
            time.sleep(0.02)
        f0 = time.perf_counter()
        server.flush()
        f1 = time.perf_counter()
    waits = trace.profiled.queue_waits_s
    assert len(waits) == 3
    for w, (s0, s1) in zip(waits, spans):
        assert f0 - s1 <= w <= f1 - s0               # flush start - submit, as clocked
    assert waits[0] > waits[1] > waits[2]
    st = server.stats()
    assert st["mean_queue_wait_ms"] == pytest.approx(1e3 * sum(waits) / 3)
    assert st["max_queue_wait_ms"] == pytest.approx(1e3 * max(waits))
    assert server.telemetry()["mean_queue_wait_ms"] == st["mean_queue_wait_ms"]


@pytest.mark.parametrize("inplace", [False, True])
def test_a_learner_step_is_its_four_phases_once_each_in_order(inplace):
    step = _step(inplace)
    with torch.profiler.profile() as prof:
        step()
    rec = trace.profiled
    names = [e.name[len(trace.PREFIX):] for e in _program_events(prof)]
    assert tuple(n for n in names if n in STEP) == STEP
    for name in STEP:
        ms = rec.phase_ms(name)
        assert len(ms) == 1 and ms[0] > 0
    assert rec.phase_ms("model.head") and names.count("model.head") == 1


def test_a_moe_forward_is_three_moe_phases_a_layer_and_one_head():
    cfg = dataclasses.replace(get_arch("qwen3-moe-235b-a22b").smoke(), compute_dtype="float32")
    params = _params(cfg)
    tokens = torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(3))
    with torch.profiler.profile() as prof:
        forward_train(params, cfg, {"tokens": tokens})
    rec = trace.profiled
    names = [e.name[len(trace.PREFIX):] for e in _program_events(prof)]
    moe = [n for n in names if n.startswith("moe.")]
    assert moe == ["moe.route", "moe.experts", "moe.combine"] * cfg.num_layers
    assert names.count("model.head") == 1 and names[-1] == "model.head"
    for name in ("moe.route", "moe.experts", "moe.combine"):
        assert len(rec.phase_ms(name)) == cfg.num_layers


def test_under_the_profiler_the_spans_record_into_profiled():
    server = _server(max_batch=8)
    trace.profiled.clear()
    with torch.profiler.profile() as prof:
        assert trace.active() is trace.profiled
        server.submit(_obs(np.random.default_rng(4), 8))     # fills the flush
    assert trace.active() is None
    names = {e.name for e in _program_events(prof)}
    assert trace.PREFIX + "infserver.flush#0" in names
    assert len(trace.profiled.host_s["infserver.flush"]) == 1
    assert len(trace.profiled.queue_waits_s) == 1
    trace.profiled.clear()
