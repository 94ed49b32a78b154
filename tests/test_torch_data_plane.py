"""The port's replay plane against the JAX package's, on the CPU.

The same segments (made from a seed with numpy) and the same seed go into
`repro.learners.DataServer` and `repro_torch.learners.DataServer`
(`device="cpu"`). Both are numpy rings drawn by numpy generators, so the
samples, the sample info (slots, overwrite generations, importance
weights), the priority write-back counts and the throughput counters are
held equal bitwise, for each sampler. The segments' keys are inserted out
of sorted order: both servers lay the ring out in `jax.tree_util`'s (sorted)
order.
"""
import threading

import numpy as np
import pytest
import torch

from repro.learners import DataServer as JaxDataServer
from repro_torch.core import LeagueMgr
from repro_torch.learners import DataServer, Learner
from repro_torch.optim import adamw

ROWS, T, OBS = 4, 3, 5
COUNTERS = ("prefetch_hits", "prefetch_misses", "repeat_ratio")


def _segment(rng, rows=ROWS, t=T):
    """Keys in insertion order obs, rewards, actions, done, bootstrap_value;
    sorted order starts with actions."""
    return {"obs": rng.integers(0, 16, (rows, t, OBS)).astype(np.int32),
            "rewards": rng.normal(size=(rows, t)).astype(np.float32),
            "actions": rng.integers(0, 6, (rows, t)).astype(np.int32),
            "done": rng.random((rows, t)) < 0.3,
            "bootstrap_value": rng.normal(size=(rows,)).astype(np.float32)}


def _host(batch):
    return {k: np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in batch.items()}


def _assert_same_batch(got, want):
    got, want = _host(got), _host(want)
    assert list(got) == sorted(want)          # served in jax.tree_util's order
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _assert_same_info(t, j):
    ti, ji = t.last_sample_info(), j.last_sample_info()
    np.testing.assert_array_equal(ti["slots"], ji["slots"])
    np.testing.assert_array_equal(ti["gen"], ji["gen"])
    if ji["weights"] is None:
        assert ti["weights"] is None
    else:
        np.testing.assert_array_equal(ti["weights"], ji["weights"])


def _pair(**kw):
    return JaxDataServer(**kw), DataServer(device="cpu", **kw)


@pytest.mark.parametrize("sampler", ["uniform", "prioritized", "episode"])
def test_off_policy_samples_match_jax(sampler):
    """12 segments into a 5-segment ring (so it wraps), drawn by host
    `sample` and by `sample_to_device` (prefetched, invalidated by each put
    and by priority write-backs), with priorities pushed back each round."""
    j, t = _pair(capacity_frames=5 * ROWS * T, seed=3, blocking=False, sampler=sampler)
    rng = np.random.default_rng(0)
    for i in range(12):
        seg = _segment(rng)
        j.put(seg, source=i % 2)
        t.put(seg, source=i % 2)
        _assert_same_batch(t.sample(6), j.sample(6))
        _assert_same_info(t, j)
        for _ in range(2):                   # the second draw is a prefetch hit
            _assert_same_batch(t.sample_to_device(6), j.sample_to_device(6))
            _assert_same_info(t, j)
        info = t.last_sample_info()
        prio = rng.random(len(info["slots"])) * 3
        assert (t.update_priorities(info["slots"], torch.from_numpy(prio), gen=info["gen"])
                == j.update_priorities(info["slots"], prio, gen=info["gen"]))
    tt, jt = t.throughput(), j.throughput()
    assert {k: tt[k] for k in COUNTERS} == {k: jt[k] for k in COUNTERS}
    assert (t.frames_received, t.frames_consumed, t.num_rows, t.unconsumed_frames) == \
        (j.frames_received, j.frames_consumed, j.num_rows, j.unconsumed_frames)
    assert tt["prefetch_hits"] > 0 and tt["prefetch_misses"] > 0


def test_stale_generations_are_dropped_alike():
    """A priority write-back quoting slots overwritten since the sample
    updates nothing, in both servers."""
    j, t = _pair(capacity_frames=2 * ROWS * T, seed=1, blocking=False, sampler="prioritized")
    rng = np.random.default_rng(1)
    seg = _segment(rng)
    j.put(seg)
    t.put(seg)
    t.sample(ROWS)
    j.sample(ROWS)
    info = t.last_sample_info()
    for _ in range(2):                       # the ring moves past every slot
        seg = _segment(rng)
        j.put(seg)
        t.put(seg)
    prio = np.ones(ROWS)
    assert t.update_priorities(info["slots"], prio, gen=info["gen"]) == \
        j.update_priorities(info["slots"], prio, gen=info["gen"]) == 0


def test_blocking_on_policy_stages_at_put():
    """Blocking mode: the newest segment is served once per put, staged at
    the put (every `sample_to_device` is a prefetch hit), and equals the
    segment as it was put."""
    j, t = _pair(capacity_frames=3 * ROWS * T, seed=0)
    rng = np.random.default_rng(2)
    for _ in range(5):
        seg = _segment(rng)
        j.put(seg)
        t.put(seg)
        assert t.ready() and j.ready()
        got = t.sample_to_device()
        _assert_same_batch(got, j.sample_to_device())
        _assert_same_batch(got, seg)
        _assert_same_info(t, j)
        assert not t.ready() and not j.ready()
    assert t.prefetch_hits == j.prefetch_hits == 5 and t.prefetch_misses == 0


def test_sample_to_device_on_cpu_equals_sample():
    """Two servers fed alike: `sample_to_device` gives `sample`'s rows as
    CPU tensors the caller owns (a later put does not change them)."""
    a = DataServer(device="cpu", seed=4, blocking=False, capacity_frames=4 * ROWS * T)
    b = DataServer(device="cpu", seed=4, blocking=False, capacity_frames=4 * ROWS * T,
                   prefetch=False)
    rng = np.random.default_rng(3)
    for _ in range(3):
        seg = _segment(rng)
        a.put(seg)
        b.put(seg)
    dev = a.sample_to_device(5)
    assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu" for v in dev.values())
    want = b.sample(5)
    _assert_same_batch(dev, want)
    before = _host(dev)
    for _ in range(4):
        seg = _segment(rng)
        a.put(seg)
    _assert_same_batch(dev, before)


def test_ring_wraparound_keeps_content_and_accounting():
    """Segments of 3 rows into a 7-row ring: the writes straddle the end,
    and every row reads back as it was put, in both servers."""
    j, t = _pair(capacity_frames=7 * T, seed=0, blocking=False)
    rng = np.random.default_rng(4)
    segs = [_segment(rng, rows=3) for _ in range(5)]
    for seg in segs:
        j.put(seg)
        t.put(seg)
    assert t.num_rows == j.num_rows == 7 and t._head == j._head == 1
    live = {k: np.concatenate([s[k] for s in segs])[-7:] for k in segs[0]}
    slots = (np.arange(-7, 0) + t._head) % 7
    for buf, jbuf, k in zip(t._buffers, j._buffers, sorted(live)):
        np.testing.assert_array_equal(buf, jbuf)
        np.testing.assert_array_equal(buf[slots], live[k])


def test_put_when_room_backpressure_with_a_consumer_thread():
    """A one-segment ring: the producer's `put_when_room` waits for the
    learner thread to consume, so every segment is consumed exactly once,
    in order; without a consumer it times out and writes nothing."""
    for server in _pair(capacity_frames=ROWS * T, seed=0):
        rng = np.random.default_rng(5)
        segs = [_segment(rng) for _ in range(8)]
        got, errors = [], []

        def consume():
            try:
                for _ in segs:
                    assert server.wait_ready(timeout=10.0)
                    got.append(_host(server.sample_to_device()))
            except Exception as e:                      # reported below
                errors.append(e)

        th = threading.Thread(target=consume)
        th.start()
        assert all(server.put_when_room(s, timeout=10.0) for s in segs)
        th.join(timeout=30.0)
        assert not th.is_alive() and not errors, errors
        assert len(got) == len(segs)
        for g, s in zip(got, segs):
            _assert_same_batch(g, s)
        assert server.frames_received == server.frames_consumed == 8 * ROWS * T
        assert server.put_when_room(segs[0], timeout=5.0)
        assert not server.put_when_room(segs[1], timeout=0.05)
        assert server.frames_received == 9 * ROWS * T


def test_structure_change_is_rejected():
    t = DataServer(device="cpu")
    rng = np.random.default_rng(6)
    t.put(_segment(rng))
    bad = _segment(rng)
    bad["extra"] = np.zeros((ROWS,), np.float32)
    with pytest.raises(AssertionError, match="structure changed"):
        t.put(bad)


def test_data_server_and_learner_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        DataServer()
    league = LeagueMgr()
    params = {"w": torch.zeros(2)}
    league.add_learning_agent("main", params)
    with pytest.raises(RuntimeError, match="CUDA"):
        Learner(league, None, adamw(1e-3), params)
    assert DataServer(device="cpu").device.type == "cpu"
    assert Learner(league, None, adamw(1e-3), params, device="cpu").device.type == "cpu"
