"""The port's process-boundary transport against `repro`'s, on the CPU.

Every test of `tests/test_transport.py` but the two sharded ones (ROADMAP
queue 1 item 8) runs here against `repro_torch.distributed.transport`,
with port backends (LeagueMgr, ModelPool, InfServer and DataServer on the
CPU). The codec, streaming and seam round trips run under both codecs:
msgpack, and the pickle fallback of a host without msgpack (the `codec`
fixture sets `CODEC`). Held against `repro`:

- a frame of numpy arrays and protocol types packs to the same msgpack
  bytes as `repro`'s `packb` (in-frame and streamed);
- a `repro` `ModelPoolClient` pulls from a port `RpcServer` hosting the
  port's `ModelPool`, and gets manifests equal to `repro`'s pool's for the
  same params.

The port's own parts: CPU fp32, bf16, integer and `requires_grad` tensors
arrive as numpy (bf16 as a bf16 CPU tensor), and under pickle no
`torch.Tensor` reaches the wire; the DataServer's zero-copy marks; and the
shm ring's close race made deterministic (the reader thread wins it), 50
times, with the segment gone whenever `close()` returns.

Then the transport, fault-injection and heartbeat-monitor tests of
`tests/test_robustness.py` (retry policy, endpoint rotation and failover,
`RetryableError`, `FaultPlan`, slow-vs-dead), with `repro`'s retry
delays, fault plans and fault decisions held equal to the port's, and the
heartbeat probe's command line.

Every wait has a timeout (every RPC client a 60 s socket timeout unless
a test sets one); servers and clients close in `with` blocks or
`finally`.
"""
import os
import pickle
import pickletools
import socket
import struct
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import ModelKey as JaxKey
from repro.core import ModelPool as JaxPool
from repro.distributed import transport as rtp
from repro_torch.configs import get_arch
from repro_torch.core import LeagueMgr, MatchResult, ModelKey, ModelPool
from repro_torch.core.types import FreezeGate, Hyperparam, Task
from repro_torch.distributed import transport as tp
from repro_torch.infserver import InfServer
from repro_torch.learners import DataServer
from repro_torch.models import init_params
from repro_torch.params import build_manifest
from repro_torch.utils import tree_flatten_with_path, tree_leaves, tree_map

CPU = "cpu"


@pytest.fixture(scope="module")
def cfg():
    return get_arch("tleague-policy-s")


@pytest.fixture(scope="module")
def params(cfg):
    return init_params(torch.Generator().manual_seed(0), cfg)


@pytest.fixture()
def league(params):
    lg = LeagueMgr()
    lg.add_learning_agent("main", params, gate=FreezeGate(step_gate=2))
    return lg


@pytest.fixture(autouse=True)
def _bounded_rpc_waits(monkeypatch):
    """No RPC in these tests waits forever: a client made without a socket
    timeout gets 60 s (replies owed past it fail the call)."""
    init = tp.RpcClient.__init__

    def bounded(self, address, timeout=None, *args, **kwargs):
        init(self, address, 60.0 if timeout is None else timeout, *args, **kwargs)
    monkeypatch.setattr(tp.RpcClient, "__init__", bounded)


@pytest.fixture(params=["msgpack", "pickle"])
def codec(request, monkeypatch):
    """Run the test under each codec; frames carry their codec byte, so
    the receiving side decodes whichever was sent."""
    monkeypatch.setattr(tp, "CODEC", request.param)
    return request.param


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_tree_equal(a, b):
    """Leaf by leaf in sorted-path order (a delta rebuilds its tree with
    sorted keys, as `jax.tree_util` does)."""
    fa, fb = tree_flatten_with_path(a)[0], tree_flatten_with_path(b)[0]
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (_, x), (_, y) in zip(fa, fb):
        np.testing.assert_array_equal(_np(x), _np(y))


# -- codec -------------------------------------------------------------------
def test_codec_roundtrip_protocol_types(codec):
    task = Task(ModelKey("main", 3), (ModelKey("opp", 1), ModelKey("opp", 2)),
                Hyperparam(learning_rate=1e-3), task_id=7)
    msg = {
        "task": task,
        "result": MatchResult(task.learner_key, task.opponent_keys, -1, 9),
        "gate": FreezeGate(winrate=0.6, step_gate=None),
        "arr_f32": np.arange(12, dtype=np.float32).reshape(3, 4),
        "arr_bool": np.array([True, False]),
        "nested_tuple": (1, ("a", 2.5), None),
        "pytree": {"w": np.ones((2, 2)), "b": np.zeros((2,))},
    }
    out = tp.unpackb(tp.packb(msg))
    assert out["task"] == task
    assert out["result"].outcome == -1
    assert out["gate"] == msg["gate"]
    assert out["nested_tuple"] == msg["nested_tuple"]
    assert isinstance(out["nested_tuple"], tuple)
    np.testing.assert_array_equal(out["arr_f32"], msg["arr_f32"])
    assert out["arr_f32"].dtype == np.float32
    np.testing.assert_array_equal(out["arr_bool"], msg["arr_bool"])
    np.testing.assert_array_equal(out["pytree"]["w"], msg["pytree"]["w"])


def test_codec_tensors_become_numpy(codec):
    """The counterpart of `repro`'s jax-arrays test: CPU tensors of every
    kind arrive as numpy of the same dtype and values; a bf16 tensor
    arrives as a bf16 CPU tensor with the same bits; a tensor that needs
    grad is detached. Tensors inside protocol dataclasses and tuples too."""
    gen = torch.Generator().manual_seed(1)
    w = torch.randn(3, 4, generator=gen, requires_grad=True)
    bf = torch.randn(5, 2, generator=gen).to(torch.bfloat16)
    msg = {"f32": torch.arange(6, dtype=torch.float32).reshape(2, 3),
           "grad": w, "i64": torch.tensor([1, -2, 3]), "bool": torch.tensor([True, False]),
           "scalar": torch.tensor(2.5), "strided": torch.arange(12.0).reshape(3, 4).t(),
           "bf16": bf, "tup": (torch.ones(2), "x"),
           "delta": tp.ParamDelta(manifest=build_manifest({"a": np.zeros(2)}, 0),
                                  full=True, params={"a": torch.zeros(2)})}
    out = tp.unpackb(tp.packb(msg))
    for k in ("f32", "i64", "bool", "scalar", "strided"):
        assert isinstance(out[k], np.ndarray), k
        assert out[k].dtype == msg[k].numpy().dtype and out[k].shape == tuple(msg[k].shape)
        np.testing.assert_array_equal(out[k], msg[k].numpy())
    assert isinstance(out["grad"], np.ndarray)
    np.testing.assert_array_equal(out["grad"], w.detach().numpy())
    assert isinstance(out["bf16"], torch.Tensor) and out["bf16"].dtype == torch.bfloat16
    assert out["bf16"].device.type == "cpu"
    assert torch.equal(out["bf16"].view(torch.int16), bf.view(torch.int16))
    assert isinstance(out["tup"], tuple) and isinstance(out["tup"][0], np.ndarray)
    assert isinstance(out["delta"], tp.ParamDelta)
    assert isinstance(out["delta"].params["a"], np.ndarray)
    assert w.requires_grad and msg["delta"].params["a"].dtype == torch.float32  # untouched


def test_pickle_wire_carries_no_tensor(monkeypatch):
    """Under pickle the encoder's numpy pass still runs: the frame names
    no torch class (a pickled tensor would name `torch._utils`), and a
    bf16 tensor rides as int16 words rebuilt by the port's own function."""
    monkeypatch.setattr(tp, "CODEC", "pickle")
    frame = tp.packb({"w": torch.ones(3, requires_grad=True), "b": torch.zeros(2).bfloat16(),
                      "t": (torch.arange(4),)})
    strings = [arg for op, arg, _ in pickletools.genops(frame)
               if isinstance(arg, str)]
    assert not any(s.startswith("torch") for s in strings), strings
    assert "_bf16_tensor" in strings
    out = pickle.loads(frame)
    assert isinstance(out["w"], np.ndarray) and isinstance(out["t"][0], np.ndarray)
    assert out["b"].dtype == torch.bfloat16


@pytest.mark.parametrize("streamed", [False, True])
def test_msgpack_frames_match_repro_bytes(streamed):
    """Numpy arrays and protocol types pack to `repro`'s exact bytes, in
    the frame and (above the stream threshold) as hoisted blobs."""
    rng = np.random.default_rng(4)
    big = rng.normal(size=(300, 300)).astype(np.float32)       # 360 KB: streamed

    def msg(key_cls, task_cls, result_cls, gate_cls, hyper_cls):
        key = key_cls("main", 3)
        return {"m": "pool.push", "i": 7,
                "a": [key, {"w": rng_copy["w"], "b": rng_copy["b"],
                            "big": big if streamed else big[:2]}],
                "k": {"step": 5, "task": task_cls(key, (key_cls("opp", 1),), hyper_cls(),
                                                  task_id=2),
                      "result": result_cls(key, (key,), 1, 9),
                      "gate": gate_cls(step_gate=8), "t": (1, ("a", 2.5), None),
                      "flags": np.array([True, False]), "x": np.float32(1.5),
                      "i": np.arange(5, dtype=np.int64)}}

    rng_copy = {"w": rng.normal(size=(4, 3)).astype(np.float32),
                "b": rng.integers(0, 9, (3,)).astype(np.int32)}
    from repro.core.types import FreezeGate as JGate
    from repro.core.types import Hyperparam as JHyper
    from repro.core.types import MatchResult as JResult
    from repro.core.types import Task as JTask
    ours_blobs, theirs_blobs = [], []
    ours = tp.packb(msg(ModelKey, Task, MatchResult, FreezeGate, Hyperparam), ours_blobs)
    theirs = rtp.packb(msg(JaxKey, JTask, JResult, JGate, JHyper), theirs_blobs)
    assert tp.CODEC == rtp.CODEC == "msgpack"
    assert ours == theirs
    assert len(ours_blobs) == len(theirs_blobs) == (1 if streamed else 0)
    for a, b in zip(ours_blobs, theirs_blobs):
        assert a.tobytes() == b.tobytes()


# -- per-seam RPC round trips ------------------------------------------------
def test_model_pool_seam_roundtrip(league, params, codec):
    with tp.serve_league(league) as srv:
        pool = tp.ModelPoolClient(srv.address)
        try:
            key = ModelKey("main", 0)
            pulled = pool.pull(key)
            # a first remote pull lands in fresh numpy buffers
            for a, b in zip(tree_leaves(pulled), tree_leaves(params)):
                assert isinstance(a, np.ndarray)
                np.testing.assert_array_equal(a, b.numpy())
            pool.push(key, pulled, step=5)
            assert pool.pull_attr(key) == {"step": 5, "frozen": False, "version": 1}
            assert key in pool and ModelKey("ghost", 9) not in pool
            assert pool.membership_version == league.model_pool.membership_version
        finally:
            pool.close()


def test_model_pool_client_version_cache(league, params, codec):
    """NotModified on a repeat pull, a changed-leaves delta after a push,
    both rebuilding the pool's exact content; tensors pushed into the
    server-side pool cross as numpy."""
    with tp.serve_league(league) as srv:
        pool = tp.ModelPoolClient(srv.address)
        try:
            key = ModelKey("main", 0)
            server_pool = league.model_pool
            p1 = pool.pull(key)
            base_noop = server_pool.pull_stats["noop"]
            p2 = pool.pull(key)
            assert p2 is p1                      # cache hit, same object back
            assert server_pool.pull_stats["noop"] == base_noop + 1
            new = tree_map(lambda x: torch.as_tensor(x) + 1.0, p1)
            server_pool.push(key, new, step=9)
            base_delta = server_pool.pull_stats["delta"]
            p3 = pool.pull(key)
            assert server_pool.pull_stats["delta"] == base_delta + 1
            _assert_tree_equal(p3, new)
            p4 = pool.pull(key, copy=True)
            assert p4 is not p3
            assert isinstance(pool.pull_if_changed(key, pool.version(key)), tp.NotModified)
            assert pool.manifest(key).version == server_pool.version(key)
        finally:
            pool.close()


def test_repro_client_pulls_from_port_pool_server():
    """Cross-package: `repro`'s client against a port server hosting the
    port's ModelPool. The same numpy params pushed into both packages'
    pools give equal manifests (leaf hashes and tree hash), full pulls,
    deltas and NotModified answers cross the wire between them."""
    rng = np.random.default_rng(5)
    v0 = {"w": rng.normal(size=(64, 64)).astype(np.float32),
          "blocks": {"b": rng.normal(size=(8,)).astype(np.float32),
                     "n": rng.integers(0, 5, (3, 3)).astype(np.int32)}}
    v1 = {"w": v0["w"] + 1.0, "blocks": dict(v0["blocks"])}
    theirs = JaxPool()
    ours = ModelPool()
    for pool, key in ((theirs, JaxKey("main", 0)), (ours, ModelKey("main", 0))):
        pool.push(key, v0)
    with tp.RpcServer({"pool": ours}) as srv:
        client = rtp.ModelPoolClient(rtp.RpcClient(srv.address, timeout=60.0))
        try:
            jkey = JaxKey("main", 0)
            got = client.pull(jkey)
            _assert_tree_equal(got, v0)
            man = client.manifest(jkey)
            assert isinstance(man, rtp.ParamManifest)
            assert man == theirs.manifest(jkey)
            assert man.leaf_hashes == theirs.manifest(jkey).leaf_hashes
            for pool, key in ((theirs, jkey), (ours, ModelKey("main", 0))):
                pool.push(key, v1)
            got = client.pull(jkey)                 # a delta: only "w" changed
            _assert_tree_equal(got, v1)
            assert ours.pull_stats["delta"] == 1
            assert client.manifest(jkey).leaf_hashes == theirs.manifest(jkey).leaf_hashes
            assert isinstance(client.pull_if_changed(jkey, client.version(jkey)),
                              rtp.NotModified)
        finally:
            client.close()


def test_league_seam_roundtrip(league, codec):
    with tp.serve_league(league) as srv:
        lg = tp.LeagueMgrClient(srv.address)
        try:
            task = lg.request_task("main")
            assert isinstance(task, Task) and task.learner_key == ModelKey("main", 0)
            lg.report_result(MatchResult(task.learner_key, task.opponent_keys, 1, 3))
            _, games = lg.pool_winrate("main")
            assert games >= 0.0
            assert lg.should_freeze("main", 0) is None          # step_gate=2
            assert lg.should_freeze("main", 2) == "step_gate@2"
            assert lg.frozen_pool == [ModelKey("main", 0)]
            new_key = lg.end_learning_period("main", lg.model_pool.pull(task.learner_key),
                                             reason="test")
            assert new_key == ModelKey("main", 1)
            assert lg.league_state()["agents"]["main"] == "main:0001"
            assert lg.agents["main"].current == ModelKey("main", 1)
        finally:
            lg.close()


def test_infserver_seam_roundtrip(cfg, params, codec):
    server = InfServer(cfg, 6, max_batch=64, device=CPU)
    league = LeagueMgr()
    league.add_learning_agent("main", params)
    with tp.serve_league(league, server) as srv:
        client = tp.InfServerClient(tp.RpcClient(srv.address))
        try:
            client.register_model("theta", params)
            client.ensure_model("phi", params)
            obs = np.zeros((3, 26), np.int32)
            t1 = client.submit(obs, model="theta")
            t2 = client.submit(obs, model="phi")
            assert not client.poll(t1.tid)
            client.flush()                       # θ and φ share one grouped batch
            assert client.poll(t1.tid)
            a1, logp1, v1 = client.get(t1)
            a2, _, _ = client.get(t2)
            assert a1.shape == a2.shape == (3,)
            assert logp1.shape == v1.shape == (3,)
            assert client.stats()["models_hosted"] == 2
            assert client.evict_model("phi")
        finally:
            client.close()


def test_infserver_rpc_matches_local(cfg, params, codec):
    """The same observations through the in-process server and through the
    RPC client give identical outputs (same seed, same routes)."""
    obs = (np.arange(2 * 26).reshape(2, 26) % 16).astype(np.int32)

    def round_trip(get_server):
        server = InfServer(cfg, 6, params, max_batch=64, seed=13, device=CPU)
        with tp.serve_league(LeagueMgr(), server) as srv:
            s = get_server(server, srv)
            try:
                return s.get(s.submit(obs))
            finally:
                if s is not server:
                    s.close()

    local = round_trip(lambda server, srv: server)
    remote = round_trip(lambda server, srv: tp.InfServerClient(tp.RpcClient(srv.address)))
    for a, b in zip(local, remote):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_data_seam_roundtrip_and_backpressure(codec):
    rows, T = 4, 8
    traj = {"obs": np.zeros((rows, T, 26), np.int32),
            "actions": np.zeros((rows, T), np.int32)}
    ds = DataServer(capacity_frames=rows * T, blocking=True, device=CPU)
    with tp.RpcServer({"data": ds}) as srv:
        client = tp.DataServerClient(srv.address)
        try:
            assert client.put_when_room(traj, timeout=1.0)
            assert client.ready() and ds.num_rows == rows
            assert not client.put_when_room(traj, timeout=0.1)
            ds.sample()                              # learner-side consume frees room
            assert client.put_when_room(traj, timeout=1.0)
            assert client.throughput()["rfps"] > 0
        finally:
            client.close()


def test_dataserver_put_paths_are_zero_copy():
    """Both put paths copy rows into the ring, so the server may hand them
    shm-backed arrays: `RpcServer._zero_copy_ok` reads the marks, and a
    method without one takes the safe copy."""
    ds = DataServer(capacity_frames=64, device=CPU)
    srv = tp.RpcServer({"data": ds})
    try:
        assert srv._zero_copy_ok({"m": "data.put"})
        assert srv._zero_copy_ok({"m": "data.put_when_room"})
        assert not srv._zero_copy_ok({"m": "data.sample"})
        assert not srv._zero_copy_ok({"m": "data._write_rows"})
    finally:
        srv.close()


def test_killed_server_error_propagation(league):
    srv = tp.serve_league(league)
    lg = tp.LeagueMgrClient(srv.address)
    try:
        assert lg.request_task("main").task_id == 0      # connection established
        srv.close()
        with pytest.raises(tp.TransportError):
            lg.request_task("main")
        dead = tp.RpcClient("127.0.0.1:1", connect_retries=1, retry_delay_s=0.01)
        with pytest.raises(tp.TransportError):
            dead.call("league.request_task", "main")
    finally:
        lg.close()
        srv.close()


def test_remote_exception_carries_server_traceback(league):
    with tp.serve_league(league) as srv:
        lg = tp.LeagueMgrClient(srv.address)
        try:
            with pytest.raises(tp.RemoteError) as ei:
                lg.request_task("nonexistent-agent")
            assert "KeyError" in str(ei.value)
            assert "request_task" in ei.value.remote_tb
        finally:
            lg.close()


def test_unserializable_reply_is_remote_error_not_disconnect(league):
    with tp.serve_league(league) as srv:
        lg = tp.LeagueMgrClient(srv.address)
        try:
            with pytest.raises(tp.RemoteError):
                lg._call("payoff")
            assert lg.request_task("main").learner_key == ModelKey("main", 0)
        finally:
            lg.close()


def test_infserver_discard_and_backend_ticket_bound(cfg, params):
    server = InfServer(cfg, 6, params, max_batch=64, device=CPU)
    obs = np.zeros((2, 26), np.int32)
    t = server.submit(obs)
    server.discard(t)
    assert server.queue_depth == 0
    t = server.submit(obs)
    server.flush()
    server.discard(t)
    with pytest.raises(KeyError):
        server.get(t)
    backend = tp.InfServerBackend(server, max_outstanding=2)
    tids = [backend.submit(obs) for _ in range(3)]
    backend.flush()
    with pytest.raises(KeyError):
        backend.get(tids[0])             # evicted
    for tid in tids[1:]:
        a, _, _ = backend.get(tid)
        assert a.shape == (2,)


def test_rpc_server_concurrent_clients(league):
    with tp.serve_league(league) as srv:
        results = [None] * 8

        def worker(i):
            lg = tp.LeagueMgrClient(srv.address)
            try:
                results[i] = [lg.request_task("main").task_id for _ in range(5)]
            finally:
                lg.close()

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30.0)
            assert not t.is_alive()
        ids = [tid for r in results for tid in r]
        assert len(ids) == len(set(ids)) == 40


# -- streaming transfer (param plane) ----------------------------------------
class _Echo:
    @staticmethod
    def echo(m):
        return m


def test_chunked_streaming_roundtrip_bit_exact(codec):
    """Large leaves (numpy, and a CPU tensor) round-trip bit-exact; under
    msgpack they ride out of band and the frame stays small, under pickle
    nothing streams."""
    rng = np.random.default_rng(3)
    big = rng.normal(size=(512, 600)).astype(np.float32)      # ~1.2 MB
    msg = {"big": big, "big_t": torch.from_numpy(big * 2), "small": np.arange(5, dtype=np.int64),
           "key": ModelKey("main", 2), "t": (1, "two")}
    with tp.RpcServer({"e": _Echo()}) as srv:
        c = tp.RpcClient(srv.address)
        try:
            out = c.call("e.echo", msg)
        finally:
            c.close()
    assert out["big"].dtype == big.dtype
    np.testing.assert_array_equal(out["big"], big)
    np.testing.assert_array_equal(out["big_t"], big * 2)
    np.testing.assert_array_equal(out["small"], msg["small"])
    assert out["key"] == msg["key"] and out["t"] == (1, "two")
    blobs = []
    frame = tp.packb(msg, blobs if codec == "msgpack" else None)
    if codec == "msgpack":
        assert len(frame) < 4096 and sum(b.nbytes for b in blobs) == 2 * big.nbytes
    else:
        assert len(frame) > 2 * big.nbytes


def test_chunking_override_is_scoped():
    big = np.zeros((200_000,), np.float32)                    # 800 KB
    with tp.chunking(threshold=1 << 62):
        blobs = []
        assert len(tp.packb({"x": big}, blobs)) > big.nbytes  # monolithic
        assert not blobs
    blobs = []
    tp.packb({"x": big}, blobs)
    assert len(blobs) == 1                                    # restored


def test_killed_server_mid_chunk_raises_transport_error():
    arr = np.zeros((300_000,), np.float32)                    # 1.2 MB blob
    blobs = []
    payload = tp.packb({"w": arr}, blobs)
    assert len(blobs) == 1
    raw = blobs[0].tobytes()
    wire = (struct.pack(">BQ", tp._codec_id() | tp._STREAM_FLAG, len(payload))
            + payload + struct.pack(">I", 1)
            + struct.pack(">Q", len(raw)) + raw[:len(raw) // 2])  # truncated
    lst = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    lst.bind(("127.0.0.1", 0))
    lst.listen(1)
    lst.settimeout(10.0)

    def half_server():
        conn, _ = lst.accept()
        conn.sendall(wire)
        conn.close()                        # dies mid-chunk

    t = threading.Thread(target=half_server, daemon=True)
    t.start()
    client = socket.create_connection(lst.getsockname(), timeout=10.0)
    try:
        with pytest.raises(tp.TransportError, match="mid-chunk"):
            tp.recv_msg(client)
    finally:
        client.close()
        lst.close()
        t.join(timeout=5.0)


def test_infserver_client_hash_gated_hot_swap(cfg, params):
    server = InfServer(cfg, 6, max_batch=16, device=CPU)
    league = LeagueMgr()
    league.add_learning_agent("main", params)
    h = build_manifest(params, 0).tree_hash
    with tp.serve_league(league, server) as srv:
        client = tp.InfServerClient(tp.RpcClient(srv.address))
        try:
            client.update_params(params, key="theta", content_hash=h, version=0)
            assert server.swaps == 1
            client.update_params(params, key="theta", content_hash=h, version=0)
            client.ensure_model("theta", params, content_hash=h)
            assert server.swaps == 1             # both gated off server-side
            assert client.has_model("theta", content_hash=h)
            assert not client.has_model("phi")
            stats = client.stats()
            assert stats["swaps"] == 1 and stats["swap_noops"] == 0
        finally:
            client.close()


def test_concurrent_push_and_delta_pull_over_rpc(league):
    key = ModelKey("main", 0)
    with tp.serve_league(league) as srv:
        stop = threading.Event()
        errors = []

        def pusher():
            c = tp.ModelPoolClient(srv.address)
            i = 0
            try:
                while not stop.is_set():
                    i += 1
                    c.push(key, {"w": np.full((64, 64), i, np.float32),
                                 "b": np.full((4,), i % 3, np.float32)}, step=i)
            finally:
                c.close()

        def puller():
            try:
                c = tp.ModelPoolClient(srv.address)
                last_v = -1
                for _ in range(25):
                    p = c.pull(key)
                    man = c._puller.manifest(key)
                    assert man.version >= last_v
                    last_v = man.version
                    assert build_manifest(p, man.version).tree_hash == man.tree_hash, \
                        "torn delta"
                c.close()
            except Exception as e:           # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=pusher, daemon=True)] + \
            [threading.Thread(target=puller) for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads[1:]:
            t.join(timeout=60.0)
            assert not t.is_alive()
        stop.set()
        threads[0].join(timeout=10.0)
        assert not errors, errors[0]
        assert league.model_pool.pull_stats["delta"] > 0


# -- pipelined protocol ------------------------------------------------------
class _Bench:
    """Test backend: an echo that can stall, for out-of-order replies."""

    @staticmethod
    def echo(x, delay=0.0):
        if delay:
            time.sleep(delay)
        return x

    def __init__(self):
        self.seen = []
        self._lock = threading.Lock()

    def record(self, x):
        with self._lock:
            self.seen.append(x)
        return len(self.seen)


def test_pipelined_out_of_order_64_callers():
    with tp.RpcServer({"b": _Bench()}, conn_workers=8) as srv:
        c = tp.RpcClient(srv.address)
        try:
            futs = [c.call_async("b.echo", i, delay=0.05 if i % 2 == 0 else 0.0)
                    for i in range(64)]
            assert c.transport_stats()["proto"] >= 2
            assert [f.result(timeout=30.0) for f in futs] == list(range(64))
        finally:
            c.close()


def test_pipelined_slow_does_not_block_fast():
    with tp.RpcServer({"b": _Bench()}) as srv:
        c = tp.RpcClient(srv.address)
        try:
            slow = c.call_async("b.echo", "slow", delay=1.0)
            t0 = time.monotonic()
            assert c.call("b.echo", "fast") == "fast"
            fast_s = time.monotonic() - t0
            assert fast_s < 0.5, f"fast call waited {fast_s:.2f}s behind slow"
            assert slow.result(timeout=10.0) == "slow"
        finally:
            c.close()


def test_abort_poisons_inflight_futures():
    with tp.RpcServer({"b": _Bench()}) as srv:
        c = tp.RpcClient(srv.address)
        futs = [c.call_async("b.echo", i, delay=3.0) for i in range(4)]
        timer = threading.Timer(0.2, c.abort)
        timer.start()
        try:
            for f in futs:
                with pytest.raises(tp.TransportError):
                    f.result(timeout=10.0)
            with pytest.raises(tp.TransportError):
                c.call("b.echo", 1)
        finally:
            timer.join(timeout=5.0)
            c.close()


def test_legacy_server_negotiates_down():
    with tp.RpcServer({"b": _Bench()}, pipeline=False) as srv:
        c = tp.RpcClient(srv.address)
        try:
            assert c.call("b.echo", "x") == "x"
            assert c.transport_stats()["proto"] == 1
            assert c.call_async("b.echo", 7).result(timeout=10.0) == 7
            assert c.notify("b.record", "n1")
            assert c.call("b.record", "n2") == 2   # notify reached the server
        finally:
            c.close()


def test_legacy_client_against_pipelined_server():
    with tp.RpcServer({"b": _Bench()}) as srv:
        old = tp.RpcClient(srv.address, pipeline=False)
        new = tp.RpcClient(srv.address)
        try:
            assert old.transport_stats()["proto"] == 0  # never negotiated
            assert old.call("b.echo", "v1") == "v1"
            assert old.transport_stats()["proto"] == 1
            assert new.call("b.echo", "v2") == "v2"
            assert new.transport_stats()["proto"] >= 2
        finally:
            old.close()
            new.close()


def test_shm_ring_wraparound_and_oversize_fallback():
    rng = np.random.default_rng(7)
    with tp.RpcServer({"b": _Bench()}) as srv:
        c = tp.RpcClient(srv.address, shm_bytes=1 << 20)      # 1 MiB ring
        try:
            blob = rng.normal(size=(75, 1024)).astype(np.float32)
            for i in range(8):
                out = c.call("b.echo", {"i": i, "w": blob + i})
                np.testing.assert_array_equal(out["w"], blob + i)
            st = c.transport_stats()
            assert st["shm"], "same-host client should have negotiated shm"
            assert st["shm_blobs"] >= 8
            assert st["shm_wraps"] >= 1, st
            huge = rng.normal(size=(600, 1024)).astype(np.float32)  # 2.4 MiB
            np.testing.assert_array_equal(c.call("b.echo", huge), huge)
            assert c.transport_stats()["shm_fallbacks"] >= 1
        finally:
            c.close()


def _shm_client(srv):
    c = tp.RpcClient(srv.address)
    c.call("b.echo", np.zeros((200_000,), np.float32))   # force negotiate
    conn = c._conn
    assert conn is not None and conn.shm is not None, "shm not negotiated"
    return c, conn, conn.shm.name


def test_shm_segment_unlinked_on_close():
    with tp.RpcServer({"b": _Bench()}) as srv:
        c, _, name = _shm_client(srv)
        assert os.path.exists(f"/dev/shm/{name}")
        c.close()
        assert not os.path.exists(f"/dev/shm/{name}")


def test_shm_close_race_reader_thread_wins(monkeypatch):
    """The reference's leak, made deterministic: the reader thread fails
    first (its socket shut down under it) and takes the ring, whose unlink
    is slowed down; `close()` called meanwhile must still return only once
    the segment is gone. 50 times."""
    real_close = tp._ShmRing.close

    def slow_close(ring):
        time.sleep(0.02)
        real_close(ring)

    monkeypatch.setattr(tp._ShmRing, "close", slow_close)
    with tp.RpcServer({"b": _Bench()}) as srv:
        for _ in range(50):
            c, conn, name = _shm_client(srv)
            conn.sock.shutdown(socket.SHUT_RDWR)      # wakes the reader thread
            deadline = time.monotonic() + 10.0
            while conn.shm is not None and time.monotonic() < deadline:
                time.sleep(0.001)                     # the reader took the ring
            assert conn.shm is None and conn.reader.is_alive()
            c.close()
            assert not os.path.exists(f"/dev/shm/{name}")
            conn.reader.join(timeout=10.0)
            assert not conn.reader.is_alive()


def test_chunked_blobs_interleave_with_small_calls():
    rng = np.random.default_rng(11)
    big = rng.normal(size=(900, 1024)).astype(np.float32)     # ~3.7 MB
    with tp.RpcServer({"b": _Bench()}) as srv:
        c = tp.RpcClient(srv.address, shm=False)
        try:
            bigs = [c.call_async("b.echo", {"i": i, "w": big * (i + 1)}) for i in range(3)]
            smalls = [c.call_async("b.echo", i) for i in range(20)]
            assert [f.result(timeout=30.0) for f in smalls] == list(range(20))
            for i, f in enumerate(bigs):
                out = f.result(timeout=60.0)
                assert out["i"] == i
                np.testing.assert_array_equal(out["w"], big * (i + 1))
        finally:
            c.close()


def test_notify_is_one_way_and_reaches_server():
    b = _Bench()
    with tp.RpcServer({"b": b}) as srv:
        c = tp.RpcClient(srv.address)
        try:
            for i in range(10):
                assert c.notify("b.record", i)
            deadline = time.monotonic() + 5.0
            while len(b.seen) < 10 and time.monotonic() < deadline:
                time.sleep(0.01)
            assert b.seen == list(range(10))
            assert c.call("b.echo", "ok") == "ok"
        finally:
            c.close()



# -- robustness: retrying seam clients, fault injection, heartbeat monitor ----
# (the transport and heartbeat-monitor tests of tests/test_robustness.py)
def _small_params(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(16, 16)).astype(np.float32),
            "b": rng.normal(size=(16,)).astype(np.float32)}


class TestRetry:
    FAST = tp.RetryPolicy(base_s=0.02, cap_s=0.1, deadline_s=5.0)

    def test_retry_policy_jitter_and_deadline(self):
        import random
        pol = tp.RetryPolicy(base_s=0.1, cap_s=0.8, max_attempts=6, deadline_s=None)
        ds = list(pol.delays(random.Random(0)))
        assert len(ds) == 5
        for i, d in enumerate(ds):
            nominal = min(0.8, 0.1 * 2 ** i)
            assert 0.5 * nominal <= d <= 1.5 * nominal
        # the same seed draws the same delays as repro's policy
        theirs = rtp.RetryPolicy(base_s=0.1, cap_s=0.8, max_attempts=6, deadline_s=None)
        assert ds == list(theirs.delays(random.Random(0)))
        spent = tp.RetryPolicy(base_s=0.01, deadline_s=0.0)
        assert list(spent.delays(random.Random(0))) == []

    def test_endpoint_list_parsing_and_rotation(self):
        c = tp.RpcClient("a:1, b:2,c:3", connect_retries=1)
        assert c.endpoints == ("a:1", "b:2", "c:3")
        assert c.address == "a:1"
        c._rotate()
        assert c.address == "b:2"

    def test_idempotent_retry_survives_server_restart(self):
        pool = ModelPool()
        key = ModelKey("m", 0)
        pool.push(key, _small_params())
        srv = tp.RpcServer({"pool": pool}).start()
        host, port = tp.parse_addr(srv.address)
        client = tp.RpcClient(srv.address, retry=self.FAST, seed=0)
        box = {}
        restarter = None
        try:
            assert client.call("pool.version", key, idempotent=True) == 0
            srv.close()

            def restart():
                time.sleep(0.3)
                box["srv"] = tp.RpcServer({"pool": pool}, host=host, port=port).start()

            restarter = threading.Thread(target=restart, daemon=True)
            restarter.start()
            assert client.call("pool.version", key, idempotent=True) == 0
        finally:
            if restarter is not None:
                restarter.join(timeout=5.0)
            client.close()
            box.get("srv", srv).close()

    def test_nonidempotent_failure_raises_retryable(self):
        pool = ModelPool()
        plan = tp.FaultPlan([tp.FaultRule("pool.push", "drop_reply", max_times=1)])
        srv = tp.RpcServer({"pool": pool}, fault_plan=plan).start()
        client = tp.RpcClient(srv.address, retry=self.FAST, seed=0)
        try:
            client.call("pool.keys", idempotent=True)
            with pytest.raises(tp.RetryableError):
                client.call("pool.push", ModelKey("m", 0), _small_params())
            assert ModelKey("m", 0) in pool.keys()        # it DID execute
        finally:
            client.close()
            srv.close()

    def test_nonidempotent_on_proactively_dead_conn_is_not_ambiguous(self):
        pool = ModelPool()
        srv = tp.RpcServer({"pool": pool}).start()
        client = tp.RpcClient(srv.address, retry=self.FAST, seed=0)
        try:
            client.call("pool.keys", idempotent=True)
            srv.close()
            time.sleep(0.2)                # let the reader observe the close
            with pytest.raises(tp.TransportError):
                client.call("pool.push", ModelKey("m", 0), _small_params())
        finally:
            client.close()

    def test_unreachable_idempotent_exhausts_with_transport_error(self):
        client = tp.RpcClient("127.0.0.1:1", retry=tp.RetryPolicy(
            base_s=0.01, cap_s=0.02, max_attempts=3, deadline_s=0.2))
        with pytest.raises(tp.TransportError) as ei:
            client.call("pool.keys", idempotent=True)
        assert not isinstance(ei.value, tp.RetryableError)

    def test_abort_poisons_retries(self):
        client = tp.RpcClient("127.0.0.1:1", retry=self.FAST)
        client.abort()
        t0 = time.monotonic()
        with pytest.raises(tp.TransportError):
            client.call("pool.keys", idempotent=True)
        assert time.monotonic() - t0 < 1.0

    def test_pool_client_fails_over_to_replica(self):
        from repro_torch.core.model_pool import ModelPoolReplica

        key = ModelKey("m", 0)
        primary = ModelPool()
        primary.push(key, _small_params())
        rep = ModelPoolReplica(primary)
        rep.sync_once()
        srv_p = tp.RpcServer({"pool": primary}).start()
        srv_r = tp.RpcServer({"pool": rep}).start()
        client = tp.ModelPoolClient(tp.RpcClient([srv_p.address, srv_r.address],
                                                 retry=self.FAST, seed=0))
        try:
            np.testing.assert_array_equal(client.pull(key)["w"], primary.pull(key)["w"])
            srv_p.close()                                  # kill the primary
            client.clear_cache()
            np.testing.assert_array_equal(client.pull(key)["w"], primary.pull(key)["w"])
        finally:
            client.close()
            srv_p.close()
            srv_r.close()

    def test_replica_keyerror_read_falls_back_to_primary(self):
        key = ModelKey("fresh", 0)
        primary = ModelPool()
        primary.push(key, _small_params())
        lagging = ModelPool()
        srv_p = tp.RpcServer({"pool": primary}).start()
        srv_r = tp.RpcServer({"pool": lagging}).start()
        client = tp.ModelPoolClient(tp.RpcClient(srv_r.address, retry=self.FAST),
                                    write_client=srv_p.address)
        try:
            assert client.version(key) == 0
            np.testing.assert_array_equal(client.pull(key)["w"], primary.pull(key)["w"])
        finally:
            client.close()
            srv_p.close()
            srv_r.close()


class TestFaultPlan:
    def test_json_roundtrip_and_env(self, monkeypatch):
        plan = tp.FaultPlan([tp.FaultRule("pool.*", "drop", p=0.5, max_times=3)], seed=7)
        assert plan.to_json() == rtp.FaultPlan(
            [rtp.FaultRule("pool.*", "drop", p=0.5, max_times=3)], seed=7).to_json()
        back = tp.FaultPlan.from_json(plan.to_json())
        assert back.seed == 7 and back.rules[0].match == "pool.*"
        assert back.rules[0].p == 0.5 and back.rules[0].max_times == 3
        monkeypatch.setenv("REPRO_FAULT_PLAN", plan.to_json())
        assert tp.FaultPlan.from_env().seed == 7
        monkeypatch.delenv("REPRO_FAULT_PLAN")
        assert tp.FaultPlan.from_env() is None

    def test_seeded_decisions_are_deterministic(self):
        def draws(mod, seed):
            plan = mod.FaultPlan([mod.FaultRule("*", "drop", p=0.5)], seed=seed)
            return [plan.decide("x.y") is not None for _ in range(32)]
        assert draws(tp, 3) == draws(tp, 3) == draws(rtp, 3)
        assert draws(tp, 3) != draws(tp, 4)

    def test_unknown_kind_rejected(self):
        with pytest.raises(AssertionError):
            tp.FaultRule("*", "explode")

    @pytest.mark.parametrize("kind", ["drop", "drop_reply", "close_mid_chunk"])
    def test_idempotent_call_rides_through_fault(self, kind):
        pool = ModelPool()
        key = ModelKey("m", 0)
        pool.push(key, {"w": np.arange(128 * 1024, dtype=np.float32)})
        plan = tp.FaultPlan([tp.FaultRule("pool.pull*", kind, max_times=1)])
        srv = tp.RpcServer({"pool": pool}, fault_plan=plan).start()
        client = tp.ModelPoolClient(tp.RpcClient(
            srv.address, retry=tp.RetryPolicy(base_s=0.02, cap_s=0.1, deadline_s=5.0), seed=0))
        try:
            np.testing.assert_array_equal(client.pull(key)["w"], pool.pull(key)["w"])
            assert plan.stats()[f"pool.pull*:{kind}"] == 1
        finally:
            client.close()
            srv.close()

    def test_delay_fault_adds_latency(self):
        from repro_torch.distributed.heartbeat import Heartbeat

        hb = Heartbeat()
        plan = tp.FaultPlan([tp.FaultRule("ctrl.ping", "delay", delay_s=0.2, max_times=1)])
        srv = tp.RpcServer({"ctrl": hb}, fault_plan=plan).start()
        client = tp.RpcClient(srv.address)
        try:
            t0 = time.monotonic()
            client.call("ctrl.ping")
            assert time.monotonic() - t0 >= 0.15
            t0 = time.monotonic()
            client.call("ctrl.ping")                      # rule exhausted
            assert time.monotonic() - t0 < 0.15
        finally:
            client.close()
            srv.close()


class TestHeartbeatMonitor:
    def test_monitor_tolerates_slow_beats(self):
        """A peer whose counter still advances, however slowly, is never
        declared dead; one that stops advancing is."""
        from repro_torch.distributed.heartbeat import Heartbeat, HeartbeatMonitor

        hb = Heartbeat()
        hb.beat()
        srv = tp.RpcServer({"ctrl": hb}).start()
        died = threading.Event()
        mon = HeartbeatMonitor(srv.address, interval_s=0.05, timeout_s=0.6, on_dead=died.set)
        mon.start()
        try:
            for _ in range(4):                            # slow but alive
                time.sleep(0.3)
                hb.beat()
            assert not mon.dead
            assert died.wait(timeout=5.0)                 # beats stopped
            assert mon.dead
        finally:
            mon.stop()
            mon.join(timeout=5.0)
            srv.close()
        assert not mon.is_alive()

    def test_probe_and_cli(self):
        """`probe` answers True against a live ctrl plane and False against
        nothing; `python -m repro_torch.distributed.heartbeat` exits 0/1."""
        from repro_torch.distributed.heartbeat import Heartbeat, probe

        srv = tp.RpcServer({"ctrl": Heartbeat()}).start()
        src = str(Path(tp.__file__).resolve().parents[2])
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [src] + ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH") else [])))
        try:
            assert probe(srv.address, timeout_s=2.0)
            r = subprocess.run([sys.executable, "-m", "repro_torch.distributed.heartbeat",
                                f"tcp://{srv.address}", "--timeout", "2"],
                               env=env, capture_output=True, timeout=120)
            assert r.returncode == 0, r.stderr[-2000:]
        finally:
            srv.close()
        assert not probe("127.0.0.1:1", timeout_s=0.5)
