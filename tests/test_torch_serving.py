"""The port's serving-gateway plane against `repro`'s, on the CPU.

Every test of `tests/test_serving.py` runs here against
`repro_torch.serving`, with port InfServers on the CPU for the rollout,
parity and failover tests. The routing tests drive the same request
sequence through `repro`'s gateway and the port's (each over its own
`FakeReplica`s) and require the same decisions: the same submits on the
same replicas, the same spills, and the same home index for every lineage
(both routers hash with `zlib`). Then the fleet as users start it:
`serve_fleet` spawns two `repro_torch.launch.serve --replica --device cpu`
processes and drives traffic through a gateway.

Every wait has a timeout (every RPC client a 60 s socket timeout unless
a test sets one); servers close in `finally`, and `serve_fleet`
terminates its replicas before it returns.
"""
import time

import numpy as np
import pytest
import torch

from repro.core import ModelKey as JaxKey
from repro.serving import ServingGateway as JaxGateway
from repro.serving import make_router as jax_make_router
from repro_torch.configs import get_arch
from repro_torch.core import ModelKey
from repro_torch.infserver import InfServer
from repro_torch.models import init_params
from repro_torch.params.manifest import build_manifest
from repro_torch.serving import (AdmissionRejected, DeadlineBuckets,
                                 GatewayBackend, LineageRouter, ServingGateway,
                                 lineage_of, make_router)

CPU = "cpu"


class FakeReplica:
    """Protocol-complete stand-in: records every routed submit, resolves
    instantly with zeros. Lets the routing tests control load purely via
    fetched/unfetched tickets."""

    def __init__(self):
        self.models = {}
        self.hashes = {}
        self.submits = []            # (model, rows) in arrival order
        self.flushes = 0
        self.register_calls = 0
        self._next = 0

    def submit(self, obs, model=None):
        obs = np.asarray(obs)
        self.submits.append((model, obs.shape[0]))
        tid = self._next
        self._next += 1
        return (tid, obs.shape[0])

    def get(self, ticket):
        _, rows = ticket
        z = np.zeros(rows, np.float32)
        return z, z, z

    def flush(self):
        self.flushes += 1

    def register_model(self, key, params, content_hash=None, version=None):
        self.register_calls += 1
        self.models[key] = params
        self.hashes[key] = content_hash

    def ensure_model(self, key, params, content_hash=None):
        self.models.setdefault(key, params)

    def has_model(self, key, content_hash=None):
        return key in self.models and (content_hash is None
                                       or self.hashes.get(key) == content_hash)

    def telemetry(self):
        return {"queue_depth": 0, "mean_batch_latency_ms": 0.0}


def _routed(gateway):
    return [r["routed_requests"] for r in gateway.stats()["replicas"]]


def _plain(submits):
    """(lineage, version, rows) per submit: comparable across packages."""
    return [(m.agent_id, m.version, rows) for m, rows in submits]


@pytest.fixture(autouse=True)
def _bounded_rpc_waits(monkeypatch):
    """No RPC in these tests waits forever: a client made without a socket
    timeout gets 60 s (replies owed past it fail the call)."""
    from repro_torch.distributed import transport as tp

    init = tp.RpcClient.__init__

    def bounded(self, address, timeout=None, *args, **kwargs):
        init(self, address, 60.0 if timeout is None else timeout, *args, **kwargs)
    monkeypatch.setattr(tp.RpcClient, "__init__", bounded)


OBS = np.zeros((4, 8), np.int32)
PACKAGES = {"repro_torch": (ServingGateway, make_router, ModelKey),
            "repro": (JaxGateway, jax_make_router, JaxKey)}


# ---------------------------------------------------------------------------
# routing, held against repro's decisions
# ---------------------------------------------------------------------------
def test_seeded_routing_determinism():
    """The same request sequence routes identically on two fresh
    gateways, and identically in both packages."""
    lineages = ["main", "exploiter", "league", "main", "main", "exploiter",
                "pfsp", "league", "main", "pfsp"]

    def run(pkg):
        gw_cls, _, key_cls = PACKAGES[pkg]
        fakes = [FakeReplica() for _ in range(4)]
        gw = gw_cls(fakes, router="lineage", max_inflight_rows=10_000)
        for i, lin in enumerate(lineages * 5):
            gw.submit(OBS, model=key_cls(lin, i % 3))   # no gets: load builds
        return [_plain(f.submits) for f in fakes]

    assert run("repro_torch") == run("repro_torch") == run("repro")


def test_lineage_affinity_routes_to_home():
    fakes = [FakeReplica() for _ in range(4)]
    router = LineageRouter()
    gw = ServingGateway(fakes, router=router)
    lineages = ["main", "exploiter", "league", "pfsp", "mirror"]
    for lin in lineages:
        for v in range(3):
            gw.get(gw.submit(OBS, model=ModelKey(lin, v)))
    homes = {lin: router.home_index(ModelKey(lin, 0), 4) for lin in lineages}
    for i, f in enumerate(fakes):
        for model, _ in f.submits:
            assert homes[model.agent_id] == i
    assert len(set(homes.values())) >= 2
    assert router.spills == 0
    assert router.affinity_hits == len(lineages) * 3


@pytest.mark.parametrize("n", [2, 3, 4, 7])
def test_home_index_matches_repro(n):
    """Both routers send every lineage to the same home replica."""
    ours, theirs = make_router("lineage"), jax_make_router("lineage")
    for lin in ["main", "exploiter:0", "exploiter:1", "league", "pfsp", "mirror", "teacher"]:
        for v in (0, 5):
            assert ours.home_index(ModelKey(lin, v), n) == theirs.home_index(JaxKey(lin, v), n)
    assert ours.home_index("teacher", n) == theirs.home_index("teacher", n)


def test_lineage_of_falls_back_to_str():
    assert lineage_of(ModelKey("main", 7)) == "main"
    assert lineage_of("teacher") == "teacher"


def test_occupancy_spill_under_slow_replica():
    """The overflow spills to the least-loaded replica, in both packages
    at the same submits."""
    def run(pkg):
        gw_cls, mk_router, key_cls = PACKAGES[pkg]
        fakes = [FakeReplica() for _ in range(2)]
        router = mk_router("lineage", spill_min_rows=16, spill_factor=1.5)
        gw = gw_cls(fakes, router=router, max_inflight_rows=10_000)
        key = key_cls("main", 0)
        home = router.home_index(key, 2)
        tickets = [gw.submit(OBS, model=key) for _ in range(20)]  # never fetched
        out = (home, router.spills, [_plain(f.submits) for f in fakes])
        for t in tickets:
            gw.get(t)
        before = len(fakes[home].submits)
        gw.get(gw.submit(OBS, model=key))
        return out, len(fakes[home].submits) - before

    (home, spills, submits), back_home = run("repro_torch")
    other = 1 - home
    assert spills > 0 and len(submits[other]) > 0
    assert len(submits[home]) >= len(submits[other])
    assert back_home == 1                                 # draining restores affinity
    assert run("repro") == ((home, spills, submits), back_home)


def test_telemetry_queue_depth_feeds_router_load():
    fakes = [FakeReplica() for _ in range(2)]
    deep = {"queue_depth": 500, "mean_batch_latency_ms": 40.0}
    fakes[0].telemetry = lambda: deep
    gw = ServingGateway(fakes, router="least_loaded")
    gw.refresh_telemetry()
    for _ in range(5):
        gw.get(gw.submit(OBS))
    assert len(fakes[1].submits) == 5 and len(fakes[0].submits) == 0


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------
def test_admission_shed_is_typed_and_recovers():
    fakes = [FakeReplica() for _ in range(2)]
    gw = ServingGateway(fakes, router="least_loaded", max_inflight_rows=32)
    held = [gw.submit(OBS) for _ in range(8)]          # 32 rows outstanding
    with pytest.raises(AdmissionRejected) as ei:
        gw.submit(OBS)
    e = ei.value
    assert e.reason == "overload" and e.limit == 32
    assert e.inflight_rows == 32 and e.rows == 4
    assert e.retry_after_s >= 0
    st = gw.stats()
    assert st["shed_requests"] == 1 and st["shed_rows"] == 4
    for t in held:
        gw.get(t)
    gw.get(gw.submit(OBS))
    assert gw.stats()["shed_requests"] == 1


def test_all_dead_fleet_sheds_with_no_replicas():
    fakes = [FakeReplica() for _ in range(2)]
    gw = ServingGateway(fakes)
    gw.mark_dead(0)
    gw.mark_dead(1)
    with pytest.raises(AdmissionRejected) as ei:
        gw.submit(OBS)
    assert ei.value.reason == "no_replicas"


# ---------------------------------------------------------------------------
# SLO deadline buckets
# ---------------------------------------------------------------------------
def test_deadline_buckets_label_and_hit_accounting():
    b = DeadlineBuckets(edges_s=(0.01, 0.05))
    assert b.label(0.004) == "le_10ms"
    assert b.label(0.05) == "le_50ms"
    assert b.label(0.2) == "le_inf" and b.label(None) == "le_inf"
    assert b.record(0.01, 0.005) is True
    assert b.record(0.01, 0.02) is False
    snap = b.snapshot()["le_10ms"]
    assert snap["count"] == 2 and snap["met"] == 1
    assert snap["hit_rate"] == 0.5 and snap["p99_ms"] >= snap["p50_ms"]


def test_pump_flushes_replica_with_due_deadline():
    fakes = [FakeReplica() for _ in range(2)]
    gw = ServingGateway(fakes, router="least_loaded")
    gw.submit(OBS, deadline_s=0.01)
    target = max(range(2), key=lambda i: len(fakes[i].submits))
    assert gw.pump(now=time.perf_counter() + 10.0) == 1
    assert fakes[target].flushes == 1
    assert gw.pump(now=time.perf_counter() + 10.0) == 0


def test_no_deadline_request_never_pumps():
    fakes = [FakeReplica()]
    gw = ServingGateway(fakes)
    gw.submit(OBS)
    assert gw.pump(now=time.perf_counter() + 100.0) == 0


# ---------------------------------------------------------------------------
# fleet rollout (param plane), port InfServers on the CPU
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def served():
    cfg = get_arch("tleague-policy-s")
    return cfg, init_params(torch.Generator().manual_seed(0), cfg)


def test_fleet_rollout_ships_zero_bytes_to_hosting_replicas(served):
    cfg, params = served
    key = ModelKey("frozen", 3)
    manifest = build_manifest(params, version=3)
    replicas = [InfServer(cfg, 6, max_batch=16, seed=i, device=CPU) for i in range(3)]
    replicas[0].register_model(key, params, content_hash=manifest.tree_hash, version=3)
    gw = ServingGateway(replicas)
    cold = gw.rollout(key, params, manifest)
    assert cold["shipped_to"] == 2 and cold["already_hosted"] == 1
    assert cold["bytes_shipped"] == 2 * manifest.nbytes
    assert [p["shipped"] for p in cold["replicas"]] == [False, True, True]
    warm = gw.rollout(key, params, manifest)
    assert warm["bytes_shipped"] == 0 and warm["already_hosted"] == 3
    assert gw.stats()["rollout_noops"] == 4
    for r in replicas:
        assert r.has_model(key, manifest.tree_hash)


def test_rollout_from_pool_delta_path(served):
    from repro_torch.core.model_pool import ModelPool

    cfg, params = served
    pool = ModelPool()
    key = ModelKey("main", 1)
    pool.push(key, params)
    replicas = [InfServer(cfg, 6, max_batch=16, seed=i, device=CPU) for i in range(2)]
    gw = ServingGateway(replicas)
    report = gw.rollout_from_pool(pool, key)
    assert report["shipped_to"] == 2
    man = pool.manifest(key)
    for r in replicas:
        assert r.has_model(key, man.tree_hash)
    assert gw.rollout_from_pool(pool, key)["bytes_shipped"] == 0


# ---------------------------------------------------------------------------
# stats across the RPC seam + parity
# ---------------------------------------------------------------------------
def test_stats_and_telemetry_cross_rpc_seam(served):
    from repro_torch.distributed.transport import InfServerBackend, RpcServer
    from repro_torch.serving.fleet import connect

    cfg, params = served
    server = InfServer(cfg, 6, params, max_batch=16, device=CPU)
    rpc = RpcServer({"inf": InfServerBackend(server)}).start()
    try:
        client = connect(rpc.address)
        client.get(client.submit(np.zeros((2, 26), np.int32)))
        st = client.stats()
        assert st["rows_served"] == 2 and st["batches_run"] == 1
        assert 0 < st["occupancy"] <= 1.0
        assert st["mean_batch_latency_ms"] > 0
        assert isinstance(st["dispatch"], dict)
        tel = client.telemetry()
        assert tel["rows_served"] == 2 and tel["queue_depth"] == 0
        assert set(tel) <= set(st)
        a, _, _ = client.get(client.submit(np.zeros((2, 26), np.int32), deadline_s=0.5))
        assert a.shape == (2,)
        client.close()
    finally:
        rpc.close()


def _drive_sequence(gw, keys, obs_seq):
    return [gw.get(gw.submit(obs, model=key)) for obs, key in zip(obs_seq, keys)]


def test_inproc_vs_rpc_gateway_parity(served):
    """The same gateway and request sequence over in-process replicas and
    over RPC replica clients route identically and return equal values."""
    from repro_torch.distributed.transport import InfServerBackend, RpcServer
    from repro_torch.serving.fleet import connect

    cfg, params = served
    key_a, key_b = ModelKey("main", 0), ModelKey("exploiter", 0)
    rng = np.random.default_rng(0)
    obs_seq = [rng.integers(0, 16, (3, 26)).astype(np.int32) for _ in range(8)]
    keys = [key_a, key_b] * 4

    def build(remote):
        servers = [InfServer(cfg, 6, max_batch=64, seed=i, device=CPU) for i in range(2)]
        rpcs = []
        if remote:
            rpcs = [RpcServer({"inf": InfServerBackend(s)}).start() for s in servers]
            reps = [connect(r.address) for r in rpcs]
        else:
            reps = servers
        gw = ServingGateway(reps, router="lineage")
        for k in (key_a, key_b):
            gw.register_model(k, params)
        return gw, rpcs

    gw_local, _ = build(remote=False)
    gw_rpc, rpcs = build(remote=True)
    try:
        local = _drive_sequence(gw_local, keys, obs_seq)
        rpc = _drive_sequence(gw_rpc, keys, obs_seq)
        assert _routed(gw_local) == _routed(gw_rpc)
        for (a1, l1, v1), (a2, l2, v2) in zip(local, rpc):
            np.testing.assert_array_equal(a1, a2)
            np.testing.assert_allclose(l1, l2, rtol=1e-6)
            np.testing.assert_allclose(v1, v2, rtol=1e-6)
    finally:
        for r in rpcs:
            r.close()


def test_gateway_behind_rpc_serves_infserver_protocol(served):
    from repro_torch.distributed.transport import InfServerClient, RpcClient, RpcServer

    cfg, params = served
    replicas = [InfServer(cfg, 6, params, max_batch=16, seed=i, device=CPU) for i in range(2)]
    gw = ServingGateway(replicas)
    rpc = RpcServer({"inf": GatewayBackend(gw)}).start()
    try:
        client = InfServerClient(RpcClient(rpc.address))
        t = client.submit(np.zeros((2, 26), np.int32), deadline_s=5.0)
        a, logp, v = client.get(t)
        assert a.shape == (2,) and v.shape == (2,)
        assert client.telemetry()["alive_replicas"] == 2
        assert gw.stats()["requests"] == 1
        assert gw.deadlines.snapshot()
        client.close()
    finally:
        rpc.close()


def test_submit_side_failover_repoints_ticket_and_keeps_deadline():
    from repro_torch.distributed.transport import TransportError

    class DyingReplica(FakeReplica):
        def submit(self, obs, model=None):
            raise TransportError("connection reset by peer")

    dying, live = DyingReplica(), FakeReplica()
    gw = ServingGateway([dying, live], router="least_loaded")
    t = gw.submit(OBS, deadline_s=0.05)
    assert t.handle.index == 1
    assert gw.failovers == 1 and gw.alive_replicas == 1
    assert gw.inflight_rows == OBS.shape[0]
    per = {r["replica"]: r for r in gw.stats()["replicas"]}
    assert per[0]["inflight_rows"] == 0
    assert per[1]["inflight_rows"] == OBS.shape[0]
    assert gw.pump(now=time.perf_counter() + 10.0) == 1
    assert live.flushes == 1
    gw.get(t)
    assert gw.inflight_rows == 0


def test_get_exhaustion_releases_ledger_on_alive_replica():
    from repro_torch.distributed.transport import RemoteError

    class AmnesiacReplica(FakeReplica):
        def get(self, ticket):
            raise RemoteError("KeyError: unknown ticket")

    gw = ServingGateway([AmnesiacReplica()], failover_retries=0)
    t = gw.submit(OBS, deadline_s=0.05)
    with pytest.raises(RemoteError):
        gw.get(t)
    assert gw.inflight_rows == 0
    assert gw.pump(now=time.perf_counter() + 10.0) == 0
    assert gw.alive_replicas == 1


def test_failover_resubmits_to_survivor(served):
    from repro_torch.distributed.transport import InfServerBackend, RpcServer
    from repro_torch.serving.fleet import connect

    cfg, params = served
    servers = [InfServer(cfg, 6, params, max_batch=16, seed=i, device=CPU) for i in range(2)]
    rpcs = [RpcServer({"inf": InfServerBackend(s)}).start() for s in servers]
    try:
        gw = ServingGateway([connect(r.address) for r in rpcs], router="round_robin")
        t1 = gw.submit(np.zeros((2, 26), np.int32))
        rpcs[t1.handle.index].close()                  # hard death
        a, _, _ = gw.get(t1)                           # fails over
        assert a.shape == (2,)
        assert gw.failovers >= 1 and gw.alive_replicas == 1
        assert gw.stats()["replicas_died"] == 1
    finally:
        for r in rpcs:
            r.close()


# ---------------------------------------------------------------------------
# the fleet as users start it: replica processes behind a gateway
# ---------------------------------------------------------------------------
def test_serve_fleet_spawns_cpu_replicas_and_serves(served):
    """`serve_fleet(2, device="cpu")`: two `--replica` processes, the
    rollout ships θ to both, the probe's values through the gateway equal
    the in-process forward on the same params and obs, both replicas
    serve rows, and the fleet is gone afterwards."""
    from repro_torch.launch.serve import serve_fleet

    cfg, _ = served
    probe = {}

    def on_rollout(gw, params, keys):
        obs = np.random.default_rng(3).integers(0, 8, (5, 26)).astype(np.int32)
        _, _, v = gw.get(gw.submit(obs, model=keys[0]))
        ref = InfServer(cfg, 3, params, max_batch=16, device=CPU)
        probe["err"] = float(np.abs(v - ref.get(ref.submit(obs))[2]).max())

    st = serve_fleet(2, env_name="rps", demo_rounds=3, demo_rows=4, device=CPU,
                     verbose=False, on_rollout=on_rollout)
    assert probe["err"] <= 1e-5
    assert all(r["shipped_to"] == 2 for r in st["rollouts"].values())
    assert st["alive_replicas"] == 2 and st["failovers"] == 0
    assert all(r["routed_rows"] > 0 for r in st["replicas"])
    assert st["demo"]["rows"] == 3 * 2 * 4 and st["demo"]["rows_per_s"] > 0
