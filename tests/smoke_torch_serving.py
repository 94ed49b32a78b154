"""The port's serving-gateway SLO smoke: open-loop traffic against a
3-replica fleet of `repro_torch` InfServer processes (real processes, real
RPC), one replica SIGKILLed mid-run. Counterpart of
`tests/smoke_serving.py`.

Not a pytest module (real kill -9 semantics across processes):

    PYTHONPATH=src python tests/smoke_torch_serving.py            # on the card
    PYTHONPATH=src python tests/smoke_torch_serving.py --device cpu

Pass criteria, the twin's:

  * availability >= 0.95: answered / attempted over the whole run,
    INCLUDING the kill window (the gateway fails tickets over to the
    survivors, so one replica's death should cost ~nothing);
  * the le_2000ms deadline bucket holds its SLO: hit rate >= 0.95 and
    p99 <= the 2 s deadline;
  * the gateway noticed: exactly one replica marked dead, the others
    alive.

Each replica answers a warm-up flush at every bucket the traffic can hit
before the traffic starts, so no first call lands inside a deadline. The
last line is one JSON object: availability, the bucket's hit rate and p99,
fail-overs, the victim, and each surviving replica's kernel launches from
the `{"process": "replica", ...}` line it prints at SIGTERM. `--device`
(CUDA by default, raising without a card) goes to every replica.
"""
import argparse
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_smoke_lib as lib  # noqa: E402

REPLICAS = 3
RUN_S = 10.0
KILL_AT_S = 4.0
DEADLINE_S = 2.0
THREADS = 4
REQ_PER_S_PER_THREAD = 8.0
ROWS = 4
OBS_LEN = 2                       # rps observations


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = lib.device_of(args.device)
    fields = {}
    ok = False
    try:
        ok = scenario(device, fields)
    finally:
        print(f"[smoke] serving smoke {'OK' if ok else 'FAIL'}", flush=True)
        lib.result("serving", ok, device=device, **fields)
    return 0 if ok else 1


def scenario(device: str, fields: dict) -> bool:
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core import ModelKey
    from repro_torch.models import init_params
    from repro_torch.params.manifest import build_manifest
    from repro_torch.serving import ServingGateway
    from repro_torch.serving.fleet import connect, shutdown, spawn_fleet

    t_start = time.monotonic()
    cfg = get_arch("tleague-policy-s")
    params = init_params(torch.Generator(device=device).manual_seed(0), cfg)
    keys = [ModelKey("main", 0), ModelKey("exploiter", 0)]
    manifest = build_manifest(params, version=0)

    print(f"[smoke] spawning {REPLICAS} replica processes ...", flush=True)
    fleet = spawn_fleet(REPLICAS, arch="tleague-policy-s", env_name="rps",
                        max_batch=64, device=device, startup_timeout_s=120.0)
    fields["spawn_s"] = time.monotonic() - t_start
    victim = None
    try:
        gw = ServingGateway([connect(r.address) for r in fleet],
                            router="lineage", failover_retries=3,
                            deadline_edges_s=(0.5, DEADLINE_S),
                            max_inflight_rows=8192,
                            pump_interval_s=0.01).start()
        for key in keys:
            rep = gw.rollout(key, params, manifest)
            print(f"[smoke] rollout {key}: shipped_to={rep['shipped_to']} "
                  f"({rep['propagation_ms']:.0f}ms)", flush=True)

        # every replica answers a flush at each bucket the traffic can hit
        # (4..32 rows coalesced) before the measured window
        t_warm = time.monotonic()
        for h in gw._handles:
            for n_sub in (1, 2, 4, 8):
                ts = [h.replica.submit(np.zeros((ROWS, OBS_LEN), np.int32),
                                       model=keys[0]) for _ in range(n_sub)]
                h.replica.flush()
                for t in ts:
                    h.replica.get(t)
        fields["warm_s"] = time.monotonic() - t_warm
        print("[smoke] fleet warmed; driving open-loop traffic", flush=True)

        stop = threading.Event()
        lock = threading.Lock()
        attempted = [0]
        answered = [0]
        errors = []

        def submitter(i):
            rng = np.random.default_rng(i)
            interval = 1.0 / REQ_PER_S_PER_THREAD
            nxt = time.perf_counter() + rng.uniform(0, interval)
            while not stop.is_set():
                lag = nxt - time.perf_counter()
                if lag > 0:
                    time.sleep(min(lag, 0.05))
                    continue
                nxt += interval
                obs = rng.integers(0, 3, (ROWS, OBS_LEN)).astype(np.int32)
                key = keys[int(rng.integers(len(keys)))]
                with lock:
                    attempted[0] += 1
                try:
                    t = gw.submit(obs, model=key, deadline_s=DEADLINE_S)
                    gw.get(t)
                    with lock:
                        answered[0] += 1
                except Exception as e:            # shed / failover exhausted
                    with lock:
                        errors.append(repr(e))

        threads = [threading.Thread(target=submitter, args=(i,))
                   for i in range(THREADS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()

        time.sleep(KILL_AT_S)
        victim = max(gw.stats()["replicas"],
                     key=lambda r: r["routed_requests"])["replica"]
        print(f"[smoke] kill -9 replica {victim} "
              f"(pid {fleet[victim].proc.pid})", flush=True)
        fleet[victim].kill()

        time.sleep(RUN_S - KILL_AT_S)
        stop.set()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        gw.stop()

        st = gw.stats()
        availability = answered[0] / max(attempted[0], 1)
        bucket = gw.deadlines.label(DEADLINE_S)
        slo = st["deadlines"].get(bucket, {"hit_rate": 0.0, "p99_ms": 1e9,
                                           "count": 0})
        print(f"[smoke] {attempted[0]} attempted, {answered[0]} answered "
              f"in {wall:.1f}s -> availability {availability:.3f}",
              flush=True)
        print(f"[smoke] {bucket}: count={slo['count']} "
              f"hit_rate={slo['hit_rate']:.3f} p99={slo['p99_ms']:.0f}ms; "
              f"failovers={st['failovers']} died={st['replicas_died']} "
              f"shed={st['shed_requests']}", flush=True)
        if errors:
            print(f"[smoke] {len(errors)} request errors, first: "
                  f"{errors[0]}", flush=True)
        fields.update(attempted=attempted[0], answered=answered[0], wall_s=wall,
                      availability=availability, bucket=bucket, slo=slo,
                      failovers=st["failovers"], replicas_died=st["replicas_died"],
                      alive_replicas=st["alive_replicas"], shed=st["shed_requests"],
                      victim=victim, errors=len(errors))
        checks = [(availability >= 0.95, f"availability {availability:.3f} < 0.95"),
                  (slo["count"] > 0, "no requests recorded in the SLO bucket"),
                  (slo["hit_rate"] >= 0.95, f"deadline hit rate {slo['hit_rate']:.3f} < 0.95"),
                  (slo["p99_ms"] <= DEADLINE_S * 1e3,
                   f"p99 {slo['p99_ms']:.0f}ms over the {DEADLINE_S * 1e3:.0f}ms SLO"),
                  (st["replicas_died"] == 1,
                   f"expected exactly 1 dead replica, saw {st['replicas_died']}"),
                  (st["alive_replicas"] == REPLICAS - 1,
                   f"{st['alive_replicas']} replicas alive")]
        for good, what in checks:
            if not good:
                print(f"[smoke] FAIL: {what}", flush=True)
        return all(good for good, _ in checks)
    finally:
        shutdown(fleet)
        # each surviving replica prints its stats and kernel launches at SIGTERM
        fields["processes"] = {}
        for i, r in enumerate(fleet):
            recs = lib.records(r.proc.stdout.read().splitlines())
            fields["processes"][f"replica{i}"] = {
                "pid": r.proc.pid, "rc": r.proc.returncode, "killed": i == victim,
                "kernels": recs[-1]["kernels"] if recs else None}
        fields["seconds"] = time.monotonic() - t_start


if __name__ == "__main__":
    raise SystemExit(main())
