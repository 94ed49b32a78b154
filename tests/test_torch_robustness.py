"""The port's robustness plane against `repro`'s, on the CPU: the cases of
`tests/test_robustness.py` that no other `test_torch_*` file holds, each
run as one script through both packages, whose lease counters
(`lease_state()`) and InfServer counters (`stats()`) must be equal, and
hold the twin's own assertions.

- Leases: reap, re-issue and the generation guard; a dead actor reaped
  before its deadline; `touch_actor` extending a deadline; a re-issue that
  skips a template quoting a frozen learner key; no lease state without a
  TTL.
- Slow against dead: the `BeatRegistry` split, a brief stall that must not
  reap, and a lease reaped during a long stall that stays reaped.
- Ticket expiry: abandoned results expire; collected and discarded
  tickets never do.
- The kill-coordinator scenario on the CPU (`smoke_torch_kill_coordinator`,
  real processes, SIGSTOP), bounded in time, its children gone after it.

The chaos and serving smokes stay out of tier-1: their thresholds are
timings, not steady under several test workers.
"""
import json
import os
import time
import types

import jax
import numpy as np
import pytest
import torch

import repro.core as jax_core
import repro.distributed.heartbeat as jax_heartbeat
import repro_torch.core as core
import repro_torch.distributed.heartbeat as heartbeat
from repro.configs import get_arch as jax_arch
from repro.infserver import InfServer as JaxInfServer
from repro.models import init_params as jax_init
from repro_torch.configs import get_arch
from repro_torch.infserver import InfServer
from repro_torch.params import from_reference

JAX = types.SimpleNamespace(core=jax_core, hb=jax_heartbeat, params=lambda p: p)
PORT = types.SimpleNamespace(core=core, hb=heartbeat,
                             params=lambda p: {k: torch.from_numpy(v) for k, v in p.items()})


def _small_params(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(16, 16)).astype(np.float32),
            "b": rng.normal(size=(16,)).astype(np.float32)}


def _league(pkg, ttl=30.0):
    lg = pkg.core.LeagueMgr(lease_ttl_s=ttl)
    lg.add_learning_agent("main", pkg.params(_small_params()))
    return lg


def _result(pkg, task, outcome=1.0):
    return pkg.core.MatchResult(learner_key=task.learner_key,
                                opponent_keys=task.opponent_keys, outcome=outcome,
                                episode_len=1, task_id=task.task_id)


# -- the scripts, one per case of tests/test_robustness.py --------------------
def reap_reissue_and_generation_guard(pkg):
    lg = _league(pkg, ttl=0.01)
    t1 = lg.request_task("main", actor_id="dead")
    reaped = [l.task_id for l in lg.reap_leases(now=time.monotonic() + 1.0)]
    t2 = lg.request_task("main", actor_id="spare")
    pair = (t1.learner_key, t1.opponent_keys[0])
    games_before = lg.payoff.games(*pair)
    lg.report_result(_result(pkg, t1))                # late, from the presumed dead
    games_after_late = lg.payoff.games(*pair)
    lg.report_result(_result(pkg, t2))
    return {"reaped_is_t1": reaped == [t1.task_id], "new_id": t2.task_id != t1.task_id,
            "same_match": [str(k) for k in t2.opponent_keys] == [str(k) for k in t1.opponent_keys],
            "payoff_untouched": games_after_late == games_before,
            "leases": lg.lease_state()}


def dead_actor_reaped_before_deadline(pkg):
    lg = _league(pkg, ttl=60.0)
    lg.request_task("main", actor_id="gone")
    return {"reaped": len(lg.reap_leases(dead_actors=["gone"])), "leases": lg.lease_state()}


def touch_extends_deadline(pkg):
    lg = _league(pkg, ttl=0.05)
    lg.request_task("main", actor_id="slow")
    future = time.monotonic() + 1.0
    lg.touch_actor("slow", now=future)
    before = len(lg.reap_leases(now=future + 0.04))   # extended past the TTL
    after = len(lg.reap_leases(now=future + 0.06))    # but not forever
    return {"reaped_inside": before, "reaped_past": after, "leases": lg.lease_state()}


def reissue_skips_stale_learner_key(pkg):
    lg = _league(pkg, ttl=0.01)
    t1 = lg.request_task("main", actor_id="dead")
    lg.reap_leases(now=time.monotonic() + 1.0)
    lg.end_learning_period("main", pkg.params(_small_params(1)))   # lineage froze
    t2 = lg.request_task("main", actor_id="spare")
    return {"fresh_key": str(t2.learner_key) != str(t1.learner_key),
            "leases": lg.lease_state()}


def legacy_mode_keeps_no_lease_state(pkg):
    lg = pkg.core.LeagueMgr()                                      # lease_ttl_s=None
    lg.add_learning_agent("main", pkg.params(_small_params()))
    t = lg.request_task("main", actor_id="a0")
    issued = lg.lease_state()["issued"]
    reaped = lg.reap_leases()
    lg.report_result(_result(pkg, t))                              # accepted, no guard
    return {"issued": issued, "reaped": len(reaped), "leases": lg.lease_state()}


def beat_registry_split(pkg):
    reg = pkg.hb.BeatRegistry()
    reg.beat("fast")
    reg.beat("slow")
    out = {"first": [sorted(x) for x in reg.split(stale_s=10.0)]}
    time.sleep(0.05)
    reg.beat("fast")
    out["stalled"] = [sorted(x) for x in reg.split(stale_s=0.04)]
    reg.beat("slow")                                               # woke back up
    out["woke"] = sorted(reg.split(stale_s=0.04)[0])
    reg.forget("slow")
    out["len"] = len(reg)
    return out


def stalled_worker_is_not_declared_dead_early(pkg):
    lg = _league(pkg, ttl=10.0)
    reg = pkg.hb.BeatRegistry()
    lg.request_task("main", actor_id="stalled")
    reg.beat("stalled")
    time.sleep(0.1)                                                # the brief stall
    alive, stale = reg.split(stale_s=10.0)
    for a in alive:
        lg.touch_actor(a)
    reaped = lg.reap_leases(dead_actors=stale)
    return {"alive": alive, "stale": stale, "reaped": len(reaped), "leases": lg.lease_state()}


def lease_reaped_during_long_stall_stays_reaped(pkg):
    lg = _league(pkg, ttl=10.0)
    reg = pkg.hb.BeatRegistry()
    t1 = lg.request_task("main", actor_id="stalled")
    reg.beat("stalled")
    time.sleep(0.06)
    _, stale = reg.split(stale_s=0.05)                             # stall > threshold
    reaped = len(lg.reap_leases(dead_actors=stale))
    t2 = lg.request_task("main", actor_id="spare")                 # re-issued match
    reg.beat("stalled")                                            # SIGCONT: resumes
    lg.report_result(_result(pkg, t1))                             # late result
    dropped = lg.lease_state()["dropped_results"]
    lg.report_result(_result(pkg, t2))
    return {"stale": stale, "reaped": reaped, "dropped_after_late": dropped,
            "leases": lg.lease_state()}


LEASE_CASES = {
    "reap_reissue_and_generation_guard": (
        reap_reissue_and_generation_guard,
        lambda o: (o["reaped_is_t1"] and o["new_id"] and o["same_match"]
                   and o["payoff_untouched"] and o["leases"]["reissued"] == 1
                   and o["leases"]["dropped_results"] == 1
                   and o["leases"]["completed"] == 1)),
    "dead_actor_reaped_before_deadline": (
        dead_actor_reaped_before_deadline,
        lambda o: o["reaped"] == 1 and o["leases"]["reaped"] == 1),
    "touch_extends_deadline": (
        touch_extends_deadline, lambda o: o["reaped_inside"] == 0 and o["reaped_past"] == 1),
    "reissue_skips_stale_learner_key": (
        reissue_skips_stale_learner_key,
        lambda o: (o["fresh_key"] and o["leases"]["reissued"] == 0
                   and o["leases"]["reissue_queued"] == 0)),
    "legacy_mode_keeps_no_lease_state": (
        legacy_mode_keeps_no_lease_state,
        lambda o: (o["issued"] == 0 and o["reaped"] == 0
                   and o["leases"]["dropped_results"] == 0)),
    "beat_registry_split": (
        beat_registry_split,
        lambda o: (o["first"] == [["fast", "slow"], []]
                   and o["stalled"] == [["fast"], ["slow"]]
                   and o["woke"] == ["fast", "slow"] and o["len"] == 1)),
    "stalled_worker_is_not_declared_dead_early": (
        stalled_worker_is_not_declared_dead_early,
        lambda o: (o["alive"] == ["stalled"] and o["stale"] == [] and o["reaped"] == 0
                   and o["leases"]["outstanding"] == 1)),
    "lease_reaped_during_long_stall_stays_reaped": (
        lease_reaped_during_long_stall_stays_reaped,
        lambda o: (o["stale"] == ["stalled"] and o["reaped"] == 1
                   and o["dropped_after_late"] == 1 and o["leases"]["completed"] == 1)),
}


@pytest.mark.parametrize("case", sorted(LEASE_CASES))
def test_lease_and_liveness_script_matches_repro(case):
    script, twin_holds = LEASE_CASES[case]
    ref, got = script(JAX), script(PORT)
    assert got == ref
    assert twin_holds(got), got


# -- InfServer ticket expiry --------------------------------------------------
INF_KEYS = ("tickets_expired", "results_held", "batches_run", "requests_served",
            "queue_depth", "models_hosted")


def abandoned_results_expire(server):
    obs = np.zeros((1, 26), np.int32)
    dead = server.submit(obs)
    server.flush()                                                 # resolved, unclaimed
    held = server.stats()["results_held"]
    for _ in range(2):                                             # owner misses 2 flushes
        server.get(server.submit(obs))
    try:
        server.get(dead)
        gone = False
    except KeyError:
        gone = True
    st = server.stats()
    return {"held_before": held, "gone": gone, **{k: st[k] for k in INF_KEYS}}


def collected_and_discarded_tickets_never_expire(server):
    obs = np.zeros((1, 26), np.int32)
    server.get(server.submit(obs))                                 # collected promptly
    server.discard(server.submit(obs))                             # politely dropped
    for _ in range(3):
        server.get(server.submit(obs))
    st = server.stats()
    return {k: st[k] for k in INF_KEYS}


@pytest.mark.parametrize("case,ttl", [("abandoned_results_expire", 2),
                                      ("collected_and_discarded_tickets_never_expire", 1)])
def test_ticket_expiry_matches_repro(case, ttl):
    script = {"abandoned_results_expire": abandoned_results_expire,
              "collected_and_discarded_tickets_never_expire":
                  collected_and_discarded_tickets_never_expire}[case]
    jcfg, tcfg = jax_arch("tleague-policy-s"), get_arch("tleague-policy-s")
    params = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(0), jcfg))
    ref = script(JaxInfServer(jcfg, 6, params, max_batch=64, ticket_ttl_flushes=ttl))
    got = script(InfServer(tcfg, 6, from_reference(params, "cpu"), device="cpu",
                           max_batch=64, ticket_ttl_flushes=ttl))
    assert got == ref
    if case == "abandoned_results_expire":
        assert got["held_before"] == 1 and got["gone"]
        assert got["tickets_expired"] == 1 and got["results_held"] == 0
    else:
        assert got["tickets_expired"] == 0


# -- the kill-coordinator scenario, real processes -----------------------------
@pytest.mark.timeout(90)
def test_kill_coordinator_smoke_on_cpu(monkeypatch, capsys):
    """`tests/smoke_torch_kill_coordinator.py` with `--device cpu`: the
    SIGSTOP'd coordinator's learner and actor exit 0 through the heartbeat
    timeout; the scenario is bounded to 55 s and its children are gone."""
    import smoke_torch_kill_coordinator as smoke

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    t0 = time.monotonic()
    rc = smoke.main(["--device", "cpu", "--timeout", "55"])
    seconds = time.monotonic() - t0
    out = capsys.readouterr().out
    res = json.loads(out.strip().splitlines()[-1])
    assert rc == 0 and res["ok"], out[-3000:]
    assert res["exit_codes"] == {"learner": 0, "actor": 0}
    assert res["heartbeat_timed_out"]
    assert res["learner_steps_at_fault"] >= 1
    for name, proc in res["processes"].items():
        with pytest.raises(ProcessLookupError):
            os.kill(proc["pid"], 0)                 # reaped: no orphan left
        if proc["kernels"] is not None:             # the CPU ran the plain versions
            assert sum(proc["kernels"]["launches"].values()) == 0, name
    assert seconds < 60, seconds


# -- chip_smoke.py's process plumbing -------------------------------------------
def _chip_smoke():
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke
    return chip_smoke


def _gone(pid, timeout=5.0):
    """The process `pid` has ended (no /proc entry, or a zombie left to
    whoever adopted it), waiting up to `timeout` s."""
    from pathlib import Path

    deadline = time.monotonic() + timeout
    while True:
        try:
            state = Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1].split()[0]
        except FileNotFoundError:
            return True
        if state == "Z" or time.monotonic() >= deadline:
            return state == "Z"
        time.sleep(0.05)


@pytest.mark.timeout(60)
def test_chip_smoke_run_commands_ends_the_whole_group(tmp_path):
    """`chip_smoke.run_commands` keeps a finished command's output, gives a
    command past its timeout rc None, and kills its whole process group: a
    grandchild that holds the pipe goes too."""
    import sys

    chip_smoke = _chip_smoke()
    pidfile = tmp_path / "grandchild.pid"
    slow = ("import subprocess, sys, time\n"
            "p = subprocess.Popen([sys.executable, '-c', 'import time; time.sleep(120)'])\n"
            f"open({str(pidfile)!r}, 'w').write(str(p.pid))\n"
            "print('started', flush=True)\n"
            "time.sleep(120)\n")
    runs = chip_smoke.run_commands({"quick": ([sys.executable, "-c", "print(7)"], 30.0),
                                    "slow": ([sys.executable, "-c", slow], 10.0)})
    assert runs["quick"]["rc"] == 0 and runs["quick"]["stdout"] == "7\n"
    assert runs["slow"]["rc"] is None and "started" in runs["slow"]["stdout"]
    assert 10.0 <= runs["slow"]["seconds"] < 40.0
    assert _gone(int(pidfile.read_text()))


def test_chip_smoke_league_procs_splits_shared_lines():
    """Two processes' result objects on one line of a shared pipe both
    count; other lines, and an object cut short by a kill, do not."""
    lines = ['{"process": "learner", "steps": 16}{"process": "actor", "actor": 0}',
             "[coordinator] done", '{"process": "actor", "actor": 1}',
             '{"process": "coordinator", "wall']
    procs = _chip_smoke().league_procs(lines)
    assert {k: [r.get("actor") for r in v] for k, v in procs.items()} == {
        "learner": [None], "actor": [0, 1]}
