"""The port's chaos smoke: a `python -m repro_torch.launch.train` league of
4 actors and 1 pool read replica survives SIGKILLed workers, a killed pool
replica, a stalled (SIGSTOP'd) actor and seeded fault injection, and still
reaches its target learner steps with zero payoff corruption. Counterpart
of `tests/smoke_chaos.py`.

Not a pytest module (real kill -9 semantics across processes):

    PYTHONPATH=src python tests/smoke_torch_chaos.py            # on the card
    PYTHONPATH=src python tests/smoke_torch_chaos.py --device cpu

The scenario, as the twin's:
  1. The coordinator serves `collector_smoke.json`'s league with the lease
     plane armed (`--lease-ttl 2 --actor-stale 1.5`) and a seeded FaultPlan
     through the REPRO_FAULT_PLAN env seam (dropped pool pulls, delayed
     pings).
  2. A pool read replica follows the coordinator; the actors read params
     replica-first (`--pool-endpoints replica,coordinator`).
  3. Two actors and the replica are SIGKILLed: their leases go stale and
     are reaped and re-issued, the survivors' pool reads fail over.
  4. A third actor is SIGSTOP'd past the stale threshold, its lease reaped
     and re-issued while it is frozen, then SIGCONT'd: its late result
     arrives under a dead task_id and MUST be dropped by the generation
     guard (`dropped_results`), never counted into the payoff matrix.
  5. The coordinator reaches `--max-steps` and exits 0; the survivors
     exit 0.

Unlike the twin, the faults fire on observed events, not after a fixed
sleep: once every actor has finished its first segment and the learner has
taken its first step (read from the coordinator's `ctrl.progress`); the
port's processes take ~20 s to start on the card and a learner's first
step several seconds more. A warm learner on the card also steps far
faster than on a CPU, so the target is sized per device (`TARGET_STEPS`,
on the card from measured step rates) for the run to outlive the
SIGCONT. Actor 3 is never faulted: the smoke fails if a reap
after the faults' trigger names it, as a lease's holder or as stale.

The last line is one JSON object: the lease counts, the reaped leases'
holders and the stale actor ids the coordinator printed at each reap
(with the seconds), the fault plan's
counts, the learner steps, each survivor's exit code and time, and each
child's kernel launches from its `{"process": ...}` line. `--device` (CUDA
by default, raising without a card) goes to every child.
"""
import argparse
import ast
import json
import re
import signal
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_smoke_lib as lib  # noqa: E402

SPEC = lib.REPO / "examples" / "league_specs" / "collector_smoke.json"
COMMON = ["--env", "rps", "--num-envs", "4", "--unroll-len", "8"]
ACTORS = 4
# learner steps the coordinator waits for. The run has to outlast the
# faults (kill, 2 s, stop, 6 s, continue) by at least 5 s at the rate the
# surviving actors feed the learner (the twin's 60 ran out before the
# SIGCONT on an 8-core host)
TARGET_STEPS = {"cpu": 300, "cuda": 400}
STALE_AFTER_KILL_S, STOP_S = 2.0, 6.0


def fault_plan():
    """Mild, bounded, seeded chaos: dropped pool pulls ride the idempotent
    retry path; delayed pings stress the slow-vs-dead discrimination."""
    from repro_torch.distributed.transport import FaultPlan, FaultRule
    return FaultPlan([FaultRule("pool.pull*", "drop", p=0.2, max_times=8),
                      FaultRule("ctrl.ping", "delay", delay_s=0.2, p=0.2, max_times=8)],
                     seed=1234)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = lib.device_of(args.device)
    target = TARGET_STEPS[device.split(":")[0]]
    fields = {"target_steps": target}
    ok = False
    try:
        ok = scenario(device, target, fields)
    finally:
        print(f"[chaos] {'PASS' if ok else 'FAIL'}", flush=True)
        lib.result("chaos", ok, device=device, **fields)
    return 0 if ok else 1


def scenario(device: str, target: int, fields: dict) -> bool:
    t0 = time.monotonic()
    children = {}

    def spawn(name, args, extra_env=None):
        children[name] = lib.Child(
            name, [sys.executable, "-m", "repro_torch.launch.train"] + args + COMMON
            + ["--device", device], t0, extra_env)
        return children[name]

    try:
        plan = fault_plan()
        coord = spawn("coordinator",
                      ["--role", "coordinator", "--league-spec", str(SPEC),
                       "--bind", "127.0.0.1:0", "--max-seconds", "240",
                       "--max-steps", str(target), "--lease-ttl", "2", "--actor-stale", "1.5"],
                      {"REPRO_FAULT_PLAN": plan.to_json()})
        address = coord.wait_for(r"serving league at (\S+)", 120.0)
        if address is None:
            raise RuntimeError(f"coordinator never announced:\n{coord.tail()}")
        print(f"[chaos] coordinator at {address} (pid {coord.pid})", flush=True)
        replica = spawn("pool-replica", ["--role", "pool-replica", "--connect", address,
                                         "--bind", "127.0.0.1:0", "--sync-interval", "0.2"])
        replica_addr = replica.wait_for(r"serving pool replica at (\S+)", 120.0)
        if replica_addr is None:
            raise RuntimeError(f"replica never announced:\n{replica.tail()}")
        print(f"[chaos] pool replica at {replica_addr} (pid {replica.pid})", flush=True)

        spawn("learner", ["--role", "learner", "--league-role", "main", "--connect", address,
                          "--pool-endpoints", f"{address},{replica_addr}"])
        for i in range(ACTORS):
            spawn(f"actor{i}", ["--role", "actor", "--league-role", "main",
                                "--actor-index", str(i), "--connect", address,
                                "--pool-endpoints", f"{replica_addr},{address}"])

        def warm():
            p = lib.progress(address)
            return p if (p and p["learner_steps"].get("main", 0) >= 1
                         and len(p["actor_segments"]) == ACTORS) else None

        prog = lib.wait_until(warm, 180.0)
        for name, c in children.items():
            if c.proc.poll() is not None:
                raise RuntimeError(f"{name} died before the chaos:\n{c.tail()}")
        if not prog:
            raise RuntimeError(f"the league never warmed up: {lib.progress(address)}")
        t_warm = time.monotonic() - t0
        fields.update(warm_s=t_warm, progress_at_warm=prog)
        print(f"[chaos] warm at {t_warm:.1f}s: {prog}", flush=True)

        print("[chaos] SIGKILL actors 0,1 + the pool replica", flush=True)
        for name in ("actor0", "actor1", "pool-replica"):
            children[name].signal(signal.SIGKILL)
        t_kill = time.monotonic() - t0
        time.sleep(STALE_AFTER_KILL_S)
        print("[chaos] SIGSTOP actor 2 past the stale threshold", flush=True)
        children["actor2"].signal(signal.SIGSTOP)
        t_stop = time.monotonic() - t0
        prog_stop = lib.progress(address)
        time.sleep(STOP_S)                 # > actor-stale + reap interval
        prog_cont = lib.progress(address)
        children["actor2"].signal(signal.SIGCONT)
        t_cont = time.monotonic() - t0
        print("[chaos] SIGCONT actor 2 (its reaped lease's late result must be "
              "dropped)", flush=True)
        fields.update(sigkill_s=t_kill, sigstop_s=t_stop, sigcont_s=t_cont,
                      progress_at_sigstop=prog_stop, progress_at_sigcont=prog_cont)

        ok = True
        if coord.wait(240.0) is None:
            print("[chaos] FAIL: coordinator never reached target steps", flush=True)
            return False
        ok = coord.proc.returncode == 0
        print(f"[chaos] coordinator exit={coord.proc.returncode}", flush=True)
        exits = {}
        for name in ("learner", "actor2", "actor3"):
            rc = children[name].wait(60.0)
            exits[name] = "HUNG" if rc is None else rc
            print(f"[chaos] {name}: exit={exits[name]}", flush=True)
            if rc != 0:
                ok = False
        time.sleep(0.5)                    # let the drainers catch the tail
        fields["survivor_exit_codes"] = exits
        print(f"--- coordinator output tail ---\n{coord.tail()}", flush=True)

        out = coord.text()
        done_s = next((t for t, line in coord.lines if "[coordinator] done:" in line), None)
        fields["run_after_sigcont_s"] = None if done_s is None else done_s - t_cont
        reaps = [(t, re.search(r"reaped (\d+) lease\(s\) of (\[.*?\]) \(stale actors: (\[.*\])\)",
                               line)) for t, line in coord.lines]
        # a holder None is a lease no actor named: the learner's period task
        fields["reaps"] = [{"s": t, "leases": int(m.group(1)),
                            "holders": ast.literal_eval(m.group(2)),
                            "stale": ast.literal_eval(m.group(3))} for t, m in reaps if m]
        late = [r for r in fields["reaps"]
                if r["s"] > t_warm and "main/3" in r["holders"] + r["stale"]]
        fields["actor3_reaped_after_warm"] = bool(late)
        if late:
            print(f"[chaos] FAIL: actor 3 (never faulted) reaped once warm: {late}", flush=True)
            ok = False
        if "fault plan armed" not in out:
            print("[chaos] FAIL: fault plan never armed", flush=True)
            ok = False
        m = re.search(r"\[coordinator\] done: (\{.*\})", out)
        if not m:
            print("[chaos] FAIL: no progress report", flush=True)
            ok = False
        else:
            steps = json.loads(m.group(1))["learner_steps"]
            fields["learner_steps"] = steps
            if steps.get("main", 0) < target:
                print(f"[chaos] FAIL: learner steps {steps} < {target}", flush=True)
                ok = False
        m = re.search(r"\[coordinator\] leases: (\{.*\})", out)
        if not m:
            print("[chaos] FAIL: no lease report", flush=True)
            ok = False
        else:
            leases = fields["leases"] = json.loads(m.group(1))
            print(f"[chaos] leases: {leases}", flush=True)
            # the SIGKILLed / SIGSTOP'd actors' leases were reaped and re-issued
            if leases["reaped"] < 1 or leases["reissued"] < 1:
                print("[chaos] FAIL: no lease was reaped+re-issued", flush=True)
                ok = False
            # zero payoff corruption: the stalled actor's late result for its
            # reaped lease was dropped by the generation guard
            if leases["dropped_results"] < 1:
                print("[chaos] FAIL: generation guard never fired "
                      "(late result not dropped)", flush=True)
                ok = False
        rec = next(iter(coord.records()), None)
        fields["faults"] = rec and rec.get("faults")
        return ok
    finally:
        for c in children.values():
            c.kill_group()
        fields["processes"] = {n: lib.report(c) for n, c in children.items()}
        fields["seconds"] = time.monotonic() - t0



if __name__ == "__main__":
    raise SystemExit(main())
