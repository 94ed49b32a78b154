"""The port's kill-coordinator smoke: wedge the coordinator of a
`python -m repro_torch.launch.train` league mid-run and hold that its
worker processes exit CLEANLY through the heartbeat timeout instead of
hanging. Counterpart of `tests/smoke_kill_coordinator.py`.

Not a pytest module (real SIGSTOP semantics across processes):

    PYTHONPATH=src python tests/smoke_torch_kill_coordinator.py            # on the card
    PYTHONPATH=src python tests/smoke_torch_kill_coordinator.py --device cpu

The scenario SIGSTOPs the coordinator rather than killing it: a stopped
process keeps its sockets open and never sends RST, so only the heartbeat
monitor (`ctrl.ping` stops advancing) can unblock the workers, wherever
they wait (an RPC, the DataServer's ring, a CUDA sync). The learner and
the actor run with `--heartbeat-timeout 6`. The fault fires on an observed
event, not after a fixed sleep: the learner's first step and the actor's
first segment, read from the coordinator's `ctrl.progress`. Pass: both
workers exit 0 within the deadline and at least one says the heartbeat
timed out. The last line is one JSON object: the workers' exit codes and
exit times after the SIGSTOP, the learner's steps, and each worker's
kernel launches from its `{"process": ...}` line.

`--device` (CUDA by default, raising without a card) goes to every child.
"""
import argparse
import signal
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_smoke_lib as lib  # noqa: E402

SPEC = lib.REPO / "examples" / "league_specs" / "main_minimax.json"
COMMON = ["--env", "rps", "--num-envs", "4", "--unroll-len", "8"]
HEARTBEAT_TIMEOUT_S = 6


def spawn(name, args, device, t0):
    return lib.Child(name, [sys.executable, "-m", "repro_torch.launch.train"] + args
                     + COMMON + ["--device", device], t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds the whole scenario may take")
    args = ap.parse_args(argv)
    device = lib.device_of(args.device)
    t0 = time.monotonic()
    end = t0 + args.timeout
    left = lambda: max(1.0, end - time.monotonic())
    children = {}
    ok, fields = False, {}
    try:
        coord = children["coordinator"] = spawn(
            "coordinator", ["--role", "coordinator", "--league-spec", str(SPEC),
                            "--bind", "127.0.0.1:0", "--max-seconds", "300"], device, t0)
        address = coord.wait_for(r"serving league at (\S+)", min(120.0, left()))
        if address is None:
            raise RuntimeError(f"coordinator never announced its address:\n{coord.tail()}")
        print(f"[smoke] coordinator at {address} (pid {coord.pid})", flush=True)
        for role in ("learner", "actor"):
            children[role] = spawn(role, ["--role", role, "--league-role", "main",
                                          "--connect", address, "--heartbeat-timeout",
                                          str(HEARTBEAT_TIMEOUT_S)], device, t0)

        def warm():
            p = lib.progress(address)
            return p if (p and p["learner_steps"].get("main", 0) >= 1
                         and p["actor_segments"]) else None

        prog = lib.wait_until(warm, left())
        for name, c in children.items():
            if c.proc.poll() is not None:
                raise RuntimeError(f"{name} died before the fault:\n{c.tail()}")
        if not prog:
            raise RuntimeError("the league never made progress before the deadline")
        t_warm = time.monotonic() - t0
        print(f"[smoke] warm at {t_warm:.1f}s: {prog}; SIGSTOP coordinator "
              "(wedged: sockets open, no RST)", flush=True)
        coord.signal(signal.SIGSTOP)
        t_stop = time.monotonic() - t0

        codes = {}
        join_deadline = time.monotonic() + min(120.0, left())
        for name in ("learner", "actor"):
            rc = children[name].wait(join_deadline - time.monotonic())
            codes[name] = "HUNG" if rc is None else rc
        time.sleep(0.3)                          # let the drainers take the tail
        ok = True
        for name in ("learner", "actor"):
            c = children[name]
            print(f"[smoke] {name}: exit={codes[name]}", flush=True)
            print(f"--- {name} output tail ---\n{c.tail(10)}", flush=True)
            if codes[name] != 0:
                ok = False
        said = [n for n in ("learner", "actor") if "heartbeat timed out" in children[n].text()]
        if not said:
            print("[smoke] FAIL: no worker reported a heartbeat timeout", flush=True)
            ok = False
        learner = children["learner"].records()
        fields = {
            "warm_s": t_warm, "sigstop_s": t_stop, "progress_at_fault": prog,
            "exit_codes": codes, "heartbeat_timed_out": said,
            "exit_after_sigstop_s": {n: (None if children[n].exit_s is None
                                         else children[n].exit_s - t_stop)
                                     for n in ("learner", "actor")},
            "learner_steps_at_fault": prog["learner_steps"]["main"],
            "learner_steps": learner[-1]["steps"] if learner else None,
        }
    finally:
        for c in children.values():
            c.kill_group()
        fields["processes"] = {n: lib.report(c) for n, c in children.items()}
        fields["seconds"] = time.monotonic() - t0
        print(f"[smoke] {'PASS' if ok else 'FAIL'}", flush=True)
        lib.result("kill_coordinator", ok, device=device, **fields)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
