#!/usr/bin/env python3
"""Actor and learner processes sharing one card, with nothing else running.

    python3 tools/card_procs.py [--mix A,L ...] [--seconds 6]

The multiprocess league runs every actor and every learner in a process
of its own, all on one card. This measures what such processes get from
the card and the host when only they run: for each mix of A actor and L
learner processes, the children (fresh interpreters, the port on
PYTHONPATH) each build their work, warm it up, wait until all are ready,
then repeat it for `--seconds`, timing each unit on the host clock
between `torch.cuda.synchronize()`s (the two warm-up units' times are
reported apart: the first call of each kind loads the card's libraries):

- an actor: `Actor.run_segment` over a league of its own (pommerman_lite,
  16 envs x unroll 16, tleague-policy-s with bf16 compute, as
  `launch/train.py`'s defaults);
- a learner: one env train step (PPO + GAE, adamw) on a 32 x 16 segment
  of 26-token observations, the step `launch.distributed.run_learner`
  takes per segment, without the DataServer or the RPC around it.

Each child also reports its process's CPU time over those seconds
(`time.process_time`): a share near 1 is a busy host thread, a low one a
process that waits. Prints one JSON line per mix: per kind, each child's
median unit ms, unit count and CPU share, and the actors' summed frames/s
(256 frames per segment), with the card's name, power limit and compute
mode. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ENVS, UNROLL = 16, 16
ROWS = 2 * ENVS                       # pommerman_lite's team of 2: learner rows per segment
OBS_LEN, NUM_ACTIONS = 26, 6


def _actor_unit(seed):
    import torch

    from repro_torch.actors import Actor
    from repro_torch.configs import get_arch
    from repro_torch.core import LeagueMgr, SelfPlayPFSPGameMgr
    from repro_torch.envs import make_env
    from repro_torch.models import init_params

    dev = torch.device("cuda")
    cfg = get_arch("tleague-policy-s")
    league = LeagueMgr(seed=seed)
    league.add_learning_agent(
        "main", init_params(torch.Generator(device=dev).manual_seed(seed), cfg),
        game_mgr=SelfPlayPFSPGameMgr(payoff=None))
    actor = Actor(make_env("pommerman_lite", device=dev), cfg, league, num_envs=ENVS,
                  unroll_len=UNROLL, seed=seed, device=dev)
    return actor.run_segment


def _learner_unit(seed):
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.learners import build_env_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import adamw

    dev = torch.device("cuda")
    cfg = get_arch("tleague-policy-s")
    rng = np.random.default_rng(seed)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in {
        "obs": rng.integers(0, 16, (ROWS, UNROLL, OBS_LEN)).astype(np.int64),
        "actions": rng.integers(0, NUM_ACTIONS, (ROWS, UNROLL)).astype(np.int64),
        "behavior_logp": (-np.abs(rng.normal(size=(ROWS, UNROLL))) - 1.0).astype(np.float32),
        "behavior_values": rng.normal(size=(ROWS, UNROLL)).astype(np.float32),
        "rewards": rng.normal(size=(ROWS, UNROLL)).astype(np.float32),
        "done": rng.random((ROWS, UNROLL)) < 0.05,
        "bootstrap_value": rng.normal(size=(ROWS,)).astype(np.float32)}.items()}
    opt = adamw(3e-4, clip_norm=1.0)
    step = build_env_train_step(cfg, NUM_ACTIONS, opt)
    state = [init_params(torch.Generator(device=dev).manual_seed(seed), cfg)]
    state.append(opt.init(state[0]))

    def unit():
        state[0], state[1], _ = step(state[0], state[1], batch)
    return unit


def child(kind: str, seconds: float, seed: int) -> None:
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    unit = (_actor_unit if kind == "actor" else _learner_unit)(seed)
    warm = []
    for _ in range(2):                                   # warm-up: kernels, cuBLAS
        s = time.perf_counter()
        unit()
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - s)
    print("READY", flush=True)
    sys.stdin.readline()                                 # every child starts together
    walls = []
    cpu0, t0 = time.process_time(), time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        torch.cuda.synchronize()
        s = time.perf_counter()
        unit()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - s))
    cpu, wall = time.process_time() - cpu0, time.perf_counter() - t0
    print(json.dumps({"unit_ms": walls, "cpu_s": cpu, "wall_s": wall, "warmup_s": warm}),
          flush=True)


def run(actors: int, learners: int, seconds: float, env: dict) -> dict:
    kinds = ["actor"] * actors + ["learner"] * learners
    procs = [subprocess.Popen([sys.executable, __file__, "--child", kind, "--seconds",
                               str(seconds), "--seed", str(i)], stdin=subprocess.PIPE,
                              stdout=subprocess.PIPE, text=True, env=env)
             for i, kind in enumerate(kinds)]
    try:
        for p in procs:
            line = p.stdout.readline()
            if line.strip() != "READY":
                raise RuntimeError(f"child failed before its work: {line!r}")
        for p in procs:
            p.stdin.write("GO\n")
            p.stdin.flush()
        outs = [json.loads(p.communicate(timeout=600)[0].strip().splitlines()[-1])
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    res = {"actors": actors, "learners": learners}
    for kind in ("actor", "learner"):
        mine = [o for k, o in zip(kinds, outs) if k == kind]
        if mine:
            res[kind] = {"unit_ms_median": [statistics.median(o["unit_ms"]) for o in mine],
                         "units": [len(o["unit_ms"]) for o in mine],
                         "warmup_s": [o["warmup_s"] for o in mine],
                         "cpu_share": [o["cpu_s"] / o["wall_s"] for o in mine]}
    if actors:
        res["actor_frames_per_s_summed"] = sum(
            ENVS * UNROLL / m * 1e3 for m in res["actor"]["unit_ms_median"])
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mix", nargs="+", default=["1,0", "2,0", "4,0", "0,1", "0,2", "2,2", "4,2"],
                    help="A,L: A actor and L learner processes at once")
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--child", choices=("actor", "learner"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if args.child:
        child(args.child, args.seconds, args.seed)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,compute_mode",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for mix in args.mix:
        a, l = (int(x) for x in mix.split(","))
        print(json.dumps({"tool": "card_procs", "card": smi, "cpu_count": os.cpu_count(),
                          **run(a, l, args.seconds, env)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
