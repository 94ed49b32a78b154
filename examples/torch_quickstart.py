"""Quickstart on the PyTorch port: the full TLeague loop in ~40 lines.

Builds a league (LeagueMgr + ModelPool + HyperMgr + PFSP GameMgr), one Actor
producing trajectories against sampled opponents, one PPO Learner consuming
them, runs two learning periods with freezes, and prints the league state +
throughput (the paper's rfps/cfps). Counterpart of `examples/quickstart.py`;
runs on the card unless `--device cpu` is given.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import torch

from repro_torch.actors import Actor
from repro_torch.configs import get_arch
from repro_torch.core import LeagueMgr, SelfPlayPFSPGameMgr
from repro_torch.envs import make_env
from repro_torch.learners import Learner, build_env_train_step
from repro_torch.models import init_params
from repro_torch.optim import adamw
from repro_torch.utils import resolve_device


def train(actor, learner, periods, iters):
    """The loop: `iters` iterations of segment -> put -> learn per learning
    period, then a freeze. Returns the losses and entropies."""
    losses, entropies = [], []
    for period in range(periods):
        for it in range(iters):
            traj, task = actor.run_segment()    # Actor: request task, rollout
            learner.data_server.put(traj)       # ship the segment
            metrics = learner.learn()           # Learner: consume + SGD
            losses.append(metrics["loss"].item())
            entropies.append(metrics["entropy"].item())
            if it % 4 == 0:
                print(f"period {period} it {it}: loss={losses[-1]:.3f} "
                      f"entropy={entropies[-1]:.3f} opp={task.opponent_keys[0]}")
        new_key = learner.end_learning_period() # freeze theta into the pool
        print(f"period {period} done -> now training {new_key}")
    return losses, entropies


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--periods", type=int, default=2)
    ap.add_argument("--iters", type=int, default=8)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_arch("tleague-policy-s")          # TPolicies-scale policy net
    env = make_env("rps", device=dev)           # §3.1's motivating game
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg)

    league = LeagueMgr()
    league.add_learning_agent("main", params,
                              game_mgr=SelfPlayPFSPGameMgr(payoff=None))
    actor = Actor(env, cfg, league, num_envs=16, unroll_len=8, device=dev)
    opt = adamw(3e-4, clip_norm=1.0)
    train_step = build_env_train_step(cfg, env.spec.num_actions, opt)
    learner = Learner(league, train_step, opt, params, device=dev)

    losses, entropies = train(actor, learner, args.periods, args.iters)

    state = league.league_state()
    throughput = learner.data_server.throughput()
    print("league state:", state)
    print("throughput:", throughput)
    return {"losses": losses, "entropies": entropies, "league": state,
            "throughput": throughput, "learner_steps": learner.step_count,
            "unroll_len": actor.unroll_len}


if __name__ == "__main__":
    main()
