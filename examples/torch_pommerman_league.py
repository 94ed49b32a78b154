"""End-to-end driver on the PyTorch port (paper §4.3): 2v2 Pommerman-lite
team CSP training with the AlphaStar-style 35% self-play / 65% PFSP
mixture, built from a LeagueSpec — one `main` role plus one
`minimax_exploiter` (the data-efficient exploiter curriculum of
arXiv:2311.17190) — with periodic freezes, exploiter reset-on-freeze, PBT
hyper perturbation, and a win-rate evaluation vs the scripted SimpleAgent
after every period (the paper's Fig. 4 curve). Counterpart of
`examples/pommerman_league.py`; runs on the card unless `--device cpu` is
given.

  PYTHONPATH=src python examples/torch_pommerman_league.py --periods 3 --steps 24

`--async-seconds N` swaps the deterministic lockstep loop for the
event-driven league runtime (threads + winrate-gated freezes) for N
seconds per period instead.
"""
import argparse

import numpy as np

from repro_torch.configs import get_arch
from repro_torch.core import FreezeGate
from repro_torch.envs import make_env
from repro_torch.envs.scripted import pommerman_simple_bot
from repro_torch.eval import learned_policy_fn, play_episodes, winrate_vs
from repro_torch.launch.train import run_league_training, run_league_training_async
from repro_torch.league import LeagueSpec, RoleSpec
from repro_torch.utils import resolve_device


def build_spec(steps_per_period: int) -> LeagueSpec:
    """One main + one minimax exploiter chasing it. The gate freezes on
    pool winrate >= tau (or a step timeout), and the exploiter restarts
    from its seed at every freeze (AlphaStar reset semantics)."""
    return LeagueSpec(roles=(
        RoleSpec(name="main", role="main",
                 gate=FreezeGate(winrate=0.7, min_games=16, min_steps=8,
                                 timeout_steps=max(8, steps_per_period))),
        RoleSpec(name="exploiter:0", role="minimax_exploiter", target="main",
                 matchmaking_kwargs={"beat_threshold": 0.6},
                 gate=FreezeGate(winrate=0.6, min_games=16, min_steps=8,
                                 timeout_steps=max(8, steps_per_period))),
    ))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--periods", type=int, default=2)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--envs", type=int, default=8)
    ap.add_argument("--eval-episodes", type=int, default=8)
    ap.add_argument("--async-seconds", type=float, default=None,
                    help="run the event-driven runtime for this many "
                         "seconds per period instead of the lockstep loop")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    curve, states = [], []
    cfg = get_arch("tleague-policy-s")
    env = make_env("pommerman_lite", device=dev)
    spec = build_spec(args.steps)

    for p in range(args.periods):
        if args.async_seconds:
            league, runtime, report = run_league_training_async(
                spec, env_name="pommerman_lite", arch="tleague-policy-s",
                num_envs=args.envs, unroll_len=16, pbt=True,
                max_seconds=args.async_seconds * (p + 1),
                verbose=(p == 0), device=dev)
            learner = runtime.roles[0].learner.learner
        else:
            league, agents, _ = run_league_training(
                env_name="pommerman_lite", arch="tleague-policy-s",
                periods=p + 1, steps_per_period=args.steps,
                num_envs=args.envs, unroll_len=16, pbt=True,
                league_spec=spec, verbose=(p == 0), device=dev)
            _, learner = agents["main"]
        me = learned_policy_fn(cfg, env.spec.num_actions, learner.params, device=dev)
        res = play_episodes(env, [me, me, pommerman_simple_bot,
                                  pommerman_simple_bot],
                            episodes=args.eval_episodes, seed=100 + p)
        wr = winrate_vs(res["outcomes"])
        curve.append(wr)
        states.append(league.league_state())
        print(f"[fig4] after {p+1} periods: winrate vs SimpleAgent = {wr:.2f} "
              f"(outcomes {res['outcomes'].tolist()})")
        print(f"       league: {states[-1]}")

    print("win-rate curve:", np.round(curve, 2).tolist())
    return {"curve": curve, "league_states": states}


if __name__ == "__main__":
    main()
