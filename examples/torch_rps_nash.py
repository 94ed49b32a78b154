"""The paper's §3.1 motivating claim on the PyTorch port: on
Rock-Paper-Scissors, INDEPENDENT RL circulates (pure-rock -> pure-paper ->
pure-scissors, forgetting how to beat older policies), while FICTITIOUS
SELF-PLAY (opponent sampled from the historical pool) converges toward the
uniform Nash equilibrium. Counterpart of `examples/rps_nash.py`; runs on
the card unless `--device cpu` is given.

  PYTHONPATH=src python examples/torch_rps_nash.py [--iters 30] [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.actors import Actor
from repro_torch.actors.policy import make_obs_policy
from repro_torch.configs import get_arch
from repro_torch.core import LeagueMgr, UniformGameMgr
from repro_torch.core.game_mgr import GameMgr, register_game_mgr
from repro_torch.envs import make_env
from repro_torch.learners import Learner, build_env_train_step
from repro_torch.models import init_params
from repro_torch.optim import adamw
from repro_torch.utils import resolve_device, tree_leaves


@register_game_mgr("independent")       # re-registering replaces the entry
class IndependentGameMgr(GameMgr):
    """Independent RL: always play the CURRENT opponent (no pool mixing)."""

    def get_opponent(self, learner_key, candidates):
        return learner_key


@torch.no_grad()
def action_distribution(cfg, env, params):
    policy = make_obs_policy(cfg, env.spec.num_actions)
    dev = tree_leaves(params)[0].device
    # observation at episode start: opponent_last=3 (none), parity token 4
    obs = torch.tensor([[3, 4]], dtype=torch.int32, device=dev)
    lg, _ = policy.logits_values(params, obs)
    return torch.softmax(lg[0].float(), -1).cpu().numpy()


def run(mode, iters, freeze_every=4, seed=0, device=None):
    dev = resolve_device(device)
    cfg = get_arch("tleague-policy-s")
    env = make_env("rps", device=dev, episode_len=4)
    params = init_params(torch.Generator(device=dev).manual_seed(seed), cfg)
    league = LeagueMgr(seed=seed)
    gm = (IndependentGameMgr() if mode == "independent"
          else UniformGameMgr(recent_n=50))
    league.add_learning_agent("main", params, game_mgr=gm)
    actor = Actor(env, cfg, league, num_envs=32, unroll_len=8, seed=seed, device=dev)
    opt = adamw(1e-3, clip_norm=1.0)
    step = build_env_train_step(cfg, env.spec.num_actions, opt)
    learner = Learner(league, step, opt, params, device=dev)

    dists = []
    for it in range(iters):
        traj, _ = actor.run_segment()
        learner.data_server.put(traj)
        learner.learn()
        if (it + 1) % freeze_every == 0:
            learner.end_learning_period()
        dists.append(action_distribution(cfg, env, learner.params))
    return np.stack(dists)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    print("=== independent RL (expected: circulation / collapse) ===")
    d_ind = run("independent", args.iters, device=args.device)
    print("=== FSP via league (expected: -> uniform NE [1/3,1/3,1/3]) ===")
    d_fsp = run("fsp", args.iters, device=args.device)

    out = {}
    for name, d in [("independent", d_ind), ("fsp", d_fsp)]:
        tail = d[-5:].mean(0)
        dev = np.abs(tail - 1 / 3).max()
        peak = d.max(1).mean()   # how 'pure' the policy tends to be
        print(f"{name:12}: final dist={np.round(tail, 3)} "
              f"max|p - 1/3|={dev:.3f} avg peak prob={peak:.3f}")
        out[name] = {"dists": d, "final": tail, "max_dev": float(dev),
                     "avg_peak": float(peak)}
    print("(FSP should sit closer to uniform; independent RL drifts to "
          "near-pure strategies and cycles between freezes.)")
    return out


if __name__ == "__main__":
    main()
