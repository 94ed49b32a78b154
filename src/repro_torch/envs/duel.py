"""Duel: ViZDoom CIG-track-1-like FFA arena (paper §4.2 analogue);
counterpart of `repro.envs.duel`, batched over a leading slot axis E.

8-player FFA reduced to 4 agents on a 9x9 grid with pillars. Agents face a
direction, move forward, turn, or fire; a shot travels along the facing line
(range 5, blocked by pillars) and frags the first agent hit, who respawns at
the spawn farthest from the shooter. Score = FRAG. Episode ends after
`MAX_STEPS`; the info carries per-agent FRAGs.

`repro` unrolls the 4 agents and the 5 cells of each ray statically and XLA
fuses the result; eagerly that would be hundreds of small launches a step.
Here the views and the rays of all agents are tensor ops over (E, 4, ...),
and only what depends on order stays a loop of 4: forward moves (the lower
slot wins a conflict) and respawns (a victim respawns away from where its
shooter stands after the earlier victims' respawns). A shot hits the first
body along its ray, cell by cell and, within a cell, by slot, unless a
pillar stands on the ray at or before that cell; a victim shot by several
agents is credited to the lowest slot. That is `repro`'s sequential rule.
"""
from __future__ import annotations

import torch

from repro_torch.envs.base import ENVS, EnvSpec, MultiAgentEnv

N = 9
RANGE = 5
MAX_STEPS = 64
VIEW = 5
FACINGS = [[-1, 0], [0, 1], [1, 0], [0, -1]]          # N,E,S,W
SPAWNS = [[0, 0], [0, N - 1], [N - 1, 0], [N - 1, N - 1]]
PILLARS = [(3, 3), (3, 5), (5, 3), (5, 5), (4, 4)]
# actions: 0 idle, 1 forward, 2 turn-left, 3 turn-right, 4 fire


def make_duel(device: torch.device, frag_reward: float = 1.0,
              hit_penalty: float = 0.5) -> MultiAgentEnv:
    spec = EnvSpec(name="duel", num_agents=4, obs_len=VIEW * VIEW + 2,
                   num_actions=5, max_steps=MAX_STEPS, obs_vocab=16,
                   zero_sum=False)
    i32 = dict(dtype=torch.int32, device=device)
    facings = torch.tensor(FACINGS, **i32)
    spawns = torch.tensor(SPAWNS, **i32)
    pillars = torch.zeros((N, N), **i32)
    for r, c in PILLARS:
        pillars[r, c] = 1
    pillar = pillars.bool()
    view = torch.arange(VIEW, **i32) - VIEW // 2
    ray = torch.arange(1, RANGE + 1, **i32)
    eye = torch.eye(4, dtype=torch.bool, device=device)
    slots = torch.arange(4, **i32)
    # obs code of agent j in agent i's view: 4 self, 6 anyone else
    code = torch.where(eye, 4, 6).to(torch.int32)

    def _obs(state):
        pos, E = state["pos"], state["pos"].shape[0]
        rr = pos[:, :, 0, None, None] + view[:, None]          # (E, 4, 5, 1)
        cc = pos[:, :, 1, None, None] + view[None, :]          # (E, 4, 1, 5)
        inb = (rr >= 0) & (rr < N) & (cc >= 0) & (cc < N)      # (E, 4, 5, 5)
        cell = pillars[rr.clamp(0, N - 1), cc.clamp(0, N - 1)]
        for j in range(4):                                     # later slots draw over earlier
            here = (rr == pos[:, None, j, 0, None, None]) & (cc == pos[:, None, j, 1, None, None])
            cell = torch.where(here, code[:, j, None, None], cell)
        cell = torch.where(inb, cell, 7)
        return torch.cat([cell.reshape(E, 4, VIEW * VIEW), (8 + state["facing"])[..., None],
                          (12 + state["frags"].clamp(0, 3))[..., None]], dim=2)

    def reset(gen, num_envs):
        state = {"pos": spawns.expand(num_envs, 4, 2).clone(),
                 "facing": torch.tensor([2, 2, 0, 0], **i32).expand(num_envs, 4).clone(),
                 "frags": torch.zeros((num_envs, 4), **i32),
                 "t": torch.zeros((num_envs,), **i32)}
        return state, _obs(state)

    def step(state, actions, gen):
        pos, facing = state["pos"], state["facing"]
        # turns (floor-mod: -1 % 4 == 3)
        facing = torch.where(actions == 2, (facing - 1) % 4, facing)
        facing = torch.where(actions == 3, (facing + 1) % 4, facing)

        # forward moves (lower index wins conflicts)
        cand = (pos + facings[facing]).clamp(0, N - 1)                       # (E, 4, 2)
        free = ~pillar[cand[..., 0], cand[..., 1]]
        on_other = ((pos[:, None] == cand[:, :, None]).all(-1) & ~eye).any(-1)   # (E, 4)
        movable = (actions == 1) & free & ~on_other
        moved = []
        for i in range(4):
            ok = movable[:, i]
            if moved:
                ok = ok & ~(torch.stack(moved, 1) == cand[:, None, i]).all(-1).any(-1)
            moved.append(torch.where(ok[:, None], cand[:, i], pos[:, i]))
        pos = torch.stack(moved, 1)

        # fire: the first body on each shooter's ray, pillars block
        d = facings[facing]                                                  # (E, 4, 2)
        cells = pos[:, :, None] + d[:, :, None] * ray[:, None]               # (E, 4, 5, 2)
        inb = ((cells >= 0) & (cells < N)).all(-1)                           # (E, 4, 5)
        cells = cells.clamp(0, N - 1)
        blocked = torch.cumsum((inb & pillar[cells[..., 0], cells[..., 1]]).int(), -1) > 0
        here = (inb[..., None] & (pos[:, None, None] == cells[:, :, :, None]).all(-1)
                & ~eye[:, None, :])                                          # (E, i, k, j)
        first = here.flatten(2).int().argmax(-1)                             # k-major, then j
        k_hit, victim = first // 4, first % 4
        hit = ((actions == 4) & here.flatten(2).any(-1)
               & ~blocked.gather(2, k_hit[..., None])[..., 0])               # (E, shooter)
        shot = hit[..., None] & (victim[..., None] == slots)                 # (E, shooter, victim)
        hit_by = torch.where(shot.any(1), shot.int().argmax(1).int(), -1)    # (E, victim)

        rewards = torch.zeros(actions.shape, dtype=torch.float32, device=device)
        frags = state["frags"]
        pos = pos.clone()
        for j in range(4):
            was_hit = hit_by[:, j] >= 0
            shooter = hit_by[:, j].clamp(0, 3)
            credit = (slots == shooter[:, None]) & was_hit[:, None]
            frags = frags + credit.int()
            rewards = rewards + torch.where(credit, frag_reward, 0.0)
            rewards[:, j] += torch.where(was_hit, -hit_penalty, 0.0)
            # respawn the victim at the spawn farthest from the shooter
            at = pos.gather(1, shooter[:, None, None].expand(-1, 1, 2).long())    # (E, 1, 2)
            far = (spawns - at).abs().sum(-1).argmax(-1)
            pos[:, j] = torch.where(was_hit[:, None], spawns[far], pos[:, j])

        t = state["t"] + 1
        done = t >= MAX_STEPS
        best = frags.argmax(-1)
        outcome = torch.where(done & (best == 0), 1, torch.where(done, -1, torch.zeros_like(t)))
        new_state = {"pos": pos, "facing": facing, "frags": frags, "t": t}
        return new_state, _obs(new_state), rewards, done, {"frags": frags, "outcome": outcome}

    return MultiAgentEnv(spec, reset, step, device)


ENVS.register("duel", make_duel)
