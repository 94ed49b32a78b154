"""Pommerman-lite: 2v2 Team-mode bomber gridworld (paper §4.3 analogue);
counterpart of `repro.envs.pommerman_lite`, batched over a leading slot
axis E.

9x9 board with rigid walls on the odd lattice + random wooden walls, 4
agents in two diagonal teams, bombs with timers/blast-cross/chain
detonation, fogged 5x5 local views, team-zero-sum terminal reward, a
100-step tie limit; fixed-size bomb slots.

Cell codes: 0 empty, 1 rigid, 2 wood. Obs tokens: cell codes 0-2, 3 bomb,
4 self, 5 teammate, 6 enemy, 7 out-of-bounds, 8+ammo (ammo token last).

`repro` unrolls the 4 agents and 8 bomb slots statically and XLA fuses the
result. Run eagerly, that unroll would be over a thousand small launches a
step (the blast cross alone: 8 bombs x 2 passes x 4 directions x 2 cells of
scatters). Here the bomb map, the views, the blast crosses, the chain, the
kills and the ammo returns are tensor ops over every slot, bomb and agent
at once: a cell is marked by comparing coordinates against the 9x9 grid
(a one-hot OR, whose result does not depend on order, and dead bombs
stacked on one cell cannot collide as duplicate scatter indices would).
Only what depends on order stays a loop of 4: movement, where the lower
slot wins a contested cell, and bomb placement into the first free slot,
where each agent sees the bombs the agents before it placed.
"""
from __future__ import annotations

import torch

from repro_torch.envs.base import ENVS, EnvSpec, MultiAgentEnv

N = 9                 # board side
MAX_BOMBS = 8
BOMB_TIMER = 4
BLAST = 2             # blast radius (cross)
VIEW = 5              # local view side
MAX_STEPS = 100

# slots (0,1) = team A corners TL/BR, slots (2,3) = team B corners TR/BL
SPAWNS = [[0, 0], [N - 1, N - 1], [0, N - 1], [N - 1, 0]]
TEAM = (0, 0, 1, 1)
MOVES = [[0, 0], [-1, 0], [1, 0], [0, -1], [0, 1]]  # idle,U,D,L,R
DIRS = [(1, 0), (-1, 0), (0, 1), (0, -1)]


def _spawn_safe_mask():
    """Cells that must stay clear so agents can always move off spawn."""
    m = torch.zeros((N, N), dtype=torch.bool)
    for r, c in SPAWNS:
        for dr, dc in [(0, 0), (0, 1), (0, -1), (1, 0), (-1, 0)]:
            rr, cc = r + dr, c + dc
            if 0 <= rr < N and 0 <= cc < N:
                m[rr, cc] = True
    return m


def make_pommerman_lite(device: torch.device, wood_prob: float = 0.35,
                        shaping: float = 0.05) -> MultiAgentEnv:
    spec = EnvSpec(name="pommerman_lite", num_agents=4, obs_len=VIEW * VIEW + 1,
                   num_actions=6, max_steps=MAX_STEPS, obs_vocab=16, team_size=2)
    i32 = dict(dtype=torch.int32, device=device)
    grid = torch.arange(N, **i32)
    rigid = (grid[:, None] % 2 == 1) & (grid[None, :] % 2 == 1)
    safe = _spawn_safe_mask().to(device)
    spawns = torch.tensor(SPAWNS, **i32)
    moves = torch.tensor(MOVES, **i32)
    # blast offsets (direction, distance, coordinate): (4, BLAST, 2)
    offsets = torch.tensor([[[dr * k, dc * k] for k in range(1, BLAST + 1)]
                            for dr, dc in DIRS], **i32)
    view = torch.arange(VIEW, **i32) - VIEW // 2
    agents = torch.arange(4, **i32)
    bomb_slots = torch.arange(MAX_BOMBS, **i32)
    team_sign = torch.tensor([1.0, 1.0, -1.0, -1.0], dtype=torch.float32, device=device)
    # obs code of agent j in agent i's view: 4 self, 5 teammate, 6 enemy
    code = torch.tensor([[4 if j == i else (5 if TEAM[j] == TEAM[i] else 6) for j in range(4)]
                         for i in range(4)], **i32)

    def _onehot(rc):
        """(..., 2) cells -> (..., N, N) bool, True at each cell."""
        return (rc[..., 0, None, None] == grid[:, None]) & (rc[..., 1, None, None] == grid[None, :])

    def _at(grid_map, rc):
        """grid_map (E, N, N) read at cells rc (E, ..., 2), in bounds."""
        e = torch.arange(rc.shape[0], device=device).view(-1, *([1] * (rc.dim() - 2)))
        return grid_map[e, rc[..., 0], rc[..., 1]]

    def _obs(state):
        board, pos, alive = state["board"], state["pos"], state["alive"]
        E = board.shape[0]
        live = state["bomb_timer"] >= 0
        bomb_map = (_onehot(state["bomb_pos"]) & live[..., None, None]).any(1)   # (E, N, N)
        rr = pos[:, :, 0, None, None] + view[:, None]          # (E, 4, 5, 1)
        cc = pos[:, :, 1, None, None] + view[None, :]          # (E, 4, 1, 5)
        inb = (rr >= 0) & (rr < N) & (cc >= 0) & (cc < N)      # (E, 4, 5, 5)
        e = torch.arange(E, device=device)[:, None, None, None]
        rrc, ccc = rr.clamp(0, N - 1), cc.clamp(0, N - 1)
        cell = board[e, rrc, ccc].to(torch.int32)
        cell = torch.where(bomb_map[e, rrc, ccc], 3, cell)
        for j in range(4):                                     # later slots draw over earlier
            here = ((rr == pos[:, None, j, 0, None, None]) & (cc == pos[:, None, j, 1, None, None])
                    & alive[:, None, j, None, None])
            cell = torch.where(here, code[:, j, None, None], cell)
        cell = torch.where(inb, cell, 7)
        ammo_tok = 8 + state["ammo"].clamp(0, 3)
        return torch.cat([cell.reshape(E, 4, VIEW * VIEW), ammo_tok[..., None]], dim=2)

    def reset(gen, num_envs):
        u = torch.rand((num_envs, N, N), generator=gen, device=device)
        wood = (u < wood_prob) & ~rigid & ~safe
        board = torch.where(rigid, 1, torch.where(wood, 2, 0)).to(torch.int8)
        state = {
            "board": board,
            "pos": spawns.expand(num_envs, 4, 2).clone(),
            "alive": torch.ones((num_envs, 4), dtype=torch.bool, device=device),
            "ammo": torch.ones((num_envs, 4), **i32),
            "bomb_pos": torch.zeros((num_envs, MAX_BOMBS, 2), **i32),
            "bomb_timer": torch.full((num_envs, MAX_BOMBS), -1, **i32),
            "bomb_owner": torch.zeros((num_envs, MAX_BOMBS), **i32),
            "t": torch.zeros((num_envs,), **i32),
        }
        return state, _obs(state)

    def _blast_mask(board, bomb_pos, timers):
        """Cells covered by bombs whose timer hits 0 this step (with one round
        of chain detonation), and which bombs exploded."""
        cells = bomb_pos[:, :, None, None, :] + offsets           # (E, B, 4, BLAST, 2)
        inb = ((cells >= 0) & (cells < N)).all(-1)
        cells = cells.clamp(0, N - 1)
        here = _at(board, cells)
        hit_rigid = inb & (here == 1)
        # a ray stops after wood (which burns) and before rigid walls
        stops = (hit_rigid | (inb & (here == 2))).int()
        blocked = (torch.cumsum(stops, -1) - stops) > 0            # stopped before this cell
        place = inb & ~blocked & ~hit_rigid
        centre = _onehot(bomb_pos)                                 # (E, B, N, N)
        cross = centre | (_onehot(cells) & place[..., None, None]).flatten(2, 3).any(2)
        exploding = timers == 0
        blast = (cross & exploding[..., None, None]).any(1)
        # chain: bombs standing in the blast detonate too
        chained = (centre & blast[:, None]).flatten(2).any(-1) & (timers > 0)
        blast = blast | (cross & chained[..., None, None]).any(1)
        return blast, exploding | chained

    def step(state, actions, gen):
        actions = actions.to(torch.int32)
        board, pos, alive, ammo = state["board"], state["pos"], state["alive"], state["ammo"]
        live = state["bomb_timer"] >= 0

        # -- movement (lower slot index wins conflicts) ------------------------
        cand = (pos + moves[actions.clamp(0, 4)]).clamp(0, N - 1)            # (E, 4, 2)
        on_agent = ((pos[:, None] == cand[:, :, None]).all(-1) & alive[:, None]).any(-1)
        on_bomb = ((state["bomb_pos"][:, None] == cand[:, :, None]).all(-1)
                   & live[:, None]).any(-1)
        movable = (alive & (actions >= 1) & (actions <= 4)
                   & (_at(board, cand) == 0) & ~on_agent & ~on_bomb)
        moved = []
        for i in range(4):
            ok = movable[:, i]
            if moved:
                ok = ok & ~(torch.stack(moved, 1) == cand[:, None, i]).all(-1).any(-1)
            moved.append(torch.where(ok[:, None], cand[:, i], pos[:, i]))
        new_pos = torch.stack(moved, 1)

        # -- bomb placement (at the agent's cell before it moved) ---------------
        bomb_pos, bomb_timer, bomb_owner = (state["bomb_pos"], state["bomb_timer"],
                                            state["bomb_owner"])
        wants = alive & (actions == 5) & (ammo > 0)
        placed = []
        for i in range(4):
            occupied = ((bomb_pos == pos[:, None, i]).all(-1) & (bomb_timer >= 0)).any(-1)
            free_slots = bomb_timer < 0
            slot = free_slots.int().argmax(-1)                  # the first free slot
            can = wants[:, i] & ~occupied & free_slots.any(-1)
            sel = (bomb_slots == slot[:, None]) & can[:, None]
            bomb_pos = torch.where(sel[..., None], pos[:, None, i], bomb_pos)
            bomb_timer = torch.where(sel, BOMB_TIMER, bomb_timer)
            bomb_owner = torch.where(sel, i, bomb_owner)
            placed.append(can)
        ammo = ammo - torch.stack(placed, 1).int()

        # -- timers & explosions ---------------------------------------------------
        bomb_timer = torch.where(bomb_timer >= 0, bomb_timer - 1, bomb_timer)
        blast, exploded = _blast_mask(board, bomb_pos, bomb_timer)
        # return ammo to owners, clear exploded bombs
        returned = (bomb_owner[..., None] == agents) & exploded[..., None]     # (E, B, 4)
        ammo = ammo + returned.int().sum(1, dtype=torch.int32)
        bomb_timer = torch.where(exploded, -1, bomb_timer)
        # destroy wood
        wood_destroyed = blast & (board == 2)
        board = torch.where(wood_destroyed, 0, board)
        # kill agents in blast
        alive = alive & ~_at(blast, new_pos)

        t = state["t"] + 1
        team_a, team_b = alive[:, :2].any(-1), alive[:, 2:].any(-1)
        done = ~team_a | ~team_b | (t >= MAX_STEPS)
        win_a, win_b = team_a & ~team_b, team_b & ~team_a
        terminal = torch.where(win_a, 1.0, 0.0) - torch.where(win_b, 1.0, 0.0)
        rewards = torch.where(done[:, None], terminal[:, None] * team_sign, 0.0)
        # shaping: wood destroyed credited to bomb owners (via exploded bombs)
        if shaping:
            n_wood = wood_destroyed.sum((1, 2)).float()
            share = returned.float().sum(1)
            share = share / torch.clamp(share.sum(-1, keepdim=True), min=1.0)
            rewards = rewards + shaping * n_wood[:, None] * share

        new_state = {"board": board, "pos": new_pos, "alive": alive, "ammo": ammo,
                     "bomb_pos": bomb_pos, "bomb_timer": bomb_timer,
                     "bomb_owner": bomb_owner, "t": t}
        outcome = torch.where(win_a, 1, torch.where(win_b, -1, torch.zeros_like(t)))
        return new_state, _obs(new_state), rewards, done, {"outcome": outcome}

    return MultiAgentEnv(spec, reset, step, device)


ENVS.register("pommerman_lite", make_pommerman_lite)
