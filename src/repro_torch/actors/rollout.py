"""Rollout builders: thin wrappers over the collector plane (§3.2);
counterpart of `repro.actors.rollout`.

Both are compositions of `repro_torch.envs.vector` (slot-batched env) and
`repro_torch.actors.collector` (acting + assembly) with `repro`'s public
signatures and the `(carry, traj, episodes)` contract; random draws come
from a `torch.Generator` where `repro` takes a key.
"""
from __future__ import annotations

from typing import Sequence

from repro_torch.actors.collector import JitCollector, ServedCollector
from repro_torch.envs.base import MultiAgentEnv
from repro_torch.envs.vector import TorchVectorEnv


def build_rollout(env: MultiAgentEnv, cfg, *, num_envs: int, unroll_len: int,
                  learner_slots: Sequence[int] | None = None):
    """Local-params rollout: `rollout(theta, phi, carry, gen) -> (carry,
    traj, episodes)`, an eager loop over `unroll_len` steps with auto-reset
    on the env's device (the "Anakin" layout of `repro`, without the
    compiled scan). Returns (rollout, init_carry)."""
    col = JitCollector(TorchVectorEnv(env, num_envs), cfg, unroll_len=unroll_len,
                       learner_slots=learner_slots)
    return col.collect, col.init_carry


def build_served_rollout(env: MultiAgentEnv, *, num_envs: int, unroll_len: int,
                         learner_slots: Sequence[int] | None = None):
    """SEED-style rollout: env stepping stays on the Actor's device, but
    every policy forward is routed through a central InfServer via ticket
    futures (§3.2) — the learner θ and the opponent φ ride the same grouped
    batch.

    Returns (rollout, init_carry); `rollout(server, theta_key, phi_key,
    carry, gen)` matches `build_rollout`'s (carry, traj, episodes) contract
    so the Learner-side data path is identical for both actor modes.
    """
    col = ServedCollector(TorchVectorEnv(env, num_envs), unroll_len=unroll_len,
                          learner_slots=learner_slots)
    return col.collect, col.init_carry
