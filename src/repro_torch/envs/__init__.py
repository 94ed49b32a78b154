"""Batched multi-agent envs and their vector adapters; counterpart of
`repro.envs`."""
from repro_torch.envs.base import EnvSpec, MultiAgentEnv, ENVS, make_env
from repro_torch.envs.vector import (VectorEnv, TorchVectorEnv, HostVectorEnv,
                                     make_vector_env)
from repro_torch.envs import matrix_games, pommerman_lite, duel  # noqa: F401 (registration)
