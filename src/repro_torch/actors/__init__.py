from repro_torch.actors.policy import make_obs_policy
from repro_torch.actors.collector import (JitCollector, ServedCollector,
                                          collect_interleaved)
from repro_torch.actors.rollout import build_rollout, build_served_rollout
from repro_torch.actors.actor import Actor
