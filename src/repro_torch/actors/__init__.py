from repro_torch.actors.policy import make_obs_policy
