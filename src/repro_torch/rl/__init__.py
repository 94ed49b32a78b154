from repro_torch.rl.distributions import categorical_logp, categorical_entropy, categorical_sample, categorical_kl
