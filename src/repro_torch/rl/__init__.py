from repro_torch.rl.distributions import categorical_logp, categorical_entropy, categorical_sample, categorical_kl
from repro_torch.rl.returns import gae, lambda_return, discounted_return
from repro_torch.rl.vtrace import vtrace
from repro_torch.rl.ppo import ppo_loss, PPOConfig
from repro_torch.rl.vtrace_loss import vtrace_loss, VTraceConfig
