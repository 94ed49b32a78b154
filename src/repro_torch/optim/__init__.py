from repro_torch.optim.optimizers import adamw, sgd, clip_by_global_norm, Optimizer
from repro_torch.optim.schedules import constant, linear_warmup_cosine, linear
