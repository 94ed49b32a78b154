from repro_torch.kernels.adamw.ops import adamw_update, global_norm
