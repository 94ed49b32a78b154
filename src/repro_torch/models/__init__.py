from repro_torch.models.transformer import forward_train, init_params
