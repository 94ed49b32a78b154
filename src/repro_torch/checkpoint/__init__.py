from repro_torch.checkpoint.checkpoint import save_pytree, load_pytree, save_league, load_league
