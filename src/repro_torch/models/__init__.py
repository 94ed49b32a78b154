from repro_torch.models.transformer import (
    decode_step,
    forward_train,
    init_decode_state,
    init_params,
    prefill,
)
