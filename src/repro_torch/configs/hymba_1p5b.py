"""hymba-1.5b [hybrid] — 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16; parallel attention + mamba heads per layer.
[arXiv:2411.13676]

Hymba runs sliding-window attention on all but 3 layers (the SSM path
carries global context); we use SWA on every layer => sub-quadratic,
`long_500k` runs natively. Meta-tokens are omitted (orthogonal to the
parallel-heads contribution).
"""
from repro_torch.configs import ARCHS
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    source="arXiv:2411.13676 (Hymba)",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    sliding_window=1024,
    layer_pattern=("local",),
    ssm=SSMConfig(kind="mamba", state_size=16, expand=2, conv_kernel=4),
    long_context_window=1024,   # ring KV == SWA window (long_500k decode)
    param_dtype="float32",
)

ARCHS.register("hymba-1.5b", CONFIG)
