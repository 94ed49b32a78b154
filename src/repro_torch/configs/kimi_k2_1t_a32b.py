"""kimi-k2-1t-a32b [moe] — 61L d_model=7168 64H (GQA kv=8) d_ff=2048
vocab=163840, MoE 384 experts top-8, 1 shared expert, first layer dense.

The JAX package's stand-in for Kimi K2, from its assignment table, and
held against it field by field: GQA where the published model has latent
attention, the dense layer at the experts' width 2048 where it is 18432,
softmax routing where the published router is sigmoid with a correction
bias and a scaling factor, and a citation that names no published source.
The published architecture is `kimi-k2-instruct`."""
from repro_torch.configs import ARCHS
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    source="arXiv:2501.kimi2 (Kimi K2)",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=2048,                     # per-assignment: expert/shared hidden
    vocab_size=163840,
    moe=MoEConfig(
        num_experts=384,
        experts_per_token=8,
        d_ff_expert=2048,
        num_shared_experts=1,
        first_k_dense=1,
    ),
    rope_theta=50_000.0,
    param_dtype="bfloat16",
)

ARCHS.register("kimi-k2-1t-a32b", CONFIG)
