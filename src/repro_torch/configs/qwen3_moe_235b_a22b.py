"""qwen3-moe-235b-a22b [moe] — 94L d_model=4096 64H (GQA kv=4) d_ff=1536
vocab=151936, MoE 128 experts top-8. [hf:Qwen/Qwen3-30B-A3B family]"""
from repro_torch.configs import ARCHS
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    source="hf:Qwen/Qwen3-30B-A3B (235B-A22B scaling)",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab_size=151936,
    qk_norm=True,
    moe=MoEConfig(
        num_experts=128,
        experts_per_token=8,
        d_ff_expert=1536,
    ),
    rope_theta=1_000_000.0,
    param_dtype="bfloat16",
)

ARCHS.register("qwen3-moe-235b-a22b", CONFIG)
