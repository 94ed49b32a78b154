"""qwen3-8b [dense] — 36L d_model=4096 32H (GQA kv=8) d_ff=12288
vocab=151936, qk_norm. [hf:Qwen/Qwen3-8B]"""
from repro_torch.configs import ARCHS
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-8b",
    family="dense",
    source="hf:Qwen/Qwen3-8B",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=12288,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    param_dtype="float32",
)

ARCHS.register("qwen3-8b", CONFIG)
