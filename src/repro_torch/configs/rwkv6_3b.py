"""rwkv6-3b [ssm] — Finch: 32L d_model=2560 (attn-free) d_ff=8960
vocab=65536, data-dependent decay. [arXiv:2404.05892]"""
from repro_torch.configs import ARCHS
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="rwkv6-3b",
    family="ssm",
    source="arXiv:2404.05892 (RWKV-6 Finch)",
    num_layers=32,
    d_model=2560,
    num_heads=40,          # d_model / head_size
    num_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab_size=65536,
    ssm=SSMConfig(kind="rwkv6", head_size=64, lora_rank=64),
    norm="layernorm",
    param_dtype="float32",
)

ARCHS.register("rwkv6-3b", CONFIG)
