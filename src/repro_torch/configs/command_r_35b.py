"""command-r-35b [dense] — 40L d_model=8192 64H (GQA kv=8) d_ff=22528
vocab=256000, GQA, no-bias. [hf:CohereForAI/c4ai-command-r-v01]"""
from repro_torch.configs import ARCHS
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="command-r-35b",
    family="dense",
    source="hf:CohereForAI/c4ai-command-r-v01",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22528,
    vocab_size=256000,
    attn_bias=False,
    norm="layernorm",
    tie_embeddings=True,
    rope_theta=8_000_000.0,
    param_dtype="bfloat16",
)

ARCHS.register("command-r-35b", CONFIG)
