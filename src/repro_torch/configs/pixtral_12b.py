"""pixtral-12b [vlm] — 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072; pixtral-ViT frontend + mistral-nemo decoder.
[hf:mistralai/Pixtral-12B-2409]

Per the assignment carve-out the ViT frontend is a stub: `input_specs`
provides precomputed patch embeddings of the right shape; this config is the
language/decoder transformer that consumes them.
"""
from repro_torch.configs import ARCHS
from repro_torch.configs.base import ArchConfig

NUM_PATCHES = 1024  # stub frontend: 32x32 patch grid per image

CONFIG = ArchConfig(
    name="pixtral-12b",
    family="vlm",
    source="hf:mistralai/Pixtral-12B-2409",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1_000_000_000.0,
    frontend="vision",
    param_dtype="bfloat16",
)

ARCHS.register("pixtral-12b", CONFIG)
