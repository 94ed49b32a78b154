"""gemma2-2b [dense] — 26L d_model=2304 8H (GQA kv=4) d_ff=9216
vocab=256000; local+global alternating, logit softcap. [arXiv:2408.00118]"""
from repro_torch.configs import ARCHS
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-2b",
    family="dense",
    source="arXiv:2408.00118 (Gemma 2)",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    sliding_window=4096,
    layer_pattern=("local", "global"),
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    post_block_norms=True,
    tie_embeddings=True,
    embed_scale=True,
    activation="gelu_tanh",
    param_dtype="float32",
)

ARCHS.register("gemma2-2b", CONFIG)
