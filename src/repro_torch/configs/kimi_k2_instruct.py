"""kimi-k2-instruct [moe] — the published Kimi-K2-Instruct: 61 layers,
d_model 7168, vocab 163840, untied head, SiLU, RMSNorm eps 1e-6.

Attention on every layer is multi-head latent attention: 64 heads, q from
a 1536-wide latent, k's and v's per-head parts from a 512-wide latent,
q and k 192 wide per head (128 without rotary embeddings, 64 with, k's
rotary part one for all heads), v 128; YaRN rope (theta 50000, factor 32
over 4096 positions, beta_fast = beta_slow = 1, mscale 1). The first layer
is dense (width 18432); the other 60 hold 384 experts of width 2048, 8 per
token, and one shared expert of width 2048, with DeepSeek-V3's sigmoid
router (`noaux_tc`: a correction bias chooses, the chosen scores
renormalised and scaled by 2.827 weigh; one group).

Source: https://huggingface.co/moonshotai/Kimi-K2-Instruct/blob/main/config.json
(the modelling code reuses DeepseekV3Attention and its YaRN rotary
embedding). `kimi-k2-1t-a32b` is the JAX package's stand-in for the same
model (GQA, softmax routing), held against it; this entry is the port's
own."""
from repro_torch.configs import ARCHS
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig, RouterConfig, YarnScaling

CONFIG = ArchConfig(
    name="kimi-k2-instruct",
    family="moe",
    source="https://huggingface.co/moonshotai/Kimi-K2-Instruct/blob/main/config.json",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=64,
    head_dim=192,                  # q's and k's width per head: 128 + 64
    d_ff=18432,                    # the dense layer (intermediate_size)
    d_ff_shared=2048,              # moe_intermediate_size x n_shared_experts
    vocab_size=163840,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    rope_theta=50_000.0,
    rope_scaling=YarnScaling(factor=32.0, original_max_position=4096, beta_fast=1.0,
                             beta_slow=1.0, mscale=1.0, mscale_all_dim=1.0),
    max_position=131072,
    moe=MoEConfig(
        num_experts=384,
        experts_per_token=8,
        d_ff_expert=2048,
        num_shared_experts=1,
        first_k_dense=1,
    ),
    router=RouterConfig(routed_scaling_factor=2.827, experts=384),
    param_dtype="bfloat16",
)

ARCHS.register("kimi-k2-instruct", CONFIG)
