"""Architecture config system.

Counterpart of `repro.configs.base`, without jax. Every architecture gets
one `ArchConfig` in `repro_torch/configs/<id>.py` citing its source.
`smoke()` returns the reduced same-family variant used by CPU smoke tests.
`INPUT_SHAPES` are the assigned input shapes.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

import torch


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    experts_per_token: int            # top-k
    d_ff_expert: int                  # hidden dim per expert
    num_shared_experts: int = 0       # kimi-k2 style always-on shared expert(s)
    capacity_factor: float = 1.25     # train-time token capacity per expert
    router_aux_coef: float = 0.01     # load-balance loss weight
    first_k_dense: int = 0            # leading dense (non-MoE) layers


@dataclass(frozen=True)
class RouterConfig:
    """DeepSeek-V3's sigmoid router (`scoring_func` sigmoid, `topk_method`
    noaux_tc, one group). Without one (`ArchConfig.router` None) the router
    is a softmax over the experts, its top-k renormalised, with Switch's
    load-balance term.

    The choice is the top-k of sigmoid(x W) + b, b a correction bias that
    picks the experts and weighs none; the weights are the chosen scores,
    renormalised, times `routed_scaling_factor`; the balance term is the
    sequence-wise one (its `seq_aux`). `experts` is the router's width, all
    the experts of the layer, of which `MoEConfig.num_experts` are held
    here: the first ones, the share of rank 0 of an expert-parallel layer."""
    routed_scaling_factor: float
    experts: int


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V2/V3): q from a low-rank
    latent of `q_lora_rank`, k's and v's per-head parts from a shared
    latent of `kv_lora_rank`, each latent RMS-normed; each head's q and k
    are `qk_nope_head_dim` columns without rotary embeddings and
    `qk_rope_head_dim` with them, k's rotary part one for all heads; v's
    heads are `v_head_dim` wide."""
    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


@dataclass(frozen=True)
class YarnScaling:
    """YaRN's rotary scaling (`rope_scaling` of type 'yarn')."""
    factor: float
    original_max_position: int
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0


@dataclass(frozen=True)
class SSMConfig:
    kind: str = "rwkv6"               # 'rwkv6' | 'mamba'
    head_size: int = 64               # rwkv6 per-head dim
    state_size: int = 16              # mamba N (ssm_state)
    expand: int = 2                   # mamba d_inner = expand * d_model
    conv_kernel: int = 4              # mamba causal-conv width
    dt_rank: int = 0                  # 0 -> ceil(d_model/16)
    lora_rank: int = 64               # rwkv6 data-dependent-decay lora rank


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | vlm | audio
    source: str                       # citation per assignment

    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0

    # attention features
    qk_norm: bool = False
    attn_bias: bool = False
    rope_theta: float = 10_000.0
    attn_logit_softcap: float = 0.0   # gemma2: 50.0
    final_logit_softcap: float = 0.0  # gemma2: 30.0
    sliding_window: int = 0           # 0 = full attention
    layer_pattern: Tuple[str, ...] = ("global",)  # repeat unit, e.g. ("local","global")

    # latent attention's sizes, where the model has it in place of GQA (then
    # head_dim is q's and k's width per head, and num_kv_heads = num_heads)
    mla: Optional[MLAConfig] = None
    rope_scaling: Optional[YarnScaling] = None

    # families
    moe: Optional[MoEConfig] = None
    router: Optional[RouterConfig] = None
    # the shared experts' hidden width, all of them together; 0: d_ff times
    # their number, the JAX package's rule (its configs give d_ff the
    # experts' width where they have shared ones). The published rule,
    # moe_intermediate_size times their number, is set here.
    d_ff_shared: int = 0
    ssm: Optional[SSMConfig] = None
    encoder_only: bool = False        # hubert: bidirectional, no decode step
    frontend: Optional[str] = None    # 'audio'|'vision': embeddings provided by stub

    # misc
    post_block_norms: bool = False    # gemma2: extra norm after attn/mlp outputs
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    activation: str = "silu"
    mlp_gated: bool = True            # GLU-style MLP
    tie_embeddings: bool = False
    embed_scale: bool = False         # gemma-style sqrt(d_model) embed scaling
    max_position: int = 1 << 20

    # dtype policy
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    # RL heads
    value_head_hidden: int = 256

    # long-context variant: if >0, decode/prefill use this sliding window
    # (ring-buffer KV cache) — the sub-quadratic variant for long_500k.
    long_context_window: int = 4096

    use_pallas: bool = False          # route attention through the Pallas kernel

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    # -- derived ------------------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + heads)."""
        d, L = self.d_model, self.num_layers
        n = self.vocab_size * d                     # embed
        if not self.tie_embeddings:
            n += self.vocab_size * d                # lm head
        per_layer = 0
        if self.family == "ssm" and self.ssm and self.ssm.kind == "rwkv6":
            heads = d // self.ssm.head_size
            r = self.ssm.lora_rank
            per_layer += 4 * d * d + d * d          # r,k,v,o(g)
            per_layer += 6 * (d * r + r * d)        # ddlerp loras (approx)
            per_layer += heads * self.ssm.head_size * 2
            per_layer += d * self.d_ff * 2          # rwkv channel-mix
        else:
            per_layer += self.attn_param_count()
            if self.family == "hybrid" and self.ssm:
                di = self.ssm.expand * d
                per_layer += d * 2 * di + di * d + di * (2 * self.ssm.state_size + 32)
            if self.moe is not None:
                e = self.moe
                moe_ff = 3 * d * e.d_ff_expert if self.mlp_gated else 2 * d * e.d_ff_expert
                per_layer += e.num_experts * moe_ff + d * self.router_experts
                per_layer += 3 * d * self.shared_ff
            else:
                per_layer += (3 if self.mlp_gated else 2) * d * self.d_ff
        n += L * per_layer
        return n

    @property
    def shared_ff(self) -> int:
        """The shared experts' hidden width, all of them together."""
        if self.moe is None:
            return 0
        return self.d_ff_shared or self.d_ff * self.moe.num_shared_experts

    @property
    def router_experts(self) -> int:
        """The router's width: every expert of an MoE layer, held or not."""
        if self.router is not None:
            return self.router.experts
        return self.moe.num_experts if self.moe else 0

    def attn_param_count(self) -> int:
        """One layer's attention projections."""
        d = self.d_model
        if self.mla is not None:
            m, H = self.mla, self.num_heads
            return (d * m.q_lora_rank + m.q_lora_rank * H * m.qk_head_dim
                    + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                    + m.kv_lora_rank * H * (m.qk_nope_head_dim + m.v_head_dim)
                    + H * m.v_head_dim * d)
        return d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d

    def active_param_count(self) -> int:
        """Active params per token (MoE top-k instead of all experts)."""
        if self.moe is None:
            return self.param_count()
        d, L, e = self.d_model, self.num_layers, self.moe
        full = self.param_count()
        moe_ff = (3 if self.mlp_gated else 2) * d * e.d_ff_expert
        n_moe_layers = L - e.first_k_dense
        inactive = n_moe_layers * (e.num_experts - e.experts_per_token) * moe_ff
        return full - inactive

    def smoke(self) -> "ArchConfig":
        """Reduced same-family variant: <=2 layers, d_model<=512, <=4 experts."""
        d = min(self.d_model, 256)
        heads = min(self.num_heads, 4)
        kv = max(1, min(self.num_kv_heads, heads, 2))
        hd = 64
        kw = dict(
            name=self.name + "-smoke",
            num_layers=max(2, len(self.layer_pattern)),
            d_model=d,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=hd,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            long_context_window=128,
            max_position=4096,
        )
        if self.moe is not None:
            # capacity_factor high enough that smoke routing never drops:
            # consistency tests (prefill == train fwd) need drop-free MoE.
            kw["moe"] = replace(
                self.moe, num_experts=4, experts_per_token=2, d_ff_expert=128,
                num_shared_experts=min(self.moe.num_shared_experts, 1),
                first_k_dense=min(self.moe.first_k_dense, 1),
                capacity_factor=8.0,
            )
        if self.ssm is not None:
            kw["ssm"] = replace(self.ssm, head_size=32, lora_rank=16)
        if self.mla is not None:
            kw.update(mla=MLAConfig(q_lora_rank=64, kv_lora_rank=32, qk_nope_head_dim=32,
                                    qk_rope_head_dim=16, v_head_dim=32),
                      num_kv_heads=heads, head_dim=48)
        if self.router is not None:
            kw["router"] = replace(self.router, experts=4)
        if self.d_ff_shared:
            kw["d_ff_shared"] = 128 * kw["moe"].num_shared_experts
        return replace(self, **kw)


# ---------------------------------------------------------------------------
# Input shapes (assigned): name -> (seq_len, global_batch, kind)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64}


def dtype_of(name: str) -> torch.dtype:
    """Config dtype string -> torch.dtype."""
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r}; known: {sorted(_DTYPES)}")
    return _DTYPES[name]
