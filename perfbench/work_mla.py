"""The work of a latent-attention MoE learner's step (the `learn_mla`
cells), from the configuration's file alone, and of its (192, 128)
attention kernels from their shapes. Frozen here, apart from the port, as
`work.py`'s counts are.

- `learn_step_flops`: model FLOPs of one train step on this chip's share,
  6 per matmul parameter per token (forward and backward, no remat
  recompute, no embedding gather) plus, per live (q, k) pair per head per
  layer, 2 (dq + dv) forward (QK^T, PV) and 4 (dq + dv) backward (dP, dV,
  dK, dQ), dq being q's and k's width and dv v's. An MoE layer counts its
  router (all R experts), its shared expert, and of its routed experts the
  expected share of the k choices that land on the E held here, k E / R
  experts per token (with R = 384 and E = 8, 1/6 of one expert).
- `attention_fwd` and `attention_bwd`: the (192, 128) kernels' bound,
  written as `work.attention_fwd` and `work.attention_bwd` are with v's
  width apart: the forward 2 (dq + dv) per live pair; the backward S
  recomputed once, dP, dV, dK and dQ, 2 (3 dq + 2 dv) per live pair, plus
  delta = rowsum(dO * O), 2 dv per row. Bytes count each input read once
  and each output written once.
"""
from __future__ import annotations

from perfbench.work import Work, _causal_pairs, live_pairs

PEAK_FLOPS = 989e12     # H100 SXM dense bf16, as `work.PEAK_FLOPS`


def mla_params(cfg: dict) -> int:
    """One layer's latent-attention projections."""
    d, H = cfg["d_model"], cfg["num_attention_heads"]
    qr, kvr = cfg["q_lora_rank"], cfg["kv_lora_rank"]
    nope, rope, dv = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    return (d * qr + qr * H * (nope + rope) + d * (kvr + rope) + kvr * H * (nope + dv)
            + H * dv * d)


def matmul_params(cfg: dict) -> int:
    """Parameters entering a matmul per token in the layers (module docstring)."""
    d, dense = cfg["d_model"], cfg["first_k_dense_replace"]
    R, E, k = cfg["published"]["n_routed_experts"], cfg["n_routed_experts"], \
        cfg["num_experts_per_tok"]
    ff = cfg["moe_intermediate_size"]
    moe = d * R + 3 * d * ff * cfg["n_shared_experts"] + 3 * d * ff * k * E / R
    return int(cfg["num_layers"] * mla_params(cfg) + dense * 3 * d * cfg["intermediate_size"]
               + (cfg["num_layers"] - dense) * moe)


def learn_step_flops(cfg: dict, B: int, T: int) -> int:
    V, d, vh = cfg["vocab_size"], cfg["d_model"], cfg["value_head_hidden"]
    n = matmul_params(cfg) + d * V + d * vh + vh
    dq, dv = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    pairs = cfg["num_layers"] * cfg["num_attention_heads"] * B * _causal_pairs(T)
    return 6 * n * B * T + 6 * (dq + dv) * pairs


def _shape(q_shape, k_shape):
    B, H, Tq, d = q_shape
    kv = 1
    for n in k_shape:
        kv *= n
    return B * H, Tq, d, k_shape[2], kv


def attention_fwd(q_shape, k_shape, dv: int, esz: int, causal=True, window=0) -> Work:
    """q (B, H, Tq, dq), k (B, KV, Tk, dq), v (B, KV, Tk, dv) of element
    size `esz`; o (B, H, Tq, dv) in q's dtype, the log-sum-exp in fp32."""
    bh, Tq, d, Tk, kn = _shape(q_shape, k_shape)
    live = bh * live_pairs(Tq, Tk, causal, window)
    vn = kn // d * dv
    return Work(2 * (d + dv) * live, (bh * Tq * (d + dv) + kn + vn) * esz + bh * Tq * 4)


def attention_bwd(q_shape, k_shape, dv: int, esz: int, causal=True, window=0) -> Work:
    """dq, dk and dv from q, k, v, o, dO and the forward's fp32
    log-sum-exp (module docstring)."""
    bh, Tq, d, Tk, kn = _shape(q_shape, k_shape)
    live = bh * live_pairs(Tq, Tk, causal, window)
    vn = kn // d * dv
    return Work(2 * (3 * d + 2 * dv) * live + 2 * dv * bh * Tq,
                (2 * bh * Tq * (d + dv) + 2 * kn + 2 * vn) * esz + bh * Tq * 4)
