"""The benchmark's yardsticks: the work a step or a flush needs, and the
work of each attention and RMSNorm call, from shapes alone.

These are frozen here, apart from the port, so that a change to the
program cannot change what its utilisation is measured against.

- `learn_step_flops`: model FLOPs of one train step, 6 per matmul
  parameter per token (forward and backward, no remat recompute, no
  embedding gather) plus 12 * head_dim per live (q, k) pair per query
  head per layer (QK^T and PV, forward and backward).
- `serve_flush_flops`: the forward a policy flush needs: attention and
  the active experts (k of E, routed, shared if any) at every position, and
  at the last position only the action columns of the LM head and the value
  head. The port's full-vocabulary head at every position is not counted.
- `attention_fwd` and `rmsnorm`: a copy of the formulas of the port's
  `kernels/cost.py` as they stood when the benchmark was written: the
  forward 4 * d per live pair, RMSNorm 4 per element.
- `attention_bwd`: the work the backward needs, whatever kernels run it:
  S = QK^T recomputed once, then dP = dO V^T, dV = P^T dO, dK = dS^T Q and
  dQ = dS K, 10 * d per live pair, plus delta = rowsum(dO * O), 2 * d per
  row. (The port's split dq and dk/dv kernels each recompute S and dP,
  14 * d a pair in `kernels/cost.py`; that recompute is theirs, not the
  function's.)

Bytes count each input read once and each output written once.

Peaks: NVIDIA H100 SXM, dense bf16 989 TFLOP/s and HBM 3.35 TB/s (the
published data sheet, at its 700 W limit).
"""
from __future__ import annotations

from typing import NamedTuple

PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12


class Work(NamedTuple):
    flops: int
    bytes: int

    def seconds(self) -> float:
        """The least time the chip could take: the larger of the two bounds."""
        return max(self.flops / PEAK_FLOPS, self.bytes / PEAK_BYTES)


def live_pairs(Tq: int, Tk: int, causal: bool = True, window: int = 0) -> int:
    """(q, k) pairs left by the causal and window masks (k <= q, q - k <
    window), for rows aligned at position 0."""
    total = 0
    for q in range(Tq):
        hi = min(Tk - 1, q) if causal else Tk - 1
        lo = max(0, q - window + 1) if window else 0
        total += max(hi - lo + 1, 0)
    return total


def _causal_pairs(T: int) -> int:
    return T * (T + 1) // 2


def matmul_params(cfg: dict, active: bool = False) -> int:
    """Parameters that enter a matmul per token in the blocks: attention
    projections and the MLP, or the router and the experts (k of E when
    `active`)."""
    d, q = cfg["d_model"], cfg["num_heads"] * cfg["head_dim"]
    kv = cfg["num_kv_heads"] * cfg["head_dim"]
    per = d * q + 2 * d * kv + q * d
    moe = cfg.get("moe")
    if moe:
        E, k, ff = moe["num_experts"], moe["experts_per_token"], moe["d_ff_expert"]
        per += d * E + (k if active else E) * 3 * d * ff
        per += moe.get("num_shared_experts", 0) * 3 * d * cfg["d_ff"]
    else:
        per += 3 * d * cfg["d_ff"]
    return cfg["num_layers"] * per


def learn_step_flops(cfg: dict, B: int, T: int) -> int:
    V, d, vh = cfg["vocab_size"], cfg["d_model"], cfg["value_head_hidden"]
    n = matmul_params(cfg, active=True) + d * V + d * vh + vh
    attn = cfg["num_layers"] * cfg["num_heads"] * cfg["head_dim"] * B * _causal_pairs(T)
    return 6 * n * B * T + 12 * attn


def serve_flush_flops(cfg: dict, rows: int, T: int, num_actions: int) -> int:
    d, vh = cfg["d_model"], cfg["value_head_hidden"]
    blocks = 2 * matmul_params(cfg, active=True) * rows * T
    attn = 4 * cfg["num_layers"] * cfg["num_heads"] * cfg["head_dim"] * rows * _causal_pairs(T)
    head = 2 * rows * (d * num_actions + d * vh + vh)
    return blocks + attn + head


def _attn_shape(q_shape, k_shape):
    B, H, Tq, d = q_shape
    return B * H, Tq, d, k_shape[2]


def attention_fwd(q_shape, k_shape, esz: int, causal=True, window=0) -> Work:
    """q (B, H, Tq, d), k and v (B, KV, Tk, d) of element size `esz`; o in
    q's dtype, the log-sum-exp in fp32."""
    bh, Tq, d, Tk = _attn_shape(q_shape, k_shape)
    live = bh * live_pairs(Tq, Tk, causal, window)
    kv = 1
    for n in k_shape:
        kv *= n
    qn = bh * Tq * d
    return Work(4 * d * live, (2 * qn + 2 * kv) * esz + bh * Tq * 4)


def attention_bwd(q_shape, k_shape, esz: int, causal=True, window=0) -> Work:
    """dq, dk and dv from q, k, v, o, dO and the forward's fp32
    log-sum-exp (module docstring)."""
    bh, Tq, d, Tk = _attn_shape(q_shape, k_shape)
    live = bh * live_pairs(Tq, Tk, causal, window)
    kv = 1
    for n in k_shape:
        kv *= n
    qn = bh * Tq * d
    return Work(10 * d * live + 2 * d * bh * Tq, (4 * qn + 4 * kv) * esz + bh * Tq * 4)


def rmsnorm(numel: int, d: int, esz: int) -> Work:
    return Work(4 * numel, 2 * numel * esz + d * 4)
