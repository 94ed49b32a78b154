"""Plain PyTorch transformer: the benchmark's reference for the port's
dense and MoE blocks. Written from the published architecture (pre-norm
RMSNorm blocks, rotary embeddings on the first and second halves of each
head, grouped-query causal attention, a SiLU-gated MLP or a top-k mixture
of experts with renormalised gates) and from the league's heads (an LM
head whose first `num_actions` columns are the action logits at an
observation's last position, and a tanh value head). Nothing here imports
the port.

Every function computes in the dtype of its inputs, with norms, rotary
embeddings, softmaxes and the router in fp32 inside; the checks pass fp32
with TF32 off (`exact_matmuls`). `lowp` rounds both inputs of every
projection, expert and head matmul to fp8 (e4m3, one scale per tensor, the
common fp8 recipe): run on bf16 weights and activations, that is the
configuration's bf16 program with its products in the next precision
below, the control that such a change is caught. In a differentiated pass
the rounding is straight-through.

Attention runs in blocks of query rows, each against the keys up to its
last row, so the scores of one block are all that is alive at once.

The MoE keeps the port's capacity rule, `repro`'s: C = max(int(N * k *
cf / E), k) over the N tokens routed together, and an expert keeps the
first C of its choices in rank-major order (every token's first choice
before any token's second); a choice past C adds nothing.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

SCORE_ELEMS = 1 << 27          # scores alive at once in a block of attention


@contextlib.contextmanager
def exact_matmuls():
    """fp32 matmuls in fp32: TF32 off for the enclosed computation."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 with one scale for the tensor, given back
    in t's dtype."""
    s = (t.detach().abs().amax().float() / 448.0).clamp(min=1e-30)
    q = (t.detach().float() / s).to(torch.float8_e4m3fn).float().mul(s).to(t.dtype)
    return t + (q - t).detach() if t.requires_grad else q


def mm(x, w, lowp=False):
    """x @ w, with both inputs rounded to fp8 under `lowp`."""
    if lowp:
        x, w = fp8(x), fp8(w)
    return x @ w


def rmsnorm(x, w, eps=1e-6):
    xf = x.float()
    return (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps) * w.float()).to(x.dtype)


def rope(x, theta):
    """x (B, T, H, hd) at positions 0..T-1 of each row."""
    T, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd))
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _attend_block(q, k, v, start: int):
    """Causal attention of query rows start.. start+Tq against keys
    0.. start+Tq. q (B, KV, G, Tq, hd), k and v (B, KV, Tk, hd)."""
    Tq, end = q.shape[3], start + q.shape[3]
    k, v = k[:, :, :end], v[:, :, :end]
    s = torch.einsum("bkgqd,bksd->bkgqs", q, k) * q.shape[-1] ** -0.5
    qpos = torch.arange(start, end, device=q.device)[:, None]
    kpos = torch.arange(end, device=q.device)[None, :]
    s = s.float().masked_fill(kpos > qpos, float("-inf"))
    return torch.einsum("bkgqs,bksd->bkgqd", torch.softmax(s, dim=-1).to(v.dtype), v)


def attention(p, cfg, x, lowp=False, remat=False):
    """x (B, T, d) -> (B, T, d)."""
    B, T, d = x.shape
    H, KV, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    q = mm(x, p["attn.wq.w"], lowp).reshape(B, T, H, hd)
    k = mm(x, p["attn.wk.w"], lowp).reshape(B, T, KV, hd)
    v = mm(x, p["attn.wv.w"], lowp).reshape(B, T, KV, hd)
    if cfg.get("qk_norm"):
        q, k = rmsnorm(q, p["attn.q_norm.scale"]), rmsnorm(k, p["attn.k_norm.scale"])
    q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
    G = H // KV
    qg = q.permute(0, 2, 1, 3).reshape(B, KV, G, T, hd)
    k, v = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    rows = max(1, min(T, SCORE_ELEMS // max(B * H * T, 1)))
    outs = []
    for s in range(0, T, rows):
        blk = qg[:, :, :, s:s + rows]
        outs.append(checkpoint(_attend_block, blk, k, v, s, use_reentrant=False)
                    if remat else _attend_block(blk, k, v, s))
    o = torch.cat(outs, dim=3).reshape(B, H, T, hd).permute(0, 2, 1, 3).reshape(B, T, H * hd)
    return mm(o, p["attn.wo.w"], lowp)


def mlp(p, x, lowp=False):
    h = F.silu(mm(x, p["mlp.gate.w"], lowp)) * mm(x, p["mlp.up.w"], lowp)
    return mm(h, p["mlp.down.w"], lowp)


def moe(p, cfg, x, lowp=False):
    """x (B, T, d): the N = B * T tokens routed together."""
    B, T, d = x.shape
    e = cfg["moe"]
    E, k = e["num_experts"], e["experts_per_token"]
    xf = x.reshape(-1, d)
    N = xf.shape[0]
    gates = torch.softmax(xf.float() @ p["moe.router.w"].float(), dim=-1)
    topv, topi = torch.topk(gates, k, dim=-1)
    w = topv / (topv.sum(-1, keepdim=True) + 1e-9)
    C = max(int(N * k * e["capacity_factor"] / E), k)
    flat = topi.t().reshape(-1)                     # choice j of token n at j * N + n
    y = torch.zeros_like(xf)
    for ex in range(E):
        idx = (flat == ex).nonzero()[:C, 0]         # its first C choices, rank-major
        if idx.numel() == 0:
            continue
        n, j = idx % N, idx // N
        xe = xf[n]
        h = F.silu(mm(xe, p["moe.gate"][ex], lowp)) * mm(xe, p["moe.up"][ex], lowp)
        y = y.index_add(0, n, mm(h, p["moe.down"][ex], lowp) * w[n, j][:, None].to(y.dtype))
    return y.reshape(B, T, d)


def block(p, cfg, x, lowp=False, remat=False):
    """One pre-norm layer: attention, then the MLP or the MoE."""
    x = x + attention(p, cfg, rmsnorm(x, p["attn_norm.scale"]), lowp, remat)
    h = rmsnorm(x, p["mlp_norm.scale"])
    return x + (moe(p, cfg, h, lowp) if cfg.get("moe") else mlp(p, h, lowp))


def heads(g, x, lowp=False, actions=None):
    """(logits, values) in fp32 of x (..., d): the LM head's columns (the
    first `actions` of them, or all) and the value head."""
    h = rmsnorm(x, g["final_norm.scale"])
    w = g["lm_head.w"] if actions is None else g["lm_head.w"][:, :actions]
    logits = mm(h, w, lowp).float()
    vh = torch.tanh(mm(h, g["value_head.h.w"], lowp) + g["value_head.h.b"])
    values = (mm(vh, g["value_head.out.w"], lowp) + g["value_head.out.b"])[..., 0].float()
    return logits, values
