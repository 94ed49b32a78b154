"""Plain PyTorch version of the flash-attention forward (counterpart of
`repro.kernels.flash_attention.ref.attention_ref`, with the kernel's lse).

The CPU path of `ops.flash_attention_fwd`, and what the CUDA kernel is held
against on the card. It materialises the (Tq, Tk) score matrix in fp32.

Masked scores are NEG_INF = -2**30 as in the reference, but masked keys
get probability 0 exactly rather than exp(NEG_INF - m). For every row with
a live key that is the same number; a row with no live key has l = 0 and
returns o = 0 and lse = 0, the guard of `kernel.py:_flash_kernel`. The
Pallas kernel gives such a row exp(NEG_INF - NEG_INF) = 1 per masked key,
so it averages V over them. Only padded rows, which callers slice off, can
have no live key.
"""
from __future__ import annotations

import torch

NEG_INF = -2.0 ** 30


def attention_fwd_ref(q, k, v, *, scale, causal=True, window=0, cap=0.0,
                      kv_len=None, mixed=False):
    """q: (B, H, Tq, d); k, v: (B, KV, Tk, d), H = KV * G with query head h
    reading KV head h // G. Returns (o (B, H, Tq, d) in q's dtype,
    lse (B, H, Tq) fp32). `mixed` rounds the probabilities to bf16 before
    p @ v, as the bf16 serving kernel does."""
    B, H, Tq, d = q.shape
    KV, Tk = k.shape[1], k.shape[2]
    G = H // KV
    qf = q.float().reshape(B, KV, G, Tq, d)
    s = torch.matmul(qf, k.float()[:, :, None].transpose(-1, -2)) * scale
    if cap:
        s = torch.tanh(s / cap) * cap
    qp = torch.arange(Tq, device=q.device)[:, None]
    kp = torch.arange(Tk, device=q.device)[None, :]
    mask = kp < (Tk if kv_len is None else kv_len)
    if causal:
        mask = mask & (kp <= qp)
    if window:
        mask = mask & (qp - kp < window)
    s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)              # NEG_INF on rows with no live key
    p = torch.exp(s - m).masked_fill(~mask, 0.0)  # masked keys: exactly 0
    l = p.sum(dim=-1, keepdim=True)
    if mixed:
        p = p.to(torch.bfloat16).float()
    o = torch.matmul(p, v.float()[:, :, None])
    o = o / torch.where(l == 0, torch.ones_like(l), l)
    lse = torch.where(l > 0, m + torch.log(l), torch.zeros_like(l))
    return (o.reshape(B, H, Tq, d).to(q.dtype), lse.reshape(B, H, Tq))
