"""Plain PyTorch versions of the flash-attention kernels: the forward
(counterpart of `repro.kernels.flash_attention.ref.attention_ref`, with the
kernel's lse) and the three backward kernels (`attention_bwd_ref`, the
formulas of `repro`'s `kernel._tile_grads` at full T^2).

The CPU path of `ops.py`, and what the CUDA kernels are held against on the
card. They materialise the (Tq, Tk) score matrix in fp32.

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


def _mask(Tq, Tk, kv_len, causal, window, device):
    qp = torch.arange(Tq, device=device)[:, None]
    kp = torch.arange(Tk, device=device)[None, :]
    mask = kp < (Tk if kv_len is None else kv_len)
    if causal:
        mask = mask & (kp <= qp)
    if window:
        mask = mask & (qp - kp < window)
    return mask


def attention_fwd_ref(q, k, v, *, scale, causal=True, window=0, cap=0.0,
                      kv_len=None, mixed=False):
    """q: (B, H, Tq, d); k: (B, KV, Tk, d); v: (B, KV, Tk, dv), H = KV * G
    with query head h reading KV head h // G. Returns (o (B, H, Tq, dv) in q's dtype,
    lse (B, H, Tq) fp32). `mixed` rounds the probabilities to bf16 before
    p @ v, as the bf16 serving kernel does."""
    B, H, Tq, d = q.shape
    KV, Tk = k.shape[1], k.shape[2]
    G = H // KV
    qf = q.float().reshape(B, KV, G, Tq, d)
    s = torch.matmul(qf, k.float()[:, :, None].transpose(-1, -2)) * scale
    if cap:
        s = torch.tanh(s / cap) * cap
    mask = _mask(Tq, Tk, kv_len, causal, window, q.device)
    s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)              # NEG_INF on rows with no live key
    p = torch.exp(s - m).masked_fill(~mask, 0.0)  # masked keys: exactly 0
    l = p.sum(dim=-1, keepdim=True)
    if mixed:
        p = p.to(torch.bfloat16).float()
    o = torch.matmul(p, v.float()[:, :, None])
    o = o / torch.where(l == 0, torch.ones_like(l), l)
    lse = torch.where(l > 0, m + torch.log(l), torch.zeros_like(l))
    return (o.reshape(B, H, Tq, v.shape[3]).to(q.dtype), lse.reshape(B, H, Tq))


def attention_bwd_preprocess_ref(o, do):
    """delta = rowsum(dO * O) in fp32: (B, H, Tq). `o` as the forward
    stored it (in q's dtype), as `kernel._bwd_preprocess_kernel` reads it."""
    return (o.float() * do.float()).sum(dim=-1)


def attention_bwd_grads_ref(q, k, v, do, lse, delta, *, scale, causal=True,
                            window=0, cap=0.0, kv_len=None):
    """dq, dk, dv from the forward's lse and the preprocess's delta, by the
    formulas of `kernel._tile_grads`: p = exp(s - lse), ds = p (dp - delta),
    ds *= 1 - tanh^2 under the softcap, dq = ds K scale, dk = ds^T Q scale,
    dv = p^T dO. Masked entries get p = ds = 0 explicitly (a row with no
    live key has lse = 0 from the forward). dk and dv are summed over each
    KV head's G query heads. Returns (dq, dk, dv) in q's, k's and v's
    dtypes."""
    B, H, Tq, d = q.shape
    KV, Tk = k.shape[1], k.shape[2]
    G = H // KV
    qf = q.float().reshape(B, KV, G, Tq, d)
    dof = do.float().reshape(B, KV, G, Tq, do.shape[-1])
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if cap:
        t = torch.tanh(s / cap)
        s = t * cap
    mask = _mask(Tq, Tk, kv_len, causal, window, q.device)
    p = torch.exp(s - lse.reshape(B, KV, G, Tq, 1)).masked_fill(~mask, 0.0)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = p * (dp - delta.reshape(B, KV, G, Tq, 1))
    if cap:
        ds = ds * (1.0 - t * t)
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf).sum(dim=2) * scale
    dv = torch.matmul(p.transpose(-1, -2), dof).sum(dim=2)
    return (dq.reshape(B, H, Tq, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


def attention_bwd_ref(q, k, v, o, lse, do, *, scale, causal=True, window=0,
                      cap=0.0, kv_len=None):
    """The plain version of the three backward kernels (preprocess, dq,
    dk/dv). q: (B, H, Tq, d); o, do: (B, H, Tq, dv); k: (B, KV, Tk, d); v:
    (B, KV, Tk, dv); lse: (B, H, Tq) fp32 from the forward. Returns (delta
    (B, H, Tq) fp32, dq (B, H, Tq, d), dk and dv like k and v)."""
    delta = attention_bwd_preprocess_ref(o, do)
    return (delta,) + attention_bwd_grads_ref(
        q, k, v, do, lse, delta, scale=scale, causal=causal, window=window,
        cap=cap, kv_len=kv_len)
