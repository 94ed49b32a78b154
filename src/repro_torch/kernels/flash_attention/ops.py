"""Flash-attention forward wrapper: the CUDA kernel for CUDA tensors, the
plain version for CPU tensors.

Replaces `repro.kernels.flash_attention.kernel.flash_attention_fwd`
(`_flash_kernel`); the kernel is `csrc/flash_fwd.cu`, whose header says
what bounds it and how it is laid out. Unlike `repro`'s `ops.py`, nothing
is padded to a block multiple: the kernel masks its own ragged edge. q, k
and v may be strided views (the model passes (B, T, H, d) activations
transposed to (B, H, T, d)) as long as the head dim is contiguous; o comes
back in q's memory layout. Forward only: the backward kernels are a later
slice. `flash_attention_fwd.launches` counts kernel launches and nothing
else.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_fwd_ref

DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (32, 64, 128, 256)
_INT_MAX = 2 ** 31 - 1


def _check(q, k, v, mixed):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash attention: q (B,H,Tq,d), k and v (B,KV,Tk,d); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, _, d = q.shape
    if k.shape[0] != B or k.shape[3] != d or k.shape[1] == 0 or H % k.shape[1]:
        raise ValueError(f"flash attention: k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (KV heads must divide H)")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash attention: dtypes differ {q.dtype}, {k.dtype}, {v.dtype}")
    if mixed and q.dtype != torch.bfloat16:
        raise TypeError("flash attention: mixed takes bf16 q, k, v")
    if not (q.device == k.device == v.device):
        raise ValueError("flash attention: q, k, v on different devices")


def flash_attention_fwd(q, k, v, *, scale, causal=True, window=0, cap=0.0,
                        kv_len=None, mixed=False):
    """q: (B, H, Tq, d); k, v: (B, KV, Tk, d). Returns (o (B, H, Tq, d) in
    q's dtype, lse (B, H, Tq) fp32). Masks: causal (k <= q), sliding window
    (q - k < window), tail (k < kv_len); logits soft-capped as
    tanh(s / cap) * cap before the mask."""
    _check(q, k, v, mixed)
    if q.device.type == "cpu":
        return attention_fwd_ref(q, k, v, scale=scale, causal=causal,
                                 window=window, cap=cap, kv_len=kv_len,
                                 mixed=mixed)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention: unsupported device {q.device}")
    B, H, Tq, d = q.shape
    KV, Tk = k.shape[1], k.shape[2]
    if q.dtype not in DTYPES:
        raise TypeError(f"flash attention kernel takes {DTYPES}, got {q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash attention kernel takes head_dim in {HEAD_DIMS}, got {d}")
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    strides = []
    for t in (q, k, v, o):
        if t.stride(3) != 1:
            raise ValueError("flash attention kernel needs a contiguous head dim")
        if sum((n - 1) * s for n, s in zip(t.shape, t.stride())) > _INT_MAX:
            raise ValueError("flash attention kernel indexes with 32-bit strides")
        strides += [t.stride(0), t.stride(1), t.stride(2)]
    kv_len = Tk if kv_len is None else min(int(kv_len), Tk)
    lib = _build.library()
    err = lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                        lse.data_ptr(), B, H, KV, Tq, Tk, d, *strides,
                        float(scale), int(causal), int(window), float(cap or 0.0),
                        kv_len, int(q.dtype == torch.bfloat16), int(mixed),
                        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_fwd")
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0


def flash_attention(q, k, v, *, scale, causal=True, window=0, cap=0.0,
                    kv_len=None, mixed=False):
    """`flash_attention_fwd` without the lse: (B, H, Tq, d)."""
    return flash_attention_fwd(q, k, v, scale=scale, causal=causal,
                               window=window, cap=cap, kv_len=kv_len,
                               mixed=mixed)[0]
