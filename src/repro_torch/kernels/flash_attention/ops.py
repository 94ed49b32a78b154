"""Flash-attention wrappers: the CUDA kernels for CUDA tensors, the plain
versions for CPU tensors, and `flash_attention`, differentiable.

Replaces `repro.kernels.flash_attention.kernel`'s four kernels:
`flash_attention_fwd` (`_flash_kernel`, here `csrc/flash_fwd.cu`) and
the FlashAttention-2 backward `flash_attention_bwd_preprocess`,
`flash_attention_bwd_dq` and `flash_attention_bwd_dkv` (`csrc/flash_bwd.cu`),
where the preprocess (delta = rowsum(dO * O)) runs in the dq kernel's
prologue: `flash_attention_bwd_dq` returns (dq, delta).
The kernels' headers say what bounds them and how they are laid out.
Unlike `repro`'s `ops.py`, nothing is padded to a block multiple: the
kernels mask their own ragged edge. q, k, v, o and dO may be strided views
(the model passes (B, T, H, d) activations transposed to (B, H, T, d)) as
long as the head dim is contiguous; o and dq come back in q's memory
layout, dk and dv in k's and v's. The dk/dv kernel writes one gradient per
KV head, so `repro`'s per-query-head buffers and group sum (`ops.py:96-100`)
have no counterpart. The kernels stage their tiles with 16-byte
`cp.async`, so their tensors' base addresses and (batch, head, time)
strides must be multiples of 16 bytes (`check_aligned`); the model's
activations and every fresh allocation are. Each wrapper's `.launches`
counts its kernel's launches and nothing else. Meta tensors are checked
as the card's would be, but for the kernels' 32-bit index limit (nothing
is indexed), and get the kernels' outputs and no launch (shape-only
evaluation); `cost.py` has each kernel's work.

v (and so o and dO) may be narrower than q and k: latent attention's q
and k are 192 wide and v 128 (`WIDE_PAIRS`), which the bf16 kernels take
at those widths, nothing padded.

The dk/dv kernel has two designs, and `dkv_design` picks one from the
inputs' shapes and dtype: the warpgroup-MMA kernel (128-key blocks, Q and
dO tiles fed by TMA) for bf16 at (128, 128) and (192, 128) once Tk holds a
whole key tile, and the mma.sync and fp32 kernels (32-key blocks, which
fill the card at the env step's T = 26) for everything else.
`flash_attention_bwd_dkv.design_launches` counts launches per design.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, cost
from repro_torch.kernels.flash_attention.ref import (
    attention_bwd_grads_ref,
    attention_bwd_preprocess_ref,
    attention_bwd_ref,
    attention_fwd_ref,
)

DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (32, 64, 80, 128, 256)
WIDE_PAIRS = ((192, 128),)  # (q's and k's width, v's): bf16 only
_INT_MAX = 2 ** 31 - 1
ALIGN = 16          # bytes: one cp.async chunk
DKV_DESIGNS = ("mma_sync", "wgmma")  # flash_bwd_dkv's `design` argument, in order
WGMMA_PAIRS = ((128, 128), (192, 128))
# csrc/flash_bwd.cu's DkvWg<D, DV>::BN and ::BQ: change them together
WGMMA_KEYS = 128    # keys a block of the wgmma kernel
WGMMA_ROWS = {128: 64, 192: 32}  # stacked q rows a tile of it, by d: a position's G heads fit


def _check(q, k, v, mixed):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or k.shape[:3] != v.shape[:3]:
        raise ValueError(f"flash attention: q (B,H,Tq,d), k (B,KV,Tk,d) and v (B,KV,Tk,dv); "
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


def check_head_dim(d: int, dv: int = None, dtype=torch.bfloat16) -> None:
    """Raise unless the kernels are built for q's and k's width `d` and
    v's `dv` (default d) in `dtype`."""
    dv = d if dv is None else dv
    if dv != d:
        if (d, dv) not in WIDE_PAIRS or dtype != torch.bfloat16:
            raise ValueError(f"flash attention kernel takes (d, dv) in {WIDE_PAIRS} in bf16 "
                             f"or d == dv, got ({d}, {dv}) in {dtype}")
    elif d not in HEAD_DIMS:
        raise ValueError(f"flash attention kernel takes head_dim in {HEAD_DIMS}, got {d}")


def aligned(t) -> bool:
    """Whether the attention kernels' 16-byte copies can read or write
    `t` (B, H, T, d) as it lies: contiguous head dim, base address
    and every (batch, head, time) stride a multiple of 16 bytes (a stride of
    a size-1 dim is never used)."""
    esz = t.element_size()
    return (t.stride(3) == 1 and t.data_ptr() % ALIGN == 0
            and all(n == 1 or t.stride(i) * esz % ALIGN == 0
                    for i, n in enumerate(t.shape[:3])))


def check_aligned(*ts) -> None:
    """Raise on the first tensor `aligned` refuses: there is no scalar path."""
    for t in ts:
        if not aligned(t):
            raise ValueError(
                f"flash attention kernel needs 16-byte aligned rows: shape "
                f"{tuple(t.shape)}, strides {t.stride()}, {t.element_size()}-byte "
                f"elements, address {t.data_ptr():#x}")


def _strides(*ts):
    """(batch, head, time) strides of each tensor, checked for the kernels'
    contiguous head dim and 32-bit indexing."""
    out = []
    for t in ts:
        if t.stride(3) != 1:
            raise ValueError("flash attention kernel needs a contiguous head dim")
        if sum((n - 1) * s for n, s in zip(t.shape, t.stride())) > _INT_MAX:
            raise ValueError("flash attention kernel indexes with 32-bit strides")
        out += [t.stride(0), t.stride(1), t.stride(2)]
    return out


def _check_kernel(q, v):
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash attention: unsupported device {q.device}")
    if q.dtype not in DTYPES:
        raise TypeError(f"flash attention kernel takes {DTYPES}, got {q.dtype}")
    check_head_dim(q.shape[3], v.shape[3], q.dtype)


def _like_q(q, dv):
    """An empty (B, H, Tq, dv) in q's dtype and memory layout: q's own
    shape where dv is its width, else (B, Tq, H, dv) seen as (B, H, Tq, dv)
    where q's heads are its inner axis (the model's layout)."""
    if dv == q.shape[3]:
        return torch.empty_like(q)
    B, H, Tq, _ = q.shape
    if q.stride(1) < q.stride(2):
        return q.new_empty((B, Tq, H, dv)).transpose(1, 2)
    return q.new_empty((B, H, Tq, dv))


@cost.counted("flash_attention_fwd", cost.attention_fwd)
def flash_attention_fwd(q, k, v, *, scale, causal=True, window=0, cap=0.0,
                        kv_len=None, mixed=False):
    """q: (B, H, Tq, d); k: (B, KV, Tk, d); v: (B, KV, Tk, dv). Returns (o
    (B, H, Tq, dv) in q's dtype, lse (B, H, Tq) fp32). Masks: causal (k <= q), sliding window
    (q - k < window), tail (k < kv_len); logits soft-capped as
    tanh(s / cap) * cap before the mask."""
    _check(q, k, v, mixed)
    if q.device.type == "cpu":
        return attention_fwd_ref(q, k, v, scale=scale, causal=causal,
                                 window=window, cap=cap, kv_len=kv_len,
                                 mixed=mixed)
    _check_kernel(q, v)
    B, H, Tq, d = q.shape
    KV, Tk, dv = k.shape[1], k.shape[2], v.shape[3]
    o = _like_q(q, dv)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    check_aligned(q, k, v, o)
    if q.device.type == "meta":
        return o, lse
    strides = _strides(q, k, v, o)
    kv_len = Tk if kv_len is None else min(int(kv_len), Tk)
    lib = _build.library()
    err = lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                        lse.data_ptr(), B, H, KV, Tq, Tk, d, dv, *strides,
                        float(scale), int(causal), int(window), float(cap or 0.0),
                        kv_len, int(q.dtype == torch.bfloat16), int(mixed),
                        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_fwd")
    _build.count_launch(flash_attention_fwd)
    return o, lse


flash_attention_fwd.launches = 0


# -- backward ---------------------------------------------------------------------

def _bwd_args(q, k, v, do, **stats):
    """Check the backward's inputs; return the (B, H, Tq) fp32 `stats` (lse,
    delta) contiguous."""
    _check(q, k, v, False)
    if (do.shape != q.shape[:3] + v.shape[3:] or do.dtype != q.dtype
            or do.device != q.device):
        raise ValueError(f"flash backward: dO {tuple(do.shape)} {do.dtype} does not "
                         f"match q {tuple(q.shape)} {q.dtype} and v's width {v.shape[3]}")
    for name, t in stats.items():
        if t.shape != q.shape[:3] or t.dtype != torch.float32 or t.device != q.device:
            raise ValueError(f"flash backward: {name} must be (B, H, Tq) fp32 on q's device")
    if q.device.type != "cpu":
        _check_kernel(q, v)
    return [t.contiguous() for t in stats.values()]


@cost.counted("flash_attention_bwd_dq", cost.attention_bwd_dq)
def flash_attention_bwd_dq(q, k, v, o, do, lse, *, scale, causal=True,
                           window=0, cap=0.0, kv_len=None):
    """(dq, delta): dq (B, H, Tq, d) in q's dtype and layout, accumulated in
    fp32 over the live KV tiles, and delta = rowsum(dO * O) (B, H, Tq) fp32
    for every row, which `flash_attention_bwd_dkv` takes. o is the forward's
    output as it stored it (q's dtype); the kernel computes delta in its
    prologue, so there is no separate preprocess launch."""
    if o.shape != do.shape or o.dtype != do.dtype or o.device != do.device:
        raise ValueError(f"flash backward: o {tuple(o.shape)} {o.dtype} and dO "
                         f"{tuple(do.shape)} {do.dtype} differ")
    (lse,) = _bwd_args(q, k, v, do, lse=lse)
    kw = dict(scale=scale, causal=causal, window=window, cap=cap, kv_len=kv_len)
    if q.device.type == "cpu":
        delta = attention_bwd_preprocess_ref(o, do)
        return attention_bwd_grads_ref(q, k, v, do, lse, delta, **kw)[0], delta
    B, H, Tq, d = q.shape
    KV, Tk, dv = k.shape[1], k.shape[2], v.shape[3]
    dq = torch.empty_like(q)
    delta = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    check_aligned(q, k, v, o, do, dq)
    if q.device.type == "meta":
        return dq, delta
    strides = _strides(q, k, v, o, do, dq)
    kv_len = Tk if kv_len is None else min(int(kv_len), Tk)
    lib = _build.library()
    err = lib.flash_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                           do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                           B, H, KV, Tq, Tk, d, dv, *strides,
                           float(scale), int(causal), int(window), float(cap or 0.0),
                           kv_len, int(q.dtype == torch.bfloat16),
                           torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_bwd_dq")
    _build.count_launch(flash_attention_bwd_dq)
    return dq, delta


def dkv_design(q, k, v) -> str:
    """The dk/dv kernel for q (B, H, Tq, d), k (B, KV, Tk, d), v (B, KV,
    Tk, dv), from shapes and dtype alone: "wgmma" for bf16 at (d, dv) in
    WGMMA_PAIRS with Tk >= WGMMA_KEYS and G = H / KV <= WGMMA_ROWS[d],
    else "mma_sync" (the env step's short unrolls, the other widths, fp32)."""
    if (q.dtype == torch.bfloat16 and (q.shape[3], v.shape[3]) in WGMMA_PAIRS
            and k.shape[2] >= WGMMA_KEYS and q.shape[1] // k.shape[1] <= WGMMA_ROWS[q.shape[3]]):
        return "wgmma"
    return "mma_sync"


@cost.counted("flash_attention_bwd_dkv", cost.attention_bwd_dkv)
def flash_attention_bwd_dkv(q, k, v, do, lse, delta, *, scale, causal=True,
                            window=0, cap=0.0, kv_len=None):
    """(dk, dv), like k and v in k's dtype and their layouts: the sum over
    each KV head's G query heads, accumulated in fp32 in one block."""
    lse, delta = _bwd_args(q, k, v, do, lse=lse, delta=delta)
    kw = dict(scale=scale, causal=causal, window=window, cap=cap, kv_len=kv_len)
    if q.device.type == "cpu":
        return attention_bwd_grads_ref(q, k, v, do, lse, delta, **kw)[1:]
    B, H, Tq, d = q.shape
    KV, Tk, dvw = k.shape[1], k.shape[2], v.shape[3]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    check_aligned(q, k, v, do, dk, dv)
    if q.device.type == "meta":
        return dk, dv
    strides = _strides(q, k, v, do, dk, dv)
    kv_len = Tk if kv_len is None else min(int(kv_len), Tk)
    design = dkv_design(q, k, v)
    lib = _build.library()
    err = lib.flash_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                            B, H, KV, Tq, Tk, d, dvw, *strides,
                            float(scale), int(causal), int(window), float(cap or 0.0),
                            kv_len, int(q.dtype == torch.bfloat16), DKV_DESIGNS.index(design),
                            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_bwd_dkv")
    _build.count_launch(flash_attention_bwd_dkv, design)
    return dk, dv


for _fn in (flash_attention_bwd_dq, flash_attention_bwd_dkv):
    _fn.launches = 0
flash_attention_bwd_dkv.design_launches = dict.fromkeys(DKV_DESIGNS, 0)


def flash_attention_bwd(q, k, v, o, lse, do, *, scale, causal=True, window=0,
                        cap=0.0, kv_len=None):
    """(dq, dk, dv) of attention from the forward's o and lse: the dq kernel
    (which also writes delta) and then the dk/dv kernel, on one stream; on
    the CPU their plain versions as one `attention_bwd_ref`, reported to
    the counter as the two kernels' calls."""
    kw = dict(scale=scale, causal=causal, window=window, cap=cap, kv_len=kv_len)
    if q.device.type == "cpu":
        with cost.kernel_scope():
            delta, dq, dk, dv = attention_bwd_ref(q, k, v, o, lse, do, **kw)
        cost.report("flash_attention_bwd_dq", cost.attention_bwd_dq,
                    (q, k, v, o, do, lse), kw, (dq, delta))
        cost.report("flash_attention_bwd_dkv", cost.attention_bwd_dkv,
                    (q, k, v, do, lse, delta), kw, (dk, dv))
        return dq, dk, dv
    dq, delta = flash_attention_bwd_dq(q, k, v, o, do, lse, **kw)
    return (dq,) + flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)


class _FlashAttention(torch.autograd.Function):
    """Forward: the forward kernel, saving (q, k, v, o, lse). Backward: the
    two backward kernels, recomputing in fp32 (also after a `mixed`
    forward, as `repro`'s backward does)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window, cap, kv_len, mixed):
        o, lse = flash_attention_fwd(q, k, v, scale=scale, causal=causal, window=window,
                                     cap=cap, kv_len=kv_len, mixed=mixed)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = dict(scale=scale, causal=causal, window=window, cap=cap, kv_len=kv_len)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if not aligned(do):               # a fresh copy has 16-byte rows
            do = do.clone(memory_format=torch.contiguous_format)
        return flash_attention_bwd(q, k, v, o, lse, do, **ctx.kw) + (None,) * 6


def flash_attention(q, k, v, *, scale, causal=True, window=0, cap=0.0,
                    kv_len=None, mixed=False):
    """Differentiable attention: (B, H, Tq, dv), like `flash_attention_fwd`
    without the lse."""
    return _FlashAttention.apply(q, k, v, scale, causal, window, cap, kv_len, mixed)
