"""The work of each hand-written kernel, from its shapes, dtypes and flags:
one copy of the formulas for every reader.

`chip_smoke.py`'s bound column and the per-rank counter
(`launch/counters.py`, which the dry-run reads) both take a kernel's work
from here. Each function takes the wrapper's own arguments and returns
`Work(flops, bytes)`:

  - bytes: HBM bytes the kernel must move, each input read once and each
    output written once (RMSNorm's weight and the scan's `init` at fp32,
    as the wrappers pass them);
  - flops: RMSNorm 4 per element, the scan 2, the norm's sum of squares
    2, AdamW 14 (the moments 7; u: three divisions, a square root and
    eps; lr times u and the subtraction), one more with the clip and two
    more with weight decay; attention counts the live
    (q, k) pairs that the causal, window and `kv_len` masks leave, with q's
    and k's width d and v's dv (d but for latent attention): the forward
    2·(d + dv) per pair, dq 2·(2·d + dv) per pair (the recomputed scores,
    dP, dQ) plus 2·dv per row for the delta prologue, dk/dv 4·(d + dv) per
    pair (scores, dP, dV, dK).

`counted(name, work)` marks a kernel wrapper for the counter: while a
listener is registered, each call adds one unit of `work(*args, **kw)`
under `name` to it, and the aten ops the wrapper runs (its allocations, or
on the CPU its plain version) are flagged as inside a kernel
(`inside_kernel()`), so the counter does not count them again. With no
listener a call costs one list test. A caller that runs several kernels'
plain versions as one computation flags it with `kernel_scope()` and
`report`s each kernel's call. `phase(name)` tells the listeners that a
step enters a phase (the train step's update), whose peak of temporaries
they keep apart.
"""
from __future__ import annotations

import contextlib
import functools
import threading
from typing import NamedTuple

import numpy as np


class Work(NamedTuple):
    flops: int
    bytes: int


def live_pairs(Tq: int, Tk: int, causal: bool = True, window: int = 0, kv_len=None) -> int:
    """(q, k) pairs with k < kv_len, k <= q under `causal`, q - k < window
    under `window` (the masks of `flash_attention/ref.py:_mask`)."""
    n = Tk if kv_len is None else min(int(kv_len), Tk)
    if n <= 0 or Tq <= 0:
        return 0
    q = np.arange(Tq, dtype=np.int64)
    hi = np.minimum(n - 1, q) if causal else np.full(Tq, n - 1, dtype=np.int64)
    lo = np.maximum(0, q - window + 1) if window else 0
    return int(np.clip(hi - lo + 1, 0, None).sum())


def rmsnorm(x, w, *_, **__) -> Work:
    return Work(4 * x.numel(), 2 * x.numel() * x.element_size() + w.numel() * 4)


def _attn(q, k, causal, window, kv_len):
    B, H, Tq, d = q.shape
    return B * H, Tq, d, live_pairs(Tq, k.shape[2], causal, window, kv_len)


def attention_fwd(q, k, v, *, causal=True, window=0, kv_len=None, **_) -> Work:
    """(B, H, Tq, d) q, (B, KV, Tk, d) k, (B, KV, Tk, dv) v; o (B, H, Tq,
    dv) in q's dtype, lse fp32."""
    bh, Tq, d, live = _attn(q, k, causal, window, kv_len)
    dv, esz = v.shape[3], q.element_size()
    return Work(2 * (d + dv) * bh * live,
                (q.numel() + bh * Tq * dv + k.numel() + v.numel()) * esz + bh * Tq * 4)


def attention_bwd_preprocess(o, *_, **__) -> Work:
    """delta = rowsum(dO ⊙ O): the dq kernel's prologue, no launch of its own."""
    B, H, Tq, d = o.shape
    return Work(2 * d * B * H * Tq, 2 * o.numel() * o.element_size() + B * H * Tq * 4)


def attention_bwd_dq(q, k, v, o, do, lse, *, causal=True, window=0, kv_len=None,
                     **_) -> Work:
    bh, Tq, d, live = _attn(q, k, causal, window, kv_len)
    dv, esz = v.shape[3], q.element_size()
    return Work(2 * (2 * d + dv) * bh * live + 2 * dv * bh * Tq,
                (2 * q.numel() + k.numel() + v.numel() + o.numel() + do.numel()) * esz
                + 2 * lse.numel() * 4)


def attention_bwd_dkv(q, k, v, do, lse, delta, *, causal=True, window=0, kv_len=None,
                      **_) -> Work:
    bh, Tq, d, live = _attn(q, k, causal, window, kv_len)
    dv, esz = v.shape[3], q.element_size()
    return Work(4 * (d + dv) * bh * live,
                (q.numel() + 2 * k.numel() + 2 * v.numel() + do.numel()) * esz
                + 2 * lse.numel() * 4)


def adamw(g, m, v, base, out, *, scale=None, weight_decay=0.0, **_) -> Work:
    """One leaf's step: g, m, v and the base (master or param) read; m, v,
    the master (when kept) and the param written, each in its dtype."""
    _, _, master_out, p_out = out
    n = g.numel()
    per = (g.element_size() + base.element_size() + 16 + p_out.element_size()
           + (4 if master_out is not None else 0))
    return Work((14 + (scale is not None) + 2 * bool(weight_decay)) * n, per * n)


def global_norm(grads, *_, **__) -> Work:
    """Every grad read once; the partial sums (4 bytes a block) and the
    finish are left out."""
    return Work(2 * sum(g.numel() for g in grads),
                sum(g.numel() * g.element_size() for g in grads))


def reverse_scan(deltas, decays, init, *_, **__) -> Work:
    """y_t = delta_t + decay_t · y_{t+1}: deltas and decays read in their
    dtype, init read and y written in fp32."""
    return Work(2 * deltas.numel(),
                2 * deltas.numel() * deltas.element_size() + init.numel() * 4
                + deltas.numel() * 4)


# -- the counter's hook ---------------------------------------------------------------

# the counters recording now: `launch/counters.Counter` adds itself on
# entry and removes itself on exit
listeners: list = []
_inside = threading.local()


def inside_kernel() -> bool:
    """Whether this thread is inside a counted kernel wrapper's call."""
    return getattr(_inside, "depth", 0) > 0


@contextlib.contextmanager
def kernel_scope():
    """Flags the aten ops run inside as a kernel's own (`inside_kernel()`)."""
    depth = getattr(_inside, "depth", 0)
    _inside.depth = depth + 1
    try:
        yield
    finally:
        _inside.depth = depth


def report(name: str, work, args, kw, out) -> None:
    """One call of kernel `name` on `args` and `kw`, returning `out`, to
    every listener, with its `work(*args, **kw)`; not from inside another
    kernel's call."""
    if listeners and not inside_kernel():
        w = work(*args, **kw)
        for listener in list(listeners):
            listener.kernel(name, w, out)


def phase(name: str) -> None:
    """Marks the start of a step's phase `name` (the train step's update)
    for every listener, which keeps each phase's peak of temporaries."""
    for listener in list(listeners):
        listener.phase(name)


def counted(name: str, work):
    """Decorator for a kernel wrapper: `name` is the kernel's, `work` maps
    the wrapper's arguments to its `Work`."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kw):
            if not listeners:
                return fn(*args, **kw)
            with kernel_scope():
                out = fn(*args, **kw)
            report(name, work, args, kw, out)
            return out
        return wrapper
    return deco
