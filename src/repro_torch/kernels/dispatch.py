"""Kernel dispatch: route the model's and the learner's hot ops to their
CUDA kernels.

Counterpart of `repro.kernels.dispatch`. One chokepoint counts, per call,
which tier an op runs as:

  * ``kernel``    - the hand-written CUDA kernel (`csrc/`), for CUDA tensors;
  * ``reference`` - the plain PyTorch version beside it, for CPU tensors.

The tensor's device alone decides, and the kernel wrappers own that
decision: a CUDA tensor launches the kernel or the wrapper raises, and
nothing on the card falls back to the plain version. AdamW's norm and
update (`optim/optimizers.py`) follow the same rule and count here as
``global_norm`` and ``adamw``, one count an update (a DTensor's by its
local shard). `repro`'s modes
(``REPRO_KERNELS``, ``force``, ``set_mode``) have no counterpart here.

Inference-only precision (`REPRO_KERNELS_INFER=bf16`): inside a
``serving()`` scope (the InfServer runs its forwards in one) attention
takes bf16 inputs, runs the kernel's mixed path (probabilities rounded to
bf16 before p.V, fp32 accumulation) and returns in the caller's dtype.
Outside a serving scope the flag is inert, so a learner's forward never
picks it up.

Shape-only evaluation (`abstract()`): inside that scope (per thread) meta
tensors resolve to the ``meta`` tier and each op runs the kernel's wrapper
as on the card, which on meta tensors allocates the kernel's outputs and
launches nothing; the dry-run (`launch/dryrun.py`) evaluates steps and
counts their work so, as `jax.eval_shape` does, and the count on meta is
the count on the card. Outside it a meta tensor raises, as any device but
CUDA and the CPU does.

Every call is counted: ``stats()`` returns ``{"op|tier|detail": count}``.
The port runs eagerly, so these are per-call counts, one per executed op;
`repro` counts per trace, once per compilation. A forward that
`torch.utils.checkpoint` recomputes in the backward (`remat=True`) is
counted again.

All three ops are differentiable on both devices: attention's backward is
the flash backward kernels (`flash_attention/ops.py`), rmsnorm's is
autograd through its plain version, and reverse_scan's is the same scan
kernel on flipped arrays (`vtrace_scan/ops.py`).
"""
from __future__ import annotations

import collections
import os
import threading
from contextlib import contextmanager

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention as _flash_attention
from repro_torch.kernels.rmsnorm.ops import rmsnorm as _rmsnorm
from repro_torch.kernels.vtrace_scan.ops import reverse_discounted_scan as _reverse_scan

INFER_MODES = ("bf16",)

# serving scope is per-thread: the InfServer's act path must not flip the
# learner thread's precision
_serving = threading.local()

_stats_lock = threading.Lock()
_stats = collections.Counter()


def resolve(x: torch.Tensor) -> str:
    """The tier a call on `x` runs as: 'kernel' on CUDA, 'reference' on the
    CPU. The device alone decides; there is no mode that sends CUDA tensors
    to the plain versions."""
    if x.device.type == "cuda":
        return "kernel"
    if x.device.type == "cpu":
        return "reference"
    if x.device.type == "meta" and getattr(_abstract, "active", False):
        return "meta"
    raise ValueError(f"dispatch: unsupported device {x.device}")


# shape-only evaluation is per-thread too
_abstract = threading.local()


@contextmanager
def abstract():
    """Meta tensors run the plain versions (shapes only) inside this scope."""
    prev = getattr(_abstract, "active", False)
    _abstract.active = True
    try:
        yield
    finally:
        _abstract.active = prev


# -- inference-only precision --------------------------------------------------

@contextmanager
def serving():
    """Marks the enclosed forwards as inference-only (the InfServer act
    path). Inside this scope `infer_mode()` reports `REPRO_KERNELS_INFER`;
    outside it always returns None. Thread-local."""
    prev = getattr(_serving, "active", False)
    _serving.active = True
    try:
        yield
    finally:
        _serving.active = prev


def infer_mode():
    """'bf16' inside a serving() scope with REPRO_KERNELS_INFER=bf16, else None."""
    if not getattr(_serving, "active", False):
        return None
    m = os.environ.get("REPRO_KERNELS_INFER", "")
    return m if m in INFER_MODES else None


# -- telemetry -----------------------------------------------------------------

def note(op: str, tier: str, detail=()) -> None:
    """Count one dispatched call: key = 'op|tier[|detail...]'."""
    key = "|".join((op, tier) + tuple(detail))
    with _stats_lock:
        _stats[key] += 1


def stats(reset: bool = False) -> dict:
    """Snapshot of dispatched calls: {'op|tier|detail': count}, one count
    per executed call."""
    with _stats_lock:
        snap = dict(_stats)
        if reset:
            _stats.clear()
    return snap


# -- dispatched ops ------------------------------------------------------------

def rmsnorm(x, w, *, eps: float = 1e-6):
    """Fused RMSNorm over the last axis. x: (..., d); w: (d,), or (M, d)
    with x's leading axis M."""
    note("rmsnorm", resolve(x))
    return _rmsnorm(x, w, eps=eps)


def attention(q, k, v, *, scale, causal=True, window=0, cap=0.0):
    """Fused attention, kernel layout: q (B, H, Tq, d); k, v (B, KV, Tk, d).

    Callers with the model layout (B, T, H, d) pass transposed views (see
    models/attention.chunked_attend); the kernel reads them through their
    strides. Returns (B, H, Tq, d) in q's dtype."""
    mixed = infer_mode() == "bf16"
    note("attention", resolve(q), ("bf16",) if mixed else ())
    if not mixed:
        return _flash_attention(q, k, v, scale=scale, causal=causal,
                                window=window, cap=cap)
    bf = torch.bfloat16
    o = _flash_attention(q.to(bf), k.to(bf), v.to(bf), scale=scale,
                         causal=causal, window=window, cap=cap, mixed=True)
    return o.to(q.dtype)


def reverse_scan(deltas, decays, init=None):
    """y_t = delta_t + decay_t * y_{t+1}, y_T = init (zeros if None).
    (B, T) -> (B, T) fp32: the one primitive behind GAE, TD(lambda),
    discounted returns and the V-trace correction sum."""
    note("reverse_scan", resolve(deltas))
    return _reverse_scan(deltas, decays, init)
