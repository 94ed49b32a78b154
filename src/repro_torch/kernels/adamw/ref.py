"""Plain PyTorch versions of AdamW's per-leaf update and the global
norm's clip scale (the optimizer of `repro.optim.optimizers`, which XLA
fuses: no Pallas kernel); the norm itself is `utils.tree_global_norm`.

The CPU path of `ops.py`'s wrappers, and what the CUDA kernels are held
against on the card. The kernels repeat this arithmetic op for op, in
fp32.
"""
from __future__ import annotations

import torch


def clip_scale_ref(norm, max_norm):
    """min(1, max_norm / (norm + 1e-9)), an fp32 scalar tensor."""
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0)


def scaled_ref(g, scale):
    """g times the clip scale, rounded to g's dtype (JAX's clip)."""
    return (g.float() * scale).to(g.dtype)


def adamw_ref(g, m, v, base, scale, lr, bc1, bc2, *, b1, b2, eps, weight_decay):
    """One leaf's (or slice's) AdamW step: its new fp32 moments and base.
    `scale` (the clip's, or None), `lr`, `bc1` and `bc2` (the bias
    corrections) are fp32 scalar tensors; `base` is the fp32 master or the
    param."""
    g32 = (g if scale is None else scaled_ref(g, scale)).float()
    m = b1 * m + (1 - b1) * g32
    v = b2 * v + (1 - b2) * torch.square(g32)
    u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
    if weight_decay:
        u = u + weight_decay * base.float()
    return m, v, base.float() - lr * u
