"""Plain PyTorch version of the fused RMSNorm (counterpart of
`repro.kernels.rmsnorm.ref.rmsnorm_ref`).

The CPU path of `ops.rmsnorm`, and what the CUDA kernel is held against on
the card. `w` may carry a leading model axis: (M, d) weights for an x whose
leading axis is M, one weight row per model (the grouped InfServer
forward)."""
from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    wf = w.float()
    if w.dim() == 2:
        wf = wf.reshape(w.shape[0], *([1] * (x.dim() - 2)), w.shape[1])
    return (xf * torch.rsqrt(var + eps) * wf).to(x.dtype)
