"""RMSNorm wrapper: the CUDA kernel for CUDA tensors, the plain version for
CPU tensors; differentiable.

Replaces `repro.kernels.rmsnorm.kernel.rmsnorm_p` (`_rmsnorm_kernel`); the
kernel is `csrc/rmsnorm.cu`, whose header says what bounds it and how it is
laid out. There is no padding to a block multiple: the kernel masks its own
ragged edge. `rmsnorm.launches` counts kernel launches and nothing else.
A meta tensor is checked as the card's would be, but for the kernel's
32-bit index limit (nothing is indexed), and gets the kernel's output and
weight copy and no launch (shape-only evaluation); `cost.rmsnorm` is the
kernel's work.

The backward is autograd through `rmsnorm_ref` on the saved x and w, as
`repro/kernels/rmsnorm/ops.py:36-39` differentiates its reference: the
TPU backward is no Pallas kernel, so none is ported.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, cost
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

DTYPES = (torch.float32, torch.bfloat16)


@cost.counted("rmsnorm", cost.rmsnorm)
def _rmsnorm_fwd(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    d = x.shape[-1]
    if w.dim() not in (1, 2) or w.shape[-1] != d:
        raise ValueError(f"rmsnorm: weight {tuple(w.shape)} does not match d={d}")
    if w.dim() == 2 and (x.dim() < 2 or x.shape[0] != w.shape[0]):
        raise ValueError(f"rmsnorm: (M, d) weight {tuple(w.shape)} needs x with "
                         f"leading axis M, got {tuple(x.shape)}")
    if w.device != x.device:
        raise ValueError(f"rmsnorm: x on {x.device}, weight on {w.device}")
    if x.device.type == "cpu":
        return rmsnorm_ref(x, w, eps)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"rmsnorm: unsupported device {x.device}")
    if x.dtype not in DTYPES:
        raise TypeError(f"rmsnorm kernel takes {DTYPES}, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("rmsnorm kernel needs a contiguous x")
    w = w.float().contiguous()
    y = torch.empty_like(x)
    if x.device.type == "meta":
        return y
    if x.numel() >= 2 ** 31:
        raise ValueError("rmsnorm kernel indexes with 32-bit ints")
    rows = x.numel() // d if d else 0
    rows_per_weight = rows // w.shape[0] if w.dim() == 2 else max(rows, 1)
    lib = _build.library()
    err = lib.rmsnorm_fwd(x.data_ptr(), w.data_ptr(), y.data_ptr(), rows, d,
                          rows_per_weight, eps, int(x.dtype == torch.bfloat16),
                          torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "rmsnorm_fwd")
    _build.count_launch(rmsnorm)
    return y


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return _rmsnorm_fwd(x, w, eps)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        x = x.detach().requires_grad_(ctx.needs_input_grad[0])
        w = w.detach().requires_grad_(ctx.needs_input_grad[1])
        inputs = [t for t in (x, w) if t.requires_grad]
        with torch.enable_grad():
            grads = iter(torch.autograd.grad(rmsnorm_ref(x, w, ctx.eps), inputs, g))
        return (next(grads) if x.requires_grad else None,
                next(grads) if w.requires_grad else None, None)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """y = x * rsqrt(mean(x^2) + eps) * w over the last axis, in x's dtype.

    x: (..., d); w: (d,), or (M, d) with x.shape[0] == M (one weight row
    per model)."""
    return _RMSNorm.apply(x, w, eps)


rmsnorm.launches = 0
