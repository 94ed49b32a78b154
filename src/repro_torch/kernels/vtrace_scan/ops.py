"""Reverse discounted scan: the CUDA kernel for CUDA tensors, the plain
version for CPU tensors, and its closed-form gradient.

Replaces `repro.kernels.vtrace_scan.kernel.reverse_discounted_scan_p`
(`_scan_kernel`); the kernel is `csrc/reverse_scan.cu`, whose header says
what bounds it and how it is laid out. Unlike `repro`'s `ops.py`, nothing
is padded to a batch block: the kernel masks its own ragged edges and
takes any alignment (16-byte loads where it can, scalar ones elsewhere).
`reverse_discounted_scan_p.launches` counts kernel launches and nothing
else. A meta tensor is checked as the card's would be, but for the
kernel's 32-bit index limit (nothing is indexed), and gets the kernel's
output and input copies and no launch (shape-only evaluation);
`cost.reverse_scan` is the kernel's work.

`reverse_discounted_scan` is differentiable with the closed-form transpose
of `repro`'s `ops._closed_form_bwd`. The recurrence
y_t = delta_t + decay_t * y_{t+1} is linear in (deltas, init), so its
transpose is the same recurrence run the other way:

    ybar_u = g_u + decay_{u-1} * ybar_{u-1}        (ybar_0 = g_0)
    d_deltas = ybar
    d_decays_u = ybar_u * y_{u+1}                  (y_T = init)
    d_init = ybar_{T-1} * decay_{T-1}

and a forward scan is a reverse scan of flipped arrays, so the backward
launches the same kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, cost
from repro_torch.kernels.vtrace_scan.ref import reverse_discounted_scan_ref

DTYPES = (torch.float32, torch.bfloat16)


@cost.counted("reverse_discounted_scan_p", cost.reverse_scan)
def reverse_discounted_scan_p(deltas, decays, init):
    """deltas, decays: (B, T) fp32 or bf16; init: (B,). Returns y: (B, T)
    fp32 with y_t = delta_t + decay_t * y_{t+1} and y_T = init."""
    if deltas.dim() != 2 or decays.shape != deltas.shape or init.shape != deltas.shape[:1]:
        raise ValueError(f"reverse scan: deltas and decays (B, T), init (B,); got "
                         f"{tuple(deltas.shape)}, {tuple(decays.shape)}, {tuple(init.shape)}")
    if not (deltas.device == decays.device == init.device):
        raise ValueError("reverse scan: inputs on different devices")
    if deltas.device.type == "cpu":
        return reverse_discounted_scan_ref(deltas, decays, init)
    if deltas.device.type not in ("cuda", "meta"):
        raise ValueError(f"reverse scan: unsupported device {deltas.device}")
    if deltas.dtype != decays.dtype or deltas.dtype not in DTYPES:
        raise TypeError(f"reverse scan kernel takes deltas and decays of one dtype in "
                        f"{DTYPES}, got {deltas.dtype} and {decays.dtype}")
    B, T = deltas.shape
    deltas, decays = deltas.contiguous(), decays.contiguous()
    init = init.float().contiguous()
    y = torch.empty((B, T), dtype=torch.float32, device=deltas.device)
    if deltas.device.type == "meta":
        return y
    if deltas.numel() >= 2 ** 31:
        raise ValueError("reverse scan kernel indexes with 32-bit ints")
    lib = _build.library()
    err = lib.reverse_scan(deltas.data_ptr(), decays.data_ptr(), init.data_ptr(),
                           y.data_ptr(), B, T, int(deltas.dtype == torch.bfloat16),
                           torch.cuda.current_stream(deltas.device).cuda_stream)
    _build.check(err, "reverse_scan")
    _build.count_launch(reverse_discounted_scan_p)
    return y


reverse_discounted_scan_p.launches = 0


def _closed_form_bwd(deltas, decays, init, y, g):
    """Grads of sum(y * g) for (deltas, decays, init), through the same
    scan on flipped arrays; each grad in its primal's dtype."""
    B = g.shape[0]
    g32, dec32 = g.float(), decays.float()
    # ybar's recurrence indexes decay_{u-1}: shift right, zero-fill
    shifted = torch.cat([dec32.new_zeros(B, 1), dec32[:, :-1]], dim=1)
    ybar = reverse_discounted_scan_p(g32.flip(1), shifted.flip(1),
                                     g32.new_zeros(B)).flip(1)
    y_next = torch.cat([y[:, 1:], init.float()[:, None]], dim=1)
    return (ybar.to(deltas.dtype), (ybar * y_next).to(decays.dtype),
            (ybar[:, -1] * dec32[:, -1]).to(init.dtype))


class _ReverseScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, deltas, decays, init):
        y = reverse_discounted_scan_p(deltas, decays, init)
        ctx.save_for_backward(deltas, decays, init, y)
        return y

    @staticmethod
    def backward(ctx, g):
        return _closed_form_bwd(*ctx.saved_tensors, g)


def reverse_discounted_scan(deltas, decays, init=None):
    """Differentiable reverse scan: (B, T) -> (B, T) fp32; init defaults to
    zeros (B,) fp32."""
    if init is None:
        init = torch.zeros(deltas.shape[:1], dtype=torch.float32, device=deltas.device)
    return _ReverseScan.apply(deltas, decays, init)
