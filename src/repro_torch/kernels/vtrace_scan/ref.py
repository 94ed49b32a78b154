"""Plain PyTorch version of the reverse discounted scan (counterpart of
`repro.kernels.vtrace_scan.ref.reverse_discounted_scan_ref`).

The CPU path of `ops.reverse_discounted_scan_p`, and what the CUDA kernel
is held against on the card: a loop over T in fp32, right to left, in the
order of the TPU kernel's `fori_loop`.
"""
from __future__ import annotations

import torch


def reverse_discounted_scan_ref(deltas, decays, init):
    """y_t = delta_t + decay_t * y_{t+1}; y beyond T-1 is `init`.
    deltas, decays: (B, T); init: (B,). Returns (B, T) fp32."""
    d, c = deltas.float(), decays.float()
    y = torch.empty_like(d)
    carry = init.float()
    for t in range(d.shape[1] - 1, -1, -1):
        carry = d[:, t] + c[:, t] * carry
        y[:, t] = carry
    return y
