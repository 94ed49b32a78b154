"""Device policy for the port.

Entry points take an optional `device`. `None` means CUDA: the port is
written for the card, and a host without one must ask for the CPU by name
(`device="cpu"`, as the CPU tests do) rather than quietly running there.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` -> cuda. Raises when CUDA is asked for (explicitly or by
    default) and this process has no CUDA device."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch versions")
    return dev
