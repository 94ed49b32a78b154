"""Card tensors to host memory in one device-to-host copy."""
from __future__ import annotations

from typing import Any, List

import numpy as np
import torch

from repro_torch.utils.pytree import tree_leaves, tree_map


def host_bytes(tensors: List[torch.Tensor]) -> List[np.ndarray]:
    """The raw bytes of each CUDA tensor (all on one device) as flat uint8
    arrays. The tensors are packed into one byte buffer on the card and
    copied into pinned host memory at once, so the caller waits for the
    device once rather than once per tensor. The arrays are views of that
    pinned buffer."""
    flat = torch.cat([x.detach().contiguous().reshape(-1).view(torch.uint8) for x in tensors])
    buf = torch.empty(flat.numel(), dtype=torch.uint8, pin_memory=True)
    buf.copy_(flat, non_blocking=True)
    torch.cuda.current_stream(flat.device).synchronize()
    raw, out, ofs = buf.numpy(), [], 0
    for x in tensors:
        n = x.numel() * x.element_size()
        out.append(raw[ofs:ofs + n])
        ofs += n
    return out


def to_host(tree: Any) -> Any:
    """`tree` with every tensor leaf replaced by a numpy array that owns its
    memory (bf16 leaves, which numpy lacks, as fp32, which holds them
    exactly); other leaves pass through. The CUDA leaves come over in one
    copy (`host_bytes`)."""
    def widen(x):
        if isinstance(x, torch.Tensor):
            x = x.detach()
            return x.float() if x.dtype == torch.bfloat16 else x
        return x
    tree = tree_map(widen, tree)
    dev = [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor) and x.is_cuda]
    host = {}
    if dev:
        for x, raw in zip(dev, host_bytes(dev)):
            dtype = torch.empty(0, dtype=x.dtype).numpy().dtype
            host[id(x)] = raw.view(dtype).reshape(x.shape).copy()

    def leaf(x):
        if not isinstance(x, torch.Tensor):
            return x
        return host[id(x)] if x.is_cuda else x.numpy().copy()
    return tree_map(leaf, tree)
