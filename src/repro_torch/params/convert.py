"""Param trees between the two packages.

`repro` hands its params over as nested dicts of numpy arrays
(`np.asarray` on each leaf); the port's layout is the same nested dict with
the same keys and shapes, so conversion is leaf by leaf. bfloat16 leaves
(numpy's `ml_dtypes.bfloat16`) travel through float32, which holds every
bf16 value exactly.

Optimizer states cross the same way (`opt_state_from_reference`): `repro`'s
`adamw` and `sgd` states are dicts of `step` (int32 scalar), the moment
trees `mu` and `nu` (`mu` is None for sgd without momentum) and, with
`master_fp32`, the fp32 `master` params, which is the port's layout too.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils import tree_map


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    return torch.tensor(a, device=device)         # a copy the port owns


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def from_reference(tree, device) -> dict:
    """Nested dict of numpy arrays (a `repro` param tree) -> tensors on
    `device`, same keys and shapes."""
    return tree_map(lambda a: _to_tensor(a, device), tree)


def to_reference(tree) -> dict:
    """Inverse of `from_reference`: tensors -> host numpy arrays (bf16
    leaves come back as float32)."""
    return tree_map(_to_numpy, tree)


OPT_STATE_KEYS = {"step", "mu", "nu", "master"}


def opt_state_from_reference(state, device) -> dict:
    """A `repro` optimizer state (leaves as numpy arrays) -> the port's, on
    `device`: the same keys, tensors leaf by leaf, `step` an int32 scalar."""
    unknown = set(state) - OPT_STATE_KEYS
    if "step" not in state or unknown:
        raise ValueError(f"not a repro adamw/sgd state: keys {sorted(state)}")
    out = {k: from_reference(v, device) for k, v in state.items()}
    out["step"] = out["step"].to(torch.int32)
    return out
