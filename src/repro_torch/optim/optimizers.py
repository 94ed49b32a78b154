"""Pure-pytree optimizers: AdamW, SGD, global-norm clip (counterpart of
`repro.optim.optimizers`).

Functional, as in `repro`: `update(grads, state, params)` returns new
params, a new state and metrics, and changes none of its arguments. Params
and grads are nested dicts of tensors; the state is a dict of tensors on
the params' device with `repro`'s keys (`step`, `mu`, `nu`, and `master`
for `adamw(..., master_fp32=True)`, which keeps fp32 master params and
moments in the state while the model params may be bf16).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.utils import tree_global_norm, tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple]   # (grads, state, params) -> (new_params, state, metrics)


def clip_by_global_norm(grads, max_norm):
    norm = tree_global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


def _lr(lr_fn, step):
    """lr at `step` as an fp32 scalar tensor on the step's device."""
    return torch.as_tensor(lr_fn(step), dtype=torch.float32, device=step.device)


def _step0(params):
    device = tree_leaves(params)[0].device
    return torch.zeros((), dtype=torch.int32, device=device)


def sgd(lr: float | Callable, momentum: float = 0.0, clip_norm: float = 0.0):
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        mu = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                      params) if momentum else None
        return {"step": _step0(params), "mu": mu}

    def update(grads, state, params):
        gnorm = tree_global_norm(grads)
        if clip_norm:
            grads, _ = clip_by_global_norm(grads, clip_norm)
        step = state["step"] + 1
        lr_t = _lr(lr_fn, step)
        if momentum:
            mu = tree_map(lambda m, g: momentum * m + g.float(), state["mu"], grads)
            upd = mu
        else:
            mu = None
            upd = tree_map(lambda g: g.float(), grads)
        new_params = tree_map(lambda p, u: (p.float() - lr_t * u).to(p.dtype), params, upd)
        return new_params, {"step": step, "mu": mu}, {"grad_norm": gnorm, "lr": lr_t}

    return Optimizer(init, update)


def adamw(lr: float | Callable, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
          clip_norm: float = 0.0, master_fp32: bool = False):
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        zeros32 = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        state = {"step": _step0(params), "mu": tree_map(zeros32, params),
                 "nu": tree_map(zeros32, params)}
        if master_fp32:
            state["master"] = tree_map(lambda p: p.float(), params)
        return state

    def update(grads, state, params):
        gnorm = tree_global_norm(grads)
        if clip_norm:
            grads, _ = clip_by_global_norm(grads, clip_norm)
        step = state["step"] + 1
        lr_t = _lr(lr_fn, step)
        g32 = tree_map(lambda g: g.float(), grads)
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state["mu"], g32)
        nu = tree_map(lambda n, g: b2 * n + (1 - b2) * torch.square(g), state["nu"], g32)
        bc1 = 1 - b1 ** step.float()
        bc2 = 1 - b2 ** step.float()

        base = state.get("master", params)

        def upd(p, m, n):
            u = (m / bc1) / (torch.sqrt(n / bc2) + eps)
            if weight_decay:
                u = u + weight_decay * p.float()
            return p.float() - lr_t * u

        new_base = tree_map(upd, base, mu, nu)
        new_state = {"step": step, "mu": mu, "nu": nu}
        if master_fp32:
            new_state["master"] = new_base
        new_params = tree_map(lambda b, p: b.to(p.dtype), new_base, params)
        return new_params, new_state, {"grad_norm": gnorm, "lr": lr_t}

    return Optimizer(init, update)
