"""Pure-pytree optimizers: AdamW, SGD, global-norm clip (counterpart of
`repro.optim.optimizers`).

Functional, as in `repro`: `update(grads, state, params)` returns new
params, a new state and metrics, and changes none of its arguments. Params
and grads are nested dicts of tensors; the state is a dict of tensors on
the params' device with `repro`'s keys (`step`, `mu`, `nu`, and `master`
for `adamw(..., master_fp32=True)`, which keeps fp32 master params and
moments in the state while the model params may be bf16).

`adamw(..., inplace=True)` is the one exception, the counterpart of a JAX
caller donating params and state to a jitted step: the update writes the
new params, moments and master params into the tensors it was given and
returns them. A functional update holds the old and the new params and
moments at once (32 bytes a param for fp32 adamw), which at 2-4 B params
does not fit one card; in place, each leaf is updated in flat slices of
2^24 elements (a leaf's first axis may be the layer stack, of length 1),
so the update's own memory is a few slices of temporaries. The
numbers are the functional update's, bit for bit: both run one per-leaf
body (`leaf` in `adamw`), the in-place one slice by slice. Traced
(`utils/trace.py`), adamw's update is the phases `optim.norm` (the global
norm, the clip scale, the lr and the bias corrections) and `optim.update`
(the loop over the leaves, and the functional update's casts to the
params' dtype).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.utils import trace, tree_global_norm, tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple]   # (grads, state, params) -> (new_params, state, metrics)


def _clip_scale(norm, max_norm):
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0)


def _scaled(g, scale):
    return (g.float() * scale).to(g.dtype)


def clip_by_global_norm(grads, max_norm):
    norm = tree_global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: _scaled(g, scale), grads), norm


def _lr(lr_fn, step):
    """lr at `step` as an fp32 scalar tensor on the step's device."""
    return torch.as_tensor(lr_fn(step), dtype=torch.float32, device=step.device)


def _like(tree, leaves):
    """`leaves` (in `tree_leaves` order) in `tree`'s structure."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


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


_SLICE_ELEMS = 1 << 24       # elements per slice of an in-place update


def _flat(t):
    """`t`'s elements as one flat view, which an in-place update writes
    through."""
    if not t.is_contiguous():
        raise ValueError("adamw(inplace=True) updates contiguous tensors only")
    return t.view(-1)


def adamw(lr: float | Callable, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
          clip_norm: float = 0.0, master_fp32: bool = False, inplace: bool = False):
    """AdamW with an optional global-norm clip. inplace=True consumes
    `params` and `state` (see the module's docstring)."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        zeros32 = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        state = {"step": _step0(params), "mu": tree_map(zeros32, params),
                 "nu": tree_map(zeros32, params)}
        if master_fp32:
            state["master"] = tree_map(lambda p: p.float(), params)
        return state

    def leaf(g, m, n, base, scale, lr_t, bc1, bc2):
        """One leaf's (or slice's) step: its new fp32 moments and base."""
        g32 = (g if scale is None else _scaled(g, scale)).float()
        m = b1 * m + (1 - b1) * g32
        n = b2 * n + (1 - b2) * torch.square(g32)
        u = (m / bc1) / (torch.sqrt(n / bc2) + eps)
        if weight_decay:
            u = u + weight_decay * base.float()
        return m, n, base.float() - lr_t * u

    def prologue(grads, state):
        with trace.phase("optim.norm", state["step"]):
            gnorm = tree_global_norm(grads)
            scale = _clip_scale(gnorm, clip_norm) if clip_norm else None
            step = state["step"] + 1
            return gnorm, scale, step, _lr(lr_fn, step), 1 - b1 ** step.float(), \
                1 - b2 ** step.float()

    def update(grads, state, params):
        gnorm, scale, step, *k = prologue(grads, state)
        base = state.get("master", params)
        with trace.phase("optim.update", step):
            out = [leaf(g, m, n, b, scale, *k) for g, m, n, b in zip(
                tree_leaves(grads), tree_leaves(state["mu"]), tree_leaves(state["nu"]),
                tree_leaves(base))]
            mu, nu, new_base = (_like(params, [o[c] for o in out]) for c in range(3))
            new_params = tree_map(lambda b, p: b.to(p.dtype), new_base, params)
        new_state = {"step": step, "mu": mu, "nu": nu}
        if master_fp32:
            new_state["master"] = new_base
        return new_params, new_state, {"grad_norm": gnorm, "lr": k[0]}

    def update_inplace(grads, state, params):
        gnorm, scale, step, *k = prologue(grads, state)
        master = state.get("master")
        bases = tree_leaves(master) if master_fp32 else tree_leaves(params)
        with trace.phase("optim.update", step):
            for g, m, n, b, p in zip(tree_leaves(grads), tree_leaves(state["mu"]),
                                     tree_leaves(state["nu"]), bases, tree_leaves(params)):
                g, m, n, b, p = g.reshape(-1), _flat(m), _flat(n), _flat(b), _flat(p)
                for i in range(0, g.numel(), _SLICE_ELEMS):
                    s = slice(i, i + _SLICE_ELEMS)
                    m[s], n[s], new = leaf(g[s], m[s], n[s], b[s], scale, *k)
                    if master_fp32:
                        b[s] = new
                    p[s] = new.to(p.dtype)
        return params, {**state, "step": step}, {"grad_norm": gnorm, "lr": k[0]}

    return Optimizer(init, update_inplace if inplace else update)
