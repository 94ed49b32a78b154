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
does not fit one card.

AdamW's two passes over the leaves, the global norm (with the clip scale)
and the update, run through `kernels/adamw`'s wrappers, which own the
device decision (`kernels/dispatch.py`'s rule, counted in
`dispatch.stats()` as `global_norm|<tier>` and `adamw|<tier>`):
  - CUDA tensors run the hand-written kernels: one launch a leaf for the
    norm and its finish, one a leaf for the update, over whole leaves with
    no temporaries; a leaf they cannot take raises;
  - meta tensors inside `dispatch.abstract()` check and count the kernels'
    work and launch nothing;
  - CPU tensors run the plain body (`kernels/adamw/ref.py`) in flat slices
    of 2^24 elements (a leaf's first axis may be the layer stack, of
    length 1), so its own memory is a few slices of temporaries.
DTensor leaves (the sharded steps) take the same path on their local
shards, in the placements of the params that `sharding.reduce_grads`
gives their grads: the update is elementwise, and the norm sums each
shard's squares over the mesh dims its leaf is split on.
On each device the in-place update gives the functional update's numbers
bit for bit: both run one per-leaf body, with its outputs set to its
inputs or to fresh tensors.
Traced (`utils/trace.py`), adamw's update is the phases `optim.norm` (the
global norm, the clip scale, the lr and the bias corrections) and
`optim.update` (the loop over the leaves, and the functional update's
allocations).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.distributed.sharding import is_dtensor, shard_groups
from repro_torch.kernels import dispatch
from repro_torch.kernels.adamw import ops as K
from repro_torch.kernels.adamw.ref import clip_scale_ref, scaled_ref
from repro_torch.utils import trace, tree_global_norm, tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple]   # (grads, state, params) -> (new_params, state, metrics)


def clip_by_global_norm(grads, max_norm):
    norm = tree_global_norm(grads)
    scale = clip_scale_ref(norm, max_norm)
    return tree_map(lambda g: scaled_ref(g, scale), grads), norm


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


def _local(t):
    """A DTensor's local shard, or `t`."""
    return t.to_local() if is_dtensor(t) else t


def _laid_out_as(t, like):
    """The local shard `t` as a DTensor laid out as `like`, or `t`."""
    if t is None or not is_dtensor(like):
        return t
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(t, like.device_mesh, like.placements, run_check=False,
                              shape=like.shape, stride=like.stride())


def adamw(lr: float | Callable, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
          clip_norm: float = 0.0, master_fp32: bool = False, inplace: bool = False):
    """AdamW with an optional global-norm clip. inplace=True consumes
    `params` and `state` (see the module's docstring)."""
    lr_fn = lr if callable(lr) else (lambda _: lr)
    hyper = dict(b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)

    def init(params):
        zeros32 = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        state = {"step": _step0(params), "mu": tree_map(zeros32, params),
                 "nu": tree_map(zeros32, params)}
        if master_fp32:
            state["master"] = tree_map(lambda p: p.float(), params)
        return state

    def prologue(grads, state):
        """The norm, the clip scale, the new step and the scalars the
        update reads (lr and the bias corrections), this rank's."""
        leaves = tree_leaves(grads)
        local = [_local(g) for g in leaves]
        tier = dispatch.resolve(local[0])
        with trace.phase("optim.norm", state["step"]):
            dispatch.note("global_norm", tier)
            gnorm, scale = K.global_norm(local, clip_norm,
                                         groups=[shard_groups(g) for g in leaves])
            step = state["step"] + 1
            t = _local(step)
            return tier, gnorm, step, dict(scale=scale, lr=_lr(lr_fn, t),
                                           bc1=1 - b1 ** t.float(), bc2=1 - b2 ** t.float())

    def leaves_of(grads, state, params):
        """(grad, mu, nu, base, param) per leaf; the base is the master or
        the param."""
        base = state["master"] if master_fp32 else params
        return zip(*(tree_leaves(t) for t in (grads, state["mu"], state["nu"], base, params)))

    def update(grads, state, params):
        tier, gnorm, step, k = prologue(grads, state)
        with trace.phase("optim.update", step):
            dispatch.note("adamw", tier)
            out = []
            for g, m, n, b, p in leaves_of(grads, state, params):
                fresh = (torch.empty_like(_local(m)), torch.empty_like(_local(n)),
                         torch.empty_like(_local(b)) if master_fp32 else None,
                         torch.empty_like(_local(p)))
                K.adamw_update(_local(g), _local(m), _local(n), _local(b), fresh, **k, **hyper)
                out.append([_laid_out_as(t, like) for t, like in zip(fresh, (m, n, b, p))])
            mu, nu, new_base, new_params = (_like(params, [o[c] for o in out]) for c in range(4))
        new_state = {"step": step, "mu": mu, "nu": nu}
        if master_fp32:
            new_state["master"] = new_base
        return new_params, new_state, {"grad_norm": gnorm, "lr": k["lr"]}

    def update_inplace(grads, state, params):
        tier, gnorm, step, k = prologue(grads, state)
        with trace.phase("optim.update", step):
            dispatch.note("adamw", tier)
            for g, m, n, b, p in leaves_of(grads, state, params):
                m, n, b, p = (_local(t) for t in (m, n, b, p))
                K.adamw_update(_local(g), m, n, b, (m, n, b if master_fp32 else None, p),
                               **k, **hyper)
        return params, {**state, "step": step}, {"grad_norm": gnorm, "lr": k["lr"]}

    return Optimizer(init, update_inplace if inplace else update)
