"""Train-step factories, the Learner's compute (§3.2); counterpart of
`repro.learners.steps`.

  env_train_step - PPO/V-trace over env trajectory segments with the
                   memoryless obs-token policy (the real league training).
  seq_train_step - PPO/V-trace over full token sequences (AlphaStar-style
                   autoregressive action head), the big-arch learner step.
  mlm_train_step - HuBERT-style masked-unit prediction, the encoder-only
                   (audio) arch's step.

Each returns train_step(params, opt_state, batch) -> (params, opt_state,
metrics), with `repro`'s metric keys. The step takes the gradient of a
fresh leaf copy of `params` (`torch.autograd.grad`; a leaf the loss does
not reach gets zeros, as under `jax.grad`) and returns the optimizer's
new tensors; its arguments are left as they were unless the optimizer
updates in place (`adamw(..., inplace=True)`, which consumes `params` and
`opt_state` as a donating JAX caller would). `repro`'s `jit`,
`donate_batch`, `unroll` and `q_chunk` have no counterpart: the port runs
eagerly, loops over repeats in Python, and its attention kernels tile the
sequence themselves.

`mesh=` (a DeviceMesh, `launch/steps.make_dryrun_step`) makes the seq and
MLM steps sharded: params and optimizer state are DTensors laid out by
`distributed/sharding.py`'s specs and the batch is a DTensor sharded over
the data axes. Each rank keeps its param shards and runs the step's code
on its rows inside a data-parallel and a param scope: each repeat unit
gathers its weights at use under checkpoint (FSDP: one unit gathered at
a time, gathered again for its backward), the 'model' axis splits the
heads, the MLP's hidden dim, the vocab and, with the expert-parallel
toggle, the experts (tensor and expert parallelism), and the loss is the
global batch's on every rank. The backward is seeded with 1 / world, the
grads come back as DTensors in the params' layouts, and the optimizer
updates the DTensors. A sharded step needs `remat=True`: that is what
frees a unit's gathered weights between its forward and its backward.
`train_step.value_and_grad(params, batch)` gives (loss, metrics, grads)
without the update.

Traced (`utils/trace.py`), a step is the phases `learner.forward` (the
loss), `learner.backward` (the gradient, the remat recompute included,
through the grads' reduction over a mesh), then the optimizer's.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch.actors.policy import make_obs_policy
from repro_torch.distributed import sharding as SH
from repro_torch.kernels import cost
from repro_torch.models import forward_train
from repro_torch.models import moe as MOE
from repro_torch.rl.ppo import PPOConfig, ppo_loss
from repro_torch.rl.vtrace_loss import VTraceConfig, vtrace_loss
from repro_torch.utils import trace, tree_leaves, tree_map

_TRAJ_FIELDS = ("actions", "behavior_logp", "behavior_values", "rewards",
                "bootstrap_value")
_INPUT_FIELDS = ("tokens", "patch_embeds", "frame_embeds")   # what the model sees


def _loss_for(kind):
    return {"ppo": (ppo_loss, PPOConfig), "vtrace": (vtrace_loss, VTraceConfig)}[kind]


def _value_and_grad(loss_fn, params, mesh=None, cfg=None):
    """(loss, metrics, grads) of loss_fn(params) -> (loss, metrics). With a
    mesh, params are DTensors: loss_fn sees this rank's shards inside a
    param scope, the backward is seeded with 1 / world, and the grads are
    DTensors in the params' layouts (see the module's docstring)."""
    local, scope = params, contextlib.nullcontext()
    if mesh is not None:
        local, specs = SH.local_params(params, mesh)
        scope = SH.param_scope(mesh, specs, cfg, ep=MOE.expert_parallel())
    p = tree_map(lambda t: t.detach().requires_grad_(True), local)
    leaves = tree_leaves(p)
    with contextlib.ExitStack() as backward:
        with torch.enable_grad(), scope:
            with trace.phase("learner.forward", leaves[0]):
                lv, metrics = loss_fn(p)
            backward.enter_context(trace.phase("learner.backward", leaves[0]))
            seed = lv if mesh is None else lv / mesh.size()
            grads = iter(torch.autograd.grad(seed, leaves, materialize_grads=True))
        grads = tree_map(lambda _: next(grads), p)
        if mesh is not None:
            grads = SH.reduce_grads(grads, params, mesh)
    return lv.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def _apply(optimizer, params, opt_state, loss_fn, mesh=None, cfg=None):
    lv, metrics, grads = _value_and_grad(loss_fn, params, mesh, cfg)
    cost.phase("update")
    with torch.no_grad():
        params, opt_state, om = optimizer.update(grads, opt_state, params)
    return params, opt_state, {**metrics, **om, "loss": lv}


def _sharded(make_loss, optimizer, mesh, cfg, remat):
    """train_step(params, opt_state, batch) from make_loss(batch) ->
    loss_fn, on `mesh` (None: single device), with its `value_and_grad`."""
    if mesh is not None and not remat:
        raise ValueError("a sharded step gathers each unit's weights again for its "
                         "backward: it needs remat=True")

    def scoped(batch):
        if mesh is None:
            return batch, SH.data_parallel(None, ())
        axes = SH.batch_axes(SH.batch_shardings(batch, mesh))
        return ({k: SH.local_rows(v) for k, v in batch.items()},
                SH.data_parallel(mesh, axes))

    def train_step(params, opt_state, batch):
        batch, scope = scoped(batch)
        with scope:
            return _apply(optimizer, params, opt_state, make_loss(batch), mesh, cfg)

    def value_and_grad(params, batch):
        batch, scope = scoped(batch)
        with scope:
            return _value_and_grad(make_loss(batch), params, mesh, cfg)

    train_step.value_and_grad = value_and_grad
    return train_step


def build_env_train_step(cfg, num_actions: int, optimizer, hp=None, loss: str = "ppo"):
    loss_fn_impl, hp_cls = _loss_for(loss)
    hp = hp or hp_cls()
    policy = make_obs_policy(cfg, num_actions)

    def train_step(params, opt_state, traj):
        B, T, L0 = traj["obs"].shape
        tfields = {k: traj[k] for k in _TRAJ_FIELDS}
        tfields["discounts"] = hp.gamma * (1.0 - traj["done"].float())

        def loss_fn(p):
            lg, v = policy.logits_values(p, traj["obs"].reshape(B * T, L0))
            return loss_fn_impl(lg.reshape(B, T, num_actions), v.reshape(B, T),
                                tfields, hp)

        return _apply(optimizer, params, opt_state, loss_fn)

    return train_step


def build_seq_train_step(cfg, optimizer, hp=None, loss: str = "ppo", remat: bool = True,
                         mesh=None):
    """Sequence-model PPO/V-trace: actions are tokens; logits from the LM
    head over the whole unroll. The model sees every modality input the
    batch carries (`tokens`, `patch_embeds`, `frame_embeds`), as `repro`'s
    step does. `mesh`: the sharded step (module docstring)."""
    loss_fn_impl, hp_cls = _loss_for(loss)
    hp = hp or hp_cls()

    def make_loss(batch):
        tfields = {k: batch[k] for k in _TRAJ_FIELDS + ("discounts",)}
        inputs = {k: batch[k] for k in _INPUT_FIELDS if k in batch}

        def loss_fn(p):
            logits, values, aux = forward_train(p, cfg, inputs, remat=remat)
            # modality prefixes (vlm patches) are observation-only: the RL
            # fields are aligned to the last S_act positions
            S_act = tfields["actions"].shape[1]
            lv, metrics = loss_fn_impl(logits[:, -S_act:], values[:, -S_act:], tfields, hp)
            return lv + aux, metrics
        return loss_fn

    return _sharded(make_loss, optimizer, mesh, cfg, remat)


def build_mlm_train_step(cfg, optimizer, remat: bool = True, mesh=None):
    """HuBERT-style masked-unit prediction (encoder-only audio). The batch
    holds `frame_embeds` (B, T, d), `units` (B, T) ints and `mask` (B, T)
    bool: masked frames are zeroed at the input, and the loss is the NLL of
    their units, averaged over max(sum(mask), 1) frames; `masked_acc` is
    the argmax accuracy over the same frames."""
    if not cfg.encoder_only:
        raise ValueError(f"{cfg.name}: masked-unit prediction takes an encoder-only arch")

    def make_loss(batch):
        frames, units, mask = batch["frame_embeds"], batch["units"], batch["mask"]

        def loss_fn(p):
            x = frames.masked_fill(mask[..., None], 0.0)     # mask out the input frames
            logits, _, _ = forward_train(p, cfg, {"frame_embeds": x, "tokens": None},
                                         remat=remat)
            nll = -F.log_softmax(logits, dim=-1).gather(-1, units[..., None].long())[..., 0]
            m = mask.float()
            n = torch.clamp(SH.batch_sum(m.sum()), min=1.0)
            acc = SH.batch_sum(((logits.argmax(-1) == units) * m).sum()) / n
            return SH.batch_sum((nll * m).sum()) / n, {"masked_acc": acc}
        return loss_fn

    return _sharded(make_loss, optimizer, mesh, cfg, remat)
