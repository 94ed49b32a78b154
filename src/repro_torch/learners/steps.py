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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.actors.policy import make_obs_policy
from repro_torch.models import forward_train
from repro_torch.rl.ppo import PPOConfig, ppo_loss
from repro_torch.rl.vtrace_loss import VTraceConfig, vtrace_loss
from repro_torch.utils import tree_leaves, tree_map

_TRAJ_FIELDS = ("actions", "behavior_logp", "behavior_values", "rewards",
                "bootstrap_value")
_INPUT_FIELDS = ("tokens", "patch_embeds", "frame_embeds")   # what the model sees


def _loss_for(kind):
    return {"ppo": (ppo_loss, PPOConfig), "vtrace": (vtrace_loss, VTraceConfig)}[kind]


def _value_and_grad(loss_fn, params):
    """(loss, metrics, grads) of loss_fn(params) -> (loss, metrics)."""
    p = tree_map(lambda t: t.detach().requires_grad_(True), params)
    with torch.enable_grad():
        lv, metrics = loss_fn(p)
        grads = iter(torch.autograd.grad(lv, tree_leaves(p), materialize_grads=True))
    metrics = {k: v.detach() for k, v in metrics.items()}
    return lv.detach(), metrics, tree_map(lambda _: next(grads), p)


def _apply(optimizer, params, opt_state, loss_fn):
    lv, metrics, grads = _value_and_grad(loss_fn, params)
    with torch.no_grad():
        params, opt_state, om = optimizer.update(grads, opt_state, params)
    return params, opt_state, {**metrics, **om, "loss": lv}


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


def build_seq_train_step(cfg, optimizer, hp=None, loss: str = "ppo", remat: bool = True):
    """Sequence-model PPO/V-trace: actions are tokens; logits from the LM
    head over the whole unroll. The model sees every modality input the
    batch carries (`tokens`, `patch_embeds`, `frame_embeds`), as `repro`'s
    step does."""
    loss_fn_impl, hp_cls = _loss_for(loss)
    hp = hp or hp_cls()

    def train_step(params, opt_state, batch):
        tfields = {k: batch[k] for k in _TRAJ_FIELDS + ("discounts",)}
        inputs = {k: batch[k] for k in _INPUT_FIELDS if k in batch}

        def loss_fn(p):
            logits, values, aux = forward_train(p, cfg, inputs, remat=remat)
            # modality prefixes (vlm patches) are observation-only: the RL
            # fields are aligned to the last S_act positions
            S_act = tfields["actions"].shape[1]
            lv, metrics = loss_fn_impl(logits[:, -S_act:], values[:, -S_act:], tfields, hp)
            return lv + aux, metrics

        return _apply(optimizer, params, opt_state, loss_fn)

    return train_step


def build_mlm_train_step(cfg, optimizer, remat: bool = True):
    """HuBERT-style masked-unit prediction (encoder-only audio). The batch
    holds `frame_embeds` (B, T, d), `units` (B, T) ints and `mask` (B, T)
    bool: masked frames are zeroed at the input, and the loss is the NLL of
    their units, averaged over max(sum(mask), 1) frames; `masked_acc` is
    the argmax accuracy over the same frames."""
    if not cfg.encoder_only:
        raise ValueError(f"{cfg.name}: masked-unit prediction takes an encoder-only arch")

    def train_step(params, opt_state, batch):
        frames, units, mask = batch["frame_embeds"], batch["units"], batch["mask"]

        def loss_fn(p):
            x = frames.masked_fill(mask[..., None], 0.0)     # mask out the input frames
            logits, _, _ = forward_train(p, cfg, {"frame_embeds": x, "tokens": None},
                                         remat=remat)
            nll = -F.log_softmax(logits, dim=-1).gather(-1, units[..., None].long())[..., 0]
            m = mask.float()
            n = torch.clamp(m.sum(), min=1.0)
            acc = ((logits.argmax(-1) == units) * m).sum() / n
            return (nll * m).sum() / n, {"masked_acc": acc}

        return _apply(optimizer, params, opt_state, loss_fn)

    return train_step
