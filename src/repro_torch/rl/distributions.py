"""Categorical policy distribution helpers (counterpart of
`repro.rl.distributions`; logits in fp32)."""
from __future__ import annotations

import torch


def categorical_logp(logits, actions):
    """logits: (..., A) fp32; actions: (...) int -> (...) fp32 log pi(a)."""
    logz = torch.logsumexp(logits, dim=-1)
    la = torch.gather(logits, -1, actions.long()[..., None])[..., 0]
    return la - logz


def categorical_entropy(logits):
    logp = torch.log_softmax(logits, dim=-1)
    return -(logp.exp() * logp).sum(dim=-1)


def categorical_kl(logits_p, logits_q):
    """KL(p || q) — the teacher-KL penalty hook (paper §InfServer)."""
    lp = torch.log_softmax(logits_p, dim=-1)
    lq = torch.log_softmax(logits_q, dim=-1)
    return (lp.exp() * (lp - lq)).sum(dim=-1)


def categorical_sample(gen: torch.Generator, logits, valid_actions: int | None = None):
    """Gumbel-max draw from softmax(logits) with noise from `gen` (on the
    logits' device), as jax.random.categorical; returns int64 indices."""
    if valid_actions is not None:
        mask = torch.arange(logits.shape[-1], device=logits.device) < valid_actions
        logits = logits.masked_fill(~mask, float("-inf"))
    tiny = torch.finfo(logits.dtype).tiny
    u = torch.rand(logits.shape, generator=gen, device=logits.device,
                   dtype=logits.dtype).clamp_(min=tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)
