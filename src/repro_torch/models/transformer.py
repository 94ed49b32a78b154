"""Transformer assembly, dense family (counterpart of `repro.models.transformer`).

Params keep the reference layout: the layer stack `blocks` is stacked on a
leading repeat axis (one entry per repeat of `cfg.layer_pattern`), and a
Python loop over that axis replaces `lax.scan`.

Model axis: every function here also takes params stacked on a leading
model axis M (leaves (M, ...), blocks (M, R, ...)) together with tokens
(M, B, T); outputs then carry the same leading M. This is the grouped
theta + phi forward of the InfServer, written without `vmap`.

Entry point: forward_train(params, cfg, batch, remat=False) -> (logits,
values, aux), differentiable: every kernel it reaches has a backward.
`prefill`, `decode_step` and the other families come later.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import dtype_of
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.utils import tree_stack


# ===========================================================================
# init
# ===========================================================================

def _init_dense_unit(gen, cfg, dtype):
    """One repeat unit of attention-bearing sublayers."""
    dev = gen.device
    subs = {}
    for j in range(len(cfg.layer_pattern)):
        sub = {
            "attn_norm": L.norm_init(cfg.norm, cfg.d_model, dtype, dev),
            "attn": A.init_attention(gen, cfg, dtype),
            "mlp_norm": L.norm_init(cfg.norm, cfg.d_model, dtype, dev),
            "mlp": L.mlp_init(gen, cfg.d_model, cfg.d_ff, dtype,
                              gated=cfg.mlp_gated),
        }
        if cfg.post_block_norms:
            sub["post_attn_norm"] = L.norm_init(cfg.norm, cfg.d_model, dtype, dev)
            sub["post_mlp_norm"] = L.norm_init(cfg.norm, cfg.d_model, dtype, dev)
        subs[f"sub{j}"] = sub
    return subs


def _n_repeats(cfg):
    n_unit = len(cfg.layer_pattern)
    if cfg.num_layers % n_unit:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers do not split "
                         f"into units of {cfg.layer_pattern}")
    return cfg.num_layers // n_unit


def _check_family(cfg):
    if cfg.family != "dense" or cfg.moe is not None or cfg.ssm is not None:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet (dense only)")


def init_params(gen: torch.Generator, cfg) -> Dict[str, Any]:
    """Random params for `cfg` on `gen.device`, drawn from `gen`. Same keys
    and shapes as `repro.models.init_params`; the numbers differ (the two
    frameworks' generators differ)."""
    _check_family(cfg)
    dtype = dtype_of(cfg.param_dtype)
    dev = gen.device
    p: Dict[str, Any] = {"embed": L.embed_init(gen, cfg.vocab_size, cfg.d_model, dtype)}
    p["blocks"] = tree_stack([_init_dense_unit(gen, cfg, dtype)
                          for _ in range(_n_repeats(cfg))])
    p["final_norm"] = L.norm_init(cfg.norm, cfg.d_model, dtype, dev)
    if not cfg.tie_embeddings:
        p["lm_head"] = L.dense_init(gen, cfg.d_model, cfg.vocab_size, dtype)
    p["value_head"] = {
        "h": L.dense_init(gen, cfg.d_model, cfg.value_head_hidden, dtype, bias=True),
        "out": L.dense_init(gen, cfg.value_head_hidden, 1, dtype, bias=True),
    }
    return p


# ===========================================================================
# sublayer application
# ===========================================================================

def _apply_unit_full(cfg, unit, x, positions):
    """Full-sequence pass of one repeat unit (the dense family has no aux
    loss, so unlike `repro` this returns x alone)."""
    for j, lt in enumerate(cfg.layer_pattern):
        sub = unit[f"sub{j}"]
        h = L.norm_apply(cfg.norm, sub["attn_norm"], x)
        attn_out = A.full_attention(sub["attn"], cfg, h, positions, layer_type=lt)
        if cfg.post_block_norms:
            attn_out = L.norm_apply(cfg.norm, sub["post_attn_norm"], attn_out)
        x = x + attn_out
        h = L.norm_apply(cfg.norm, sub["mlp_norm"], x)
        y = L.mlp(sub["mlp"], h, cfg.activation)
        if cfg.post_block_norms:
            y = L.norm_apply(cfg.norm, sub["post_mlp_norm"], y)
        x = x + y
    return x


# ===========================================================================
# embedding / heads
# ===========================================================================

def embed_inputs(params, cfg, batch):
    """batch: {'tokens': (B, T) or (M, B, T) int}. Returns (x, positions)."""
    tokens = batch["tokens"]
    x = L.embed(params["embed"], tokens, dtype_of(cfg.compute_dtype),
                cfg.embed_scale)
    T = tokens.shape[-1]
    positions = torch.arange(T, dtype=torch.int32,
                             device=tokens.device).expand(tokens.shape)
    return x, positions


def heads(params, cfg, x):
    h = L.norm_apply(cfg.norm, params["final_norm"], x)
    if cfg.tie_embeddings:
        logits = L.dense({"w": params["embed"]["table"].transpose(-1, -2)}, h)
    else:
        logits = L.dense(params["lm_head"], h)
    logits = L.softcap(logits.float(), cfg.final_logit_softcap)
    vh = torch.tanh(L.dense(params["value_head"]["h"], h))
    values = L.dense(params["value_head"]["out"], vh)[..., 0].float()
    return logits, values


# ===========================================================================
# entry points
# ===========================================================================

def forward_train(params, cfg, batch, remat=False):
    """Returns (logits (..., B, T, V) fp32, values (..., B, T) fp32, aux),
    where aux (the MoE load-balance loss in `repro`) is 0 for the dense
    family.

    remat=True checkpoints each repeat unit with
    `torch.utils.checkpoint` (non-reentrant), the counterpart of
    `jax.checkpoint` around `repro`'s scanned unit: the backward keeps one
    unit's activations at a time and runs the unit's forward again.
    `repro`'s `q_chunk` and `unroll` have no counterpart: the attention
    kernels tile the sequence themselves, and the loop over repeats is
    plain Python."""
    _check_family(cfg)
    grouped = batch["tokens"].dim() == 3
    x, positions = embed_inputs(params, cfg, batch)
    for r in range(_n_repeats(cfg)):
        unit = _index(params["blocks"], r, grouped)
        if remat:
            x = checkpoint(lambda x, unit=unit: _apply_unit_full(cfg, unit, x, positions),
                           x, use_reentrant=False)
        else:
            x = _apply_unit_full(cfg, unit, x, positions)
    logits, values = heads(params, cfg, x)
    return logits, values, torch.zeros((), device=logits.device)


def _index(tree, r, grouped):
    """Repeat r of a stacked unit: leaf[r], or leaf[:, r] under a model axis."""
    if isinstance(tree, dict):
        return {k: _index(v, r, grouped) for k, v in tree.items()}
    return tree[:, r] if grouped else tree[r]
