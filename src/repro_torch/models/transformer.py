"""Transformer assembly, dense family (counterpart of `repro.models.transformer`).

Params keep the reference layout: the layer stack `blocks` is stacked on a
leading repeat axis (one entry per repeat of `cfg.layer_pattern`), and a
Python loop over that axis replaces `lax.scan`.

Model axis: every function here also takes params stacked on a leading
model axis M (leaves (M, ...), blocks (M, R, ...)) together with tokens
(M, B, T); outputs then carry the same leading M. This is the grouped
theta + phi forward of the InfServer, written without `vmap`.

Entry points (the learner / InfServer steps of the TLeague mapping):
  forward_train(params, cfg, batch, remat=False) -> (logits, values, aux),
      differentiable: every kernel it reaches has a backward;
  prefill(params, cfg, batch)               -> (logits, values, state);
  decode_step(params, cfg, tokens, state)   -> (logits, values, state);
  init_decode_state(cfg, batch, seq_len)    -> state.
The decode state keeps `repro`'s layout: `blocks` holds one cache dict per
sublayer (`kv{j}`: k, v, pos, length), each leaf stacked on the leading
repeat axis, and `length` (B,) is the next absolute position. Decode has
no model axis (`repro`'s has none). The other families (MoE, SSM, hybrid,
vlm, audio) come later: their configs raise in `init_params`.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import dtype_of
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.utils import resolve_device, tree_map, tree_stack


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

def _apply_unit(cfg, unit, x, attend):
    """One repeat unit: per sublayer, norm -> `attend(j, layer_type,
    attn_params, h)` -> (post norm) residual -> norm -> MLP -> (post norm)
    residual. The dense family has no aux loss, so unlike `repro` this
    returns x alone."""
    for j, lt in enumerate(cfg.layer_pattern):
        sub = unit[f"sub{j}"]
        h = L.norm_apply(cfg.norm, sub["attn_norm"], x)
        attn_out = attend(j, lt, sub["attn"], h)
        if cfg.post_block_norms:
            attn_out = L.norm_apply(cfg.norm, sub["post_attn_norm"], attn_out)
        x = x + attn_out
        h = L.norm_apply(cfg.norm, sub["mlp_norm"], x)
        y = L.mlp(sub["mlp"], h, cfg.activation)
        if cfg.post_block_norms:
            y = L.norm_apply(cfg.norm, sub["post_mlp_norm"], y)
        x = x + y
    return x


def _apply_unit_full(cfg, unit, x, positions):
    """Full-sequence (train) pass of one repeat unit."""
    return _apply_unit(cfg, unit, x, lambda j, lt, p, h: A.full_attention(
        p, cfg, h, positions, layer_type=lt))


def _apply_unit_step(cfg, unit, x, cache, window_override=0, uniform=False):
    """Single-token decode pass of one repeat unit over its caches
    (`kv{j}` per sublayer), which `decode_attention` writes in place."""
    def attend(j, lt, p, h):
        y, _ = A.decode_attention(p, cfg, h, cache[f"kv{j}"], layer_type=lt,
                                  window_override=window_override, uniform=uniform)
        return y
    return _apply_unit(cfg, unit, x, attend)


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


# ===========================================================================
# decode: prefill, the ring-buffer state, one-token steps
# ===========================================================================

def _check_decoder(cfg):
    _check_family(cfg)
    if cfg.encoder_only:
        raise ValueError(f"{cfg.name} is encoder-only: no decode step")


def _init_unit_cache(cfg, batch, cache_len, dtype, prefilled=0, device=None):
    return {f"kv{j}": A.init_kv_cache(cfg, batch, cache_len, dtype, prefilled, device)
            for j in range(len(cfg.layer_pattern))}


def _stacked_cache(cfg, batch, cache_len, dtype, prefilled, device):
    """Every repeat unit's cache, each leaf stacked on a leading repeat
    axis (the layout `jax.vmap` gives `repro`'s)."""
    one = _init_unit_cache(cfg, batch, cache_len, dtype, prefilled, device)
    reps = _n_repeats(cfg)
    return tree_map(lambda a: a.expand(reps, *a.shape).contiguous(), one)


def init_decode_state(cfg, batch, seq_len, *, sliding=False, prefilled=None,
                      device=None):
    """State for `decode_step`, as if `seq_len` positions had been
    decoded. sliding=True uses the O(window) ring buffer of
    `cfg.long_context_window` slots (the sub-quadratic long_500k variant).
    `prefilled` (default: all) marks how many slots hold valid keys.
    `device` defaults to CUDA and raises where there is none."""
    _check_decoder(cfg)
    cache_len = min(seq_len, cfg.long_context_window) if sliding else seq_len
    pref = min(seq_len if prefilled is None else prefilled, cache_len)
    dev = resolve_device(device)
    state = {"blocks": _stacked_cache(cfg, batch, cache_len, dtype_of(cfg.compute_dtype),
                                      pref, dev)}
    # ring-buffer semantics: `length` is the absolute next position even when
    # the cache only holds the last `cache_len` entries.
    state["length"] = torch.full((batch,), seq_len, dtype=torch.int32, device=dev)
    return state


def decode_step(params, cfg, tokens, state, *, window=0, uniform=False):
    """One token per row. tokens: (B, 1) ints. `window` > 0 masks keys
    more than `window` positions back in every layer: pair it with a
    ring-buffer cache of that size for the sub-quadratic long_500k variant.
    `uniform=True` says every row is at the same position (one write slot
    for all rows). Returns (logits (B, 1, V) fp32, values (B, 1) fp32,
    state).

    The state passed in is consumed: each layer's new k, v and position go
    into its cache tensors in place (O(B * KV * hd) bytes a layer, not a
    copy of the stacked cache), and the returned state holds the same
    tensors with `length` advanced. Keep no other reference to it."""
    _check_decoder(cfg)
    if isinstance(tokens, dict):
        if "patch_embeds" in tokens:
            raise NotImplementedError(
                f"{cfg.name}: patch_embeds decode comes with the vlm family")
        tokens = tokens["tokens"]
    x = L.embed(params["embed"], tokens, dtype_of(cfg.compute_dtype), cfg.embed_scale)
    length = state["length"]
    for r in range(_n_repeats(cfg)):
        # every unit's caches decode at the state's length (`repro`'s
        # per-unit override)
        cache = {key: {**_index(c, r, False), "length": length}
                 for key, c in state["blocks"].items()}
        x = _apply_unit_step(cfg, _index(params["blocks"], r, False), x, cache,
                             window_override=window, uniform=uniform)
    new_length = length + 1
    for c in state["blocks"].values():
        c["length"].copy_(new_length.expand_as(c["length"]))
    logits, values = heads(params, cfg, x)
    return logits, values, {**state, "length": new_length}


def prefill(params, cfg, batch, *, sliding=False, reserve=64):
    """Full forward over the prompt, and the decode state built from its
    keys and values. Returns (logits (B, T, V) fp32, values (B, T), state).

    The cache holds `T + reserve` slots (`reserve` keeps the next
    decode_steps from ring-overwriting prompt keys, slot t % cache_len), or
    with sliding=True `min(T, cfg.long_context_window)`. The write starts at
    max(T - cache_len, 0): the whole prompt, or with sliding the last
    cache_len positions.

    This differs from `repro` (`models/transformer.py:386`), which writes
    positions `slice(T - cache_len, T)` in both cases. Without sliding that
    is `slice(-reserve, T)`: a prompt longer than `reserve` keeps only its
    last `reserve` keys, and every earlier slot stays at pos -1, masked out
    of decode. The port keeps every prompt key, so its decode matches its
    `forward_train` at any T."""
    _check_decoder(cfg)
    x, positions = embed_inputs(params, cfg, batch)
    B, T = x.shape[0], x.shape[1]
    cache_len = min(T, cfg.long_context_window) if sliding else T + reserve
    start = max(T - cache_len, 0)
    slots = torch.arange(start, T, device=x.device) % cache_len
    blocks = _stacked_cache(cfg, B, cache_len, dtype_of(cfg.compute_dtype), 0, x.device)
    for r in range(_n_repeats(cfg)):
        def attend(j, lt, p, h, r=r):
            y, k, v = A.full_attention(p, cfg, h, positions, layer_type=lt, return_kv=True)
            kc = _index(blocks[f"kv{j}"], r, False)
            kc["k"][:, slots] = k[:, start:]
            kc["v"][:, slots] = v[:, start:]
            kc["pos"][:, slots] = positions[:, start:]
            return y
        x = _apply_unit(cfg, _index(params["blocks"], r, False), x, attend)
    for c in blocks.values():
        c["length"].fill_(T)
    logits, values = heads(params, cfg, x)
    state = {"blocks": blocks,
             "length": torch.full((B,), T, dtype=torch.int32, device=x.device)}
    return logits, values, state
