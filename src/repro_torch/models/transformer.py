"""Transformer assembly for the assigned arch families (counterpart of
`repro.models.transformer`): dense, moe, ssm (rwkv6), hybrid (attention
and Mamba heads in parallel), vlm (a dense decoder over a prefix of patch
embeddings) and audio (hubert: an encoder-only stack over frame
embeddings, attending bidirectionally; it has no decode step).

Params keep the reference layout: the layer stack `blocks` is stacked on a
leading repeat axis (one entry per repeat of `cfg.layer_pattern`), and
kimi-k2's leading dense layers (of width `d_ff`, the shared experts' being
`cfg.shared_ff`) are a second stack, `dense_prefix`, run first. A Python loop over each stack replaces `lax.scan`.

Model axis (dense family only): every function here also takes params
stacked on a leading model axis M (leaves (M, ...), blocks (M, R, ...))
together with tokens (M, B, T); outputs then carry the same leading M.
This is the grouped theta + phi forward of the InfServer, written without
`vmap`.

Entry points (the learner / InfServer steps of the TLeague mapping):
  forward_train(params, cfg, batch, remat=False) -> (logits, values, aux),
      differentiable: every kernel it reaches has a backward;
  prefill(params, cfg, batch)               -> (logits, values, state);
  decode_step(params, cfg, tokens, state)   -> (logits, values, state);
  init_decode_state(cfg, batch, seq_len)    -> state.
`batch` holds `tokens` (B, T) and/or the modality embeddings
`patch_embeds` (B, P, d) and `frame_embeds` (B, F, d), which go first in
that order. The decode state keeps `repro`'s layout: `blocks` (and
`dense_prefix`) hold one cache dict per sublayer (`kv{j}`: k, v, pos,
length; hybrid `conv{j}`, `ssm{j}`; rwkv `tm_prev`, `tm_S`, `cm_prev`),
each leaf stacked on the leading repeat axis, and `length` (B,) is the
next absolute position. Decode has no model axis (`repro`'s has none).

Under a mesh scope (`launch/steps.py`'s sharded prefill and decode) the
'model' axis splits the compute as in training, and each rank's states
hold what `repro`'s `state_shardings` gives it: its KV heads, or its block
of the cache slots (`models/attention.py`), RWKV6's `tm_S` its heads and
the Mamba heads' `conv` and `ssm` its channels (`models/ssm.py`).
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import dtype_of
from repro_torch.distributed import sharding as SH
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.utils import resolve_device, trace, tree_map

PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
GROUPS = ("dense_prefix", "blocks")        # the order the stacks run in


# ===========================================================================
# init
# ===========================================================================

def _init_dense_unit(gen, cfg, dtype, with_moe: bool):
    """One repeat unit of attention-bearing sublayers."""
    dev = gen.device
    subs = {}
    for j in range(len(cfg.layer_pattern)):
        sub = {
            "attn_norm": L.norm_init(cfg.norm, cfg.d_model, dtype, dev),
            "attn": A.init_attention(gen, cfg, dtype),
            "mlp_norm": L.norm_init(cfg.norm, cfg.d_model, dtype, dev),
        }
        if cfg.family == "hybrid":
            sub["mamba"] = S.init_mamba(gen, cfg, dtype)
            sub["attn_out_norm"] = L.norm_init(cfg.norm, cfg.d_model, dtype, dev)
            sub["ssm_out_norm"] = L.norm_init(cfg.norm, cfg.d_model, dtype, dev)
            sub["fuse_beta"] = torch.ones((2,), dtype=dtype, device=dev)
        if with_moe:
            sub["moe"] = M.init_moe(gen, cfg, dtype)
        else:
            sub["mlp"] = L.mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, gated=cfg.mlp_gated)
        if cfg.post_block_norms:
            sub["post_attn_norm"] = L.norm_init(cfg.norm, cfg.d_model, dtype, dev)
            sub["post_mlp_norm"] = L.norm_init(cfg.norm, cfg.d_model, dtype, dev)
        subs[f"sub{j}"] = sub
    return subs


def _init_rwkv_unit(gen, cfg, dtype):
    dev = gen.device
    return {"sub0": {
        "tm_norm": L.layernorm_init(cfg.d_model, dtype, dev),
        "time_mix": S.init_rwkv_time_mix(gen, cfg, dtype),
        "cm_norm": L.layernorm_init(cfg.d_model, dtype, dev),
        "channel_mix": S.init_rwkv_channel_mix(gen, cfg, dtype),
    }}


def _n_repeats(cfg):
    n_unit = len(cfg.layer_pattern)
    n = cfg.num_layers - (cfg.moe.first_k_dense if cfg.moe else 0)
    if n % n_unit:
        raise ValueError(f"{cfg.name}: {n} layers do not split "
                         f"into units of {cfg.layer_pattern}")
    return n // n_unit


def _check_family(cfg):
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} is not ported")


def _stack_units(make, n):
    """n units from `make()`, each leaf stacked on a leading repeat axis.
    The stack is filled one unit at a time, so peak memory is the stack
    plus one unit; a stack of one is a view of its unit."""
    unit = make()
    if n == 1:
        return tree_map(lambda a: a.unsqueeze(0), unit)
    out = tree_map(lambda a: a.new_empty((n, *a.shape)), unit)
    for r in range(n):
        tree_map(lambda o, a: o[r].copy_(a), out, unit)
        unit = None                            # freed before the next unit is drawn
        if r + 1 < n:
            unit = make()
    return out


def init_params(gen: torch.Generator, cfg) -> Dict[str, Any]:
    """Random params for `cfg` on `gen.device`, drawn from `gen`. Same keys,
    shapes and dtypes as `repro.models.init_params`; the numbers differ (the
    two frameworks' generators differ)."""
    _check_family(cfg)
    dtype = dtype_of(cfg.param_dtype)
    dev = gen.device
    p: Dict[str, Any] = {"embed": L.embed_init(gen, cfg.vocab_size, cfg.d_model, dtype)}
    if cfg.family == "ssm":
        unit = lambda: _init_rwkv_unit(gen, cfg, dtype)
    else:
        unit = lambda: _init_dense_unit(gen, cfg, dtype, with_moe=cfg.moe is not None)
    p["blocks"] = _stack_units(unit, _n_repeats(cfg))
    if cfg.moe and cfg.moe.first_k_dense:
        p["dense_prefix"] = _stack_units(lambda: _init_dense_unit(gen, cfg, dtype, False),
                                         cfg.moe.first_k_dense)
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

def _apply_unit(cfg, unit, x, attend, io=None):
    """One repeat unit, for every pass. Returns (x, aux), aux the unit's
    MoE load-balance loss: a tensor, or the Python 0.0 without MoE, so the
    dense family issues no op for it.

    Attention sublayers: norm -> `attend(j, layer_type, attn_params, h)`,
    in parallel with the Mamba heads for the hybrid family (each output
    normed, mixed by `fuse_beta`) -> (post norm) residual -> norm -> MLP or
    MoE -> (post norm) residual. The ssm family's unit is RWKV6's time mix
    and channel mix, each after a LayerNorm.

    `io` carries the recurrent states: None (a training pass: they start
    at zero and are dropped), or a dict the pass reads them from (a decode
    step: `tm_prev`, `tm_S`, `cm_prev` or `conv{j}`, `ssm{j}`; a missing
    key starts at zero, a Mamba state from the full-sequence conv) and
    writes the new ones to."""
    aux = 0.0
    if cfg.family == "ssm":
        sub = unit["sub0"]
        if io is None or "tm_S" not in io:       # train or prefill: from zero
            zprev, S0 = S.init_rwkv_state(cfg, x.shape[0], x.dtype, x.device)
            prev = {"tm_prev": zprev, "tm_S": S0, "cm_prev": zprev}
        else:
            prev = io
        h = L.layernorm(sub["tm_norm"], x)
        y, (x_tm, S2) = S.rwkv_time_mix(sub["time_mix"], cfg, h, prev["tm_prev"], prev["tm_S"])
        x = x + y
        h = L.layernorm(sub["cm_norm"], x)
        y, x_cm = S.rwkv_channel_mix(sub["channel_mix"], cfg, h, prev["cm_prev"])
        if io is not None:
            io.update(tm_prev=x_tm, tm_S=S2, cm_prev=x_cm)
        return x + y, aux

    for j, lt in enumerate(cfg.layer_pattern):
        sub = unit[f"sub{j}"]
        h = L.norm_apply(cfg.norm, sub["attn_norm"], x)
        attn_out = attend(j, lt, sub["attn"], h)
        if cfg.family == "hybrid":
            state = ((io[f"conv{j}"], io[f"ssm{j}"])
                     if io is not None and f"conv{j}" in io else None)
            ssm_out, st = S.mamba_apply(sub["mamba"], cfg, h, state=state)
            if io is not None:
                io[f"conv{j}"], io[f"ssm{j}"] = st
            beta = sub["fuse_beta"].to(x.dtype)
            attn_out = 0.5 * (
                beta[0] * L.norm_apply(cfg.norm, sub["attn_out_norm"], attn_out)
                + beta[1] * L.norm_apply(cfg.norm, sub["ssm_out_norm"], ssm_out))
        if cfg.post_block_norms:
            attn_out = L.norm_apply(cfg.norm, sub["post_attn_norm"], attn_out)
        x = x + attn_out
        h = L.norm_apply(cfg.norm, sub["mlp_norm"], x)
        if "moe" in sub:
            y, a = M.moe_apply(sub["moe"], cfg, h)
            aux = aux + a
        else:
            y = L.mlp(sub["mlp"], h, cfg.activation)
            if sub["mlp"]["up"]["w"].shape[-1] != cfg.d_ff:   # a slice of the hidden dim
                y = SH.model_sum(y)
        if cfg.post_block_norms:
            y = L.norm_apply(cfg.norm, sub["post_mlp_norm"], y)
        x = x + y
    return x, aux


def _apply_unit_full(cfg, unit, x, positions):
    """Full-sequence (train) pass of one repeat unit. Returns (x, aux)."""
    return _apply_unit(cfg, unit, x, lambda j, lt, p, h: A.full_attention(
        p, cfg, h, positions, layer_type=lt))


def _apply_unit_step(cfg, unit, x, io, window_override=0, uniform=False):
    """Single-token decode pass of one repeat unit over its caches: `kv{j}`
    per sublayer, which `decode_attention` writes in place, and the
    recurrent states, whose new values `_apply_unit` puts into `io`."""
    def attend(j, lt, p, h):
        y, _ = A.decode_attention(p, cfg, h, io[f"kv{j}"], layer_type=lt,
                                  window_override=window_override, uniform=uniform)
        return y
    return _apply_unit(cfg, unit, x, attend, io)


# ===========================================================================
# embedding / heads
# ===========================================================================

def embed_tokens(params, cfg, tokens, cdt):
    """The token embeddings. Under a mesh scope whose rank holds V/M rows
    of the table (vocab parallelism), each model rank looks up the tokens
    in its rows, zeros the rest, and the sum over 'model' is the lookup."""
    p = SH.materialize(params["embed"], ("embed",))
    rows = p["table"].shape[-2]
    if rows == cfg.vocab_size:
        return L.embed(p, tokens, cdt, cfg.embed_scale)
    t = tokens - SH.model_index() * rows
    inside = ((t >= 0) & (t < rows))[..., None].to(cdt)
    return SH.model_sum(L.embed(p, t.clamp(0, rows - 1), cdt, cfg.embed_scale) * inside)


def embed_inputs(params, cfg, batch):
    """batch: {'tokens': (B, T) or (M, B, T) int, or None} and/or the stub
    frontends' embeddings {'patch_embeds': (B, P, d)} (vlm) and
    {'frame_embeds': (B, F, d)} (audio), concatenated patches, frames,
    tokens, as `repro` does. Returns (x, positions), positions 0..P+F+T-1
    per row."""
    cdt = dtype_of(cfg.compute_dtype)
    parts = [batch[k].to(cdt) for k in ("patch_embeds", "frame_embeds") if k in batch]
    if batch.get("tokens") is not None:
        parts.append(embed_tokens(params, cfg, batch["tokens"], cdt))
    x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-2)
    positions = torch.arange(x.shape[-2], dtype=torch.int32,
                             device=x.device).expand(x.shape[:-1])
    return x, positions


def heads(params, cfg, x):
    """(logits fp32, values fp32). Under a mesh scope with vocab
    parallelism each model rank computes its V/M columns of the logits,
    gathered over 'model'."""
    used = ("final_norm", "value_head", "embed" if cfg.tie_embeddings else "lm_head")
    p = SH.materialize({k: params[k] for k in used})
    h = L.norm_apply(cfg.norm, p["final_norm"], x)
    if cfg.tie_embeddings:
        logits = L.dense({"w": p["embed"]["table"].transpose(-1, -2)}, h)
    else:
        logits = L.dense(p["lm_head"], h)
    if logits.shape[-1] != cfg.vocab_size:
        logits = SH.model_gather(logits, -1)
    logits = L.softcap(logits.float(), cfg.final_logit_softcap)
    vh = torch.tanh(L.dense(p["value_head"]["h"], h))
    values = L.dense(p["value_head"]["out"], vh)[..., 0].float()
    return logits, values


# ===========================================================================
# entry points
# ===========================================================================

def _index(tree, r, grouped):
    """Repeat r of a stacked unit: leaf[r], or leaf[:, r] under a model axis."""
    if isinstance(tree, dict):
        return {k: _index(v, r, grouped) for k, v in tree.items()}
    return tree[:, r] if grouped else tree[r]


def _unbind(tree, grouped):
    """Every repeat unit of a stacked tree (`_index` of each r), as views
    whose backward is one stack of their grads: indexing each unit in a
    differentiated forward would give each its own zero-filled,
    stack-sized grad, summed unit by unit (bytes growing as units²)."""
    if isinstance(tree, dict):
        parts = {k: _unbind(v, grouped) for k, v in tree.items()}
        return [{k: v[r] for k, v in parts.items()}
                for r in range(len(next(iter(parts.values()))))]
    return list(torch.unbind(tree, 1 if grouped else 0))


def forward_train(params, cfg, batch, remat=False):
    """Returns (logits (..., B, T, V) fp32, values (..., B, T) fp32, aux),
    aux the summed MoE load-balance loss (fp32 0 without MoE).

    remat=True checkpoints each repeat unit with
    `torch.utils.checkpoint` (non-reentrant), the counterpart of
    `jax.checkpoint` around `repro`'s scanned unit: the backward keeps one
    unit's activations at a time and runs the unit's forward again.
    `repro`'s `q_chunk` and `unroll` have no counterpart: the attention
    kernels tile the sequence themselves, and the loop over repeats is
    plain Python.

    Under a mesh scope (`distributed/sharding.param_scope`) each unit
    gathers its weights inside its own (checkpointed) function, so the
    gathered copy lives for that unit's forward, and with remat for its
    recompute in the backward; the heads are checkpointed too. Traced
    (`utils/trace.py`), the heads are the phase `model.head`."""
    _check_family(cfg)
    scope = SH.capture()
    x, positions = embed_inputs(params, cfg, batch)
    grouped = x.dim() == 4
    if grouped and (cfg.moe or cfg.ssm):
        raise ValueError(f"{cfg.name}: a leading model axis is taken by the dense family only")
    aux = 0.0
    for group in GROUPS:
        if group not in params:
            continue
        for unit in _unbind(params[group], grouped):
            def fn(x, unit=unit, group=group):
                with SH.restored(scope):
                    unit = SH.materialize(unit, (group,), 1 if grouped else 0)
                    return _apply_unit_full(cfg, unit, x, positions)
            x, a = checkpoint(fn, x, use_reentrant=False) if remat else fn(x)
            aux = aux + a

    def head(x):
        with SH.restored(scope):
            return heads(params, cfg, x)
    sharded = scope.params is not None
    with trace.phase("model.head", x):
        logits, values = (checkpoint(head, x, use_reentrant=False) if remat and sharded
                          else head(x))
    if not torch.is_tensor(aux):
        aux = torch.zeros((), device=logits.device)
    return logits, values, aux


# ===========================================================================
# decode: prefill, the ring-buffer state, one-token steps
# ===========================================================================

def _check_decoder(cfg):
    """`repro`'s init_decode_state asserts the same."""
    _check_family(cfg)
    if cfg.encoder_only:
        raise ValueError(f"{cfg.name} is encoder-only: no decode step")
    if cfg.mla is not None:
        raise NotImplementedError(f"{cfg.name}: latent attention has no decode cache here")


def _init_unit_cache(cfg, batch, cache_len, dtype, prefilled=0, device=None):
    if cfg.family == "ssm":
        xp, S0 = S.init_rwkv_state(cfg, batch, dtype, device)
        return {"tm_prev": xp, "tm_S": S0, "cm_prev": xp.clone()}
    c = {}
    for j in range(len(cfg.layer_pattern)):
        c[f"kv{j}"] = A.init_kv_cache(cfg, batch, cache_len, dtype, prefilled, device)
        if cfg.family == "hybrid":
            c[f"conv{j}"], c[f"ssm{j}"] = S.init_mamba_state(cfg, batch, dtype, device)
    return c


def _stacked_cache(cfg, batch, cache_len, dtype, prefilled, device, reps):
    """`reps` repeat units' caches, each leaf stacked on a leading repeat
    axis (the layout `jax.vmap` gives `repro`'s). Under a mesh scope the
    KV caches hold what this rank computes (`attention.init_kv_cache`)."""
    one = _init_unit_cache(cfg, batch, cache_len, dtype, prefilled, device)
    # a copy at every depth (`contiguous` keeps one unit's expand a view),
    # so a state's allocations grow by the same bytes with each unit
    return tree_map(lambda a: a.expand(reps, *a.shape).clone(), one)


def _group_sizes(cfg):
    """(group, repeat units) in run order: kimi-k2's dense prefix, then the blocks."""
    fkd = cfg.moe.first_k_dense if cfg.moe else 0
    return [(g, n) for g, n in zip(GROUPS, (fkd, _n_repeats(cfg))) if n]


def init_decode_state(cfg, batch, seq_len, *, sliding=False, prefilled=None,
                      device=None):
    """State for `decode_step`, as if `seq_len` positions had been
    decoded. sliding=True uses the O(window) ring buffer of
    `cfg.long_context_window` slots (the sub-quadratic long_500k variant).
    `prefilled` (default: all) marks how many slots hold valid keys; the
    recurrent states start at zero. `device` defaults to CUDA and raises
    where there is none."""
    _check_decoder(cfg)
    cache_len = min(seq_len, cfg.long_context_window) if sliding else seq_len
    pref = min(seq_len if prefilled is None else prefilled, cache_len)
    dev = resolve_device(device)
    state = {g: _stacked_cache(cfg, batch, cache_len, dtype_of(cfg.compute_dtype), pref,
                               dev, n) for g, n in _group_sizes(cfg)}
    # ring-buffer semantics: `length` is the absolute next position even when
    # the cache only holds the last `cache_len` entries.
    state["length"] = torch.full((batch,), seq_len, dtype=torch.int32, device=dev)
    return state


def decode_step(params, cfg, tokens, state, *, window=0, uniform=False):
    """One token per row. tokens: (B, 1) ints, or a dict holding `tokens`
    or `patch_embeds` (B, 1, d). `window` > 0 masks keys more than
    `window` positions back in every layer: pair it with a ring-buffer
    cache of that size for the sub-quadratic long_500k variant.
    `uniform=True` says every row is at the same position (one write slot
    for all rows). Returns (logits (B, 1, V) fp32, values (B, 1) fp32,
    state).

    The state passed in is consumed: each layer's new k, v and position go
    into its cache tensors in place (O(B * KV * hd) bytes a layer, not a
    copy of the stacked cache), its recurrent states are copied into
    theirs, and the returned state holds the same tensors with `length`
    advanced. Keep no other reference to it."""
    _check_decoder(cfg)
    batch = tokens if isinstance(tokens, dict) else {"tokens": tokens}
    cdt = dtype_of(cfg.compute_dtype)
    if "tokens" in batch:
        x = embed_tokens(params, cfg, batch["tokens"], cdt)
    else:
        x = batch["patch_embeds"].to(cdt)
    length = state["length"]
    new_length = length + 1
    for group, n in _group_sizes(cfg):
        stacked = state[group]
        for r in range(n):
            # every unit's caches decode at the state's length (`repro`'s
            # per-unit override)
            io = {key: ({**_index(c, r, False), "length": length} if isinstance(c, dict)
                        else c[r]) for key, c in stacked.items()}
            unit = SH.materialize(_index(params[group], r, False), (group,), 0)
            x = _apply_unit_step(cfg, unit, x, io, window_override=window,
                                 uniform=uniform)[0]
            del unit                  # one unit's gathered weights alive at a time
            for key, c in stacked.items():
                if not isinstance(c, dict):
                    c[r].copy_(io[key])
        for c in stacked.values():
            if isinstance(c, dict):
                c["length"].copy_(new_length.expand_as(c["length"]))
    logits, values = heads(params, cfg, x)
    return logits, values, {**state, "length": new_length}


def prefill(params, cfg, batch, *, sliding=False, reserve=64):
    """Full forward over the prompt, and the decode state built from its
    keys and values and the recurrent states at its end. Returns (logits
    (B, T, V) fp32, values (B, T), state); T counts the patch prefix.

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
    `forward_train` at any T.

    An encoder-only config (hubert) runs its bidirectional forward (the
    encoder's serving pass, `prefill_32k`) and builds the same caches, as
    `repro`'s prefill does; only `init_decode_state` and `decode_step`
    refuse it."""
    _check_family(cfg)
    x, positions = embed_inputs(params, cfg, batch)
    B, T = x.shape[0], x.shape[1]
    cache_len = min(T, cfg.long_context_window) if sliding else T + reserve
    start = max(T - cache_len, 0)
    slots = torch.arange(start, T, device=x.device) % cache_len
    state = {}
    for group, n in _group_sizes(cfg):
        stacked = _stacked_cache(cfg, B, cache_len, dtype_of(cfg.compute_dtype), 0,
                                 x.device, n)
        for r in range(n):
            def attend(j, lt, p, h, r=r):
                y, k, v = A.full_attention(p, cfg, h, positions, layer_type=lt,
                                           return_kv=True)
                A.fill_cache(_index(stacked[f"kv{j}"], r, False), k, v, positions, start,
                             slots)
                return y
            io = {}
            unit = SH.materialize(_index(params[group], r, False), (group,), 0)
            x = _apply_unit(cfg, unit, x, attend, io)[0]
            del unit                  # one unit's gathered weights alive at a time
            for key, t in io.items():
                stacked[key][r].copy_(t)
        for c in stacked.values():
            if isinstance(c, dict):
                c["length"].fill_(T)
        state[group] = stacked
    logits, values = heads(params, cfg, x)
    state["length"] = torch.full((B,), T, dtype=torch.int32, device=x.device)
    return logits, values, state
