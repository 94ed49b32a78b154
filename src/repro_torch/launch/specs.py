"""input_specs(): meta-tensor stand-ins for every model input (shape and
dtype, no allocation); counterpart of `repro.launch.specs`, whose
`ShapeDtypeStruct`s these match leaf by leaf.

Step kinds per shape:
  train_4k    -> train step (learner): trajectory batch; hubert -> MLM batch
  prefill_32k -> prefill (InfServer prefill / encoder forward)
  decode_32k  -> serve step: ONE token + full KV cache of seq_len
  long_500k   -> serve step with the sub-quadratic variant (ring-buffer
                 sliding-window cache for attention archs; O(1) SSM state)
Skips: hubert has no decode step.

Everything here lives on `torch.device("meta")`: `param_shapes` runs the
port's `init_params` there and `decode_specs` its `init_decode_state`, so
kimi-k2's 1 T params never touch host memory.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import INPUT_SHAPES, InputShape, dtype_of
from repro_torch.models import init_decode_state, init_params
from repro_torch.models.transformer import _group_sizes, _stacked_cache

NUM_PATCHES = 1024   # vlm stub frontend: patch embeddings per sequence

META = torch.device("meta")


class _MetaGenerator(torch.Generator):
    """A generator whose draws land on the meta device: `init_params` makes
    its leaves on `gen.device`, and a meta tensor's draw reads nothing."""

    @property
    def device(self):
        return META


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def param_shapes(cfg) -> Dict[str, Any]:
    """The param tree of `cfg` as meta tensors (`jax.eval_shape(init_params)`)."""
    return init_params(_MetaGenerator(), cfg)


def step_kind(cfg, shape: InputShape) -> str:
    if shape.kind == "train":
        return "mlm_train" if cfg.encoder_only else "train"
    if shape.kind == "prefill":
        return "prefill"
    if cfg.encoder_only:
        return "skip"            # encoder-only: no decode step
    return "decode"


def uses_sliding(cfg, shape: InputShape) -> bool:
    """long_500k runs the O(window) ring-buffer variant for attention archs."""
    return shape.kind == "decode" and shape.seq_len > 65536


def train_batch_specs(cfg, shape: InputShape) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    cdt = dtype_of(cfg.compute_dtype)
    if cfg.encoder_only:
        return {
            "frame_embeds": _sds((B, S, cfg.d_model), cdt),
            "units": _sds((B, S), torch.int32),
            "mask": _sds((B, S), torch.bool),
        }
    specs: Dict[str, Any] = {}
    s_tok = S
    if cfg.family == "vlm":
        specs["patch_embeds"] = _sds((B, NUM_PATCHES, cfg.d_model), cdt)
        s_tok = S - NUM_PATCHES
    specs["tokens"] = _sds((B, s_tok), torch.int32)
    for f in ("behavior_logp", "behavior_values", "rewards", "discounts"):
        specs[f] = _sds((B, s_tok), torch.float32)
    specs["actions"] = _sds((B, s_tok), torch.int32)
    specs["bootstrap_value"] = _sds((B,), torch.float32)
    return specs


def prefill_batch_specs(cfg, shape: InputShape) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    cdt = dtype_of(cfg.compute_dtype)
    if cfg.encoder_only:
        return {"frame_embeds": _sds((B, S, cfg.d_model), cdt)}
    specs: Dict[str, Any] = {}
    s_tok = S
    if cfg.family == "vlm":
        specs["patch_embeds"] = _sds((B, NUM_PATCHES, cfg.d_model), cdt)
        s_tok = S - NUM_PATCHES
    specs["tokens"] = _sds((B, s_tok), torch.int32)
    return specs


def decode_specs(cfg, shape: InputShape) -> Tuple[Any, Any]:
    """(token spec, state specs): the port's init_decode_state on meta."""
    B, S = shape.global_batch, shape.seq_len
    state = init_decode_state(cfg, B, S, sliding=uses_sliding(cfg, shape), device=META)
    return _sds((B, 1), torch.int32), state


def prefill_state_shapes(cfg, shape: InputShape, reserve: int = 64) -> Dict[str, Any]:
    """The decode state the port's `prefill` returns over a whole prompt of
    `shape`: caches of seq_len + `reserve` slots."""
    B, S = shape.global_batch, shape.seq_len
    cdt = dtype_of(cfg.compute_dtype)
    state = {g: _stacked_cache(cfg, B, S + reserve, cdt, 0, META, n)
             for g, n in _group_sizes(cfg)}
    state["length"] = _sds((B,), torch.int32)
    return state


def metric_shapes(cfg, kind: str, loss: str = "ppo") -> Dict[str, Any]:
    """The metrics a train step returns: fp32 scalars under `repro`'s keys
    (the loss's, the optimizer's grad_norm and lr, and the loss)."""
    keys = ("pg_loss", "v_loss", "entropy")
    if kind == "mlm_train":
        keys = ("masked_acc",)
    elif loss == "ppo":
        keys += ("ratio_mean", "clip_frac")
    return {k: _sds((), torch.float32) for k in keys + ("grad_norm", "lr", "loss")}


def input_specs(cfg, shape_name: str):
    """(kind, specs) for one (arch, input-shape)."""
    shape = INPUT_SHAPES[shape_name]
    kind = step_kind(cfg, shape)
    if kind in ("train", "mlm_train"):
        return kind, train_batch_specs(cfg, shape)
    if kind == "prefill":
        return kind, prefill_batch_specs(cfg, shape)
    if kind == "decode":
        toks, state = decode_specs(cfg, shape)
        return kind, {"tokens": toks, "state": state}
    return "skip", None
