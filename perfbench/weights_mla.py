"""Seeded weights of a latent-attention MoE learner (the `learn_mla` cells),
in the benchmark's own layout; the draws are `weights.py`'s.

The configuration's file names the published keys (`config.json`'s, as the
catalog has them): `num_attention_heads`, `q_lora_rank`, `kv_lora_rank`,
`qk_nope_head_dim`, `qk_rope_head_dim`, `v_head_dim`, `intermediate_size`
(the dense layers), `moe_intermediate_size` and `n_shared_experts`,
`n_routed_experts` (the experts held here; `published` has the router's
width), `first_k_dense_replace`; and the port's `d_model`, `num_layers`,
`vocab_size`, `value_head_hidden`, `param_dtype`.

Every stacked leaf has one slice per layer of its group: `dense_prefix`
holds the first `first_k_dense_replace` layers (attention and a dense MLP),
`blocks` the rest (attention and the MoE: the router over every expert,
with its correction bias, the held experts and the shared expert). Each
slice is drawn from (seed, leaf name, layer), as `weights.draw` does, so the
reference draws any one again alone. The correction bias is N(0, 1)
clamped to +-2 times `BIAS_SCALE`, an untrained buffer that only picks
experts (the port's `moe.BIAS_SCALE`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

from perfbench import weights as W
from perfbench.weights import Leaf, draw, name

BIAS_SCALE = 0.02


def router_experts(cfg: dict) -> int:
    """The router's width: every expert of an MoE layer, held or not."""
    return cfg["published"]["n_routed_experts"]


def layers(cfg: dict, group: str) -> int:
    k = cfg["first_k_dense_replace"]
    return k if group == "dense_prefix" else cfg["num_layers"] - k


def _attn(cfg, blk, pdt):
    d, H = cfg["d_model"], cfg["num_attention_heads"]
    qr, kvr = cfg["q_lora_rank"], cfg["kv_lora_rank"]
    nope, rope, dv = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    a = blk + ("attn",)
    return [Leaf(blk + ("attn_norm", "scale"), (d,), "ones", 1.0, pdt, True),
            Leaf(a + ("wq_a", "w"), (d, qr), "normal", d ** -0.5, pdt, True),
            Leaf(a + ("q_a_norm", "scale"), (qr,), "ones", 1.0, pdt, True),
            Leaf(a + ("wq_b", "w"), (qr, H * (nope + rope)), "normal", qr ** -0.5, pdt, True),
            Leaf(a + ("wkv_a", "w"), (d, kvr + rope), "normal", d ** -0.5, pdt, True),
            Leaf(a + ("kv_a_norm", "scale"), (kvr,), "ones", 1.0, pdt, True),
            Leaf(a + ("wkv_b", "w"), (kvr, H * (nope + dv)), "normal", kvr ** -0.5, pdt, True),
            Leaf(a + ("wo", "w"), (H * dv, d), "normal", (H * dv) ** -0.5, pdt, True),
            Leaf(blk + ("mlp_norm", "scale"), (d,), "ones", 1.0, pdt, True)]


def _mlp(path, d, ff, pdt):
    return [Leaf(path + ("up", "w"), (d, ff), "normal", d ** -0.5, pdt, True),
            Leaf(path + ("down", "w"), (ff, d), "normal", ff ** -0.5, pdt, True),
            Leaf(path + ("gate", "w"), (d, ff), "normal", d ** -0.5, pdt, True)]


def leaves(cfg: dict) -> List[Leaf]:
    """Every leaf in the port's params order."""
    d, V, pdt = cfg["d_model"], cfg["vocab_size"], cfg["param_dtype"]
    E, R, ff = cfg["n_routed_experts"], router_experts(cfg), cfg["moe_intermediate_size"]
    out = [Leaf(("embed", "table"), (V, d), "normal", 1.0, pdt, False)]
    blk = ("blocks", "sub0")
    m = blk + ("moe",)
    out += _attn(cfg, blk, pdt)
    out += [Leaf(m + ("router", "w"), (d, R), "normal", d ** -0.5, "float32", True),
            Leaf(m + ("router", "bias"), (R,), "normal", BIAS_SCALE, "float32", True),
            Leaf(m + ("up",), (E, d, ff), "normal", d ** -0.5, pdt, True),
            Leaf(m + ("gate",), (E, d, ff), "normal", d ** -0.5, pdt, True),
            Leaf(m + ("down",), (E, ff, d), "normal", ff ** -0.5, pdt, True)]
    out += _mlp(m + ("shared",), d, ff * cfg["n_shared_experts"], pdt)
    pre = ("dense_prefix", "sub0")
    out += _attn(cfg, pre, pdt) + _mlp(pre + ("mlp",), d, cfg["intermediate_size"], pdt)
    vh = cfg["value_head_hidden"]
    out += [Leaf(("final_norm", "scale"), (d,), "ones", 1.0, pdt, False),
            Leaf(("lm_head", "w"), (d, V), "normal", d ** -0.5, pdt, False),
            Leaf(("value_head", "h", "w"), (d, vh), "normal", d ** -0.5, pdt, False),
            Leaf(("value_head", "h", "b"), (vh,), "zeros", 1.0, pdt, False),
            Leaf(("value_head", "out", "w"), (vh, 1), "normal", vh ** -0.5, pdt, False),
            Leaf(("value_head", "out", "b"), (1,), "zeros", 1.0, pdt, False)]
    return out


def count(cfg: dict, leaf: Leaf) -> int:
    """Slices of a leaf: its group's layers, or 1 for a global leaf."""
    return layers(cfg, leaf.path[0]) if leaf.stacked else 1


def slices(cfg: dict):
    """(key, leaf, layer) of every leaf slice: `name[r]`, r counting the
    layers of the leaf's group, or the name of a global leaf."""
    for lf in leaves(cfg):
        for r in range(count(cfg, lf)):
            yield (f"{name(lf)}[{r}]" if lf.stacked else name(lf)), lf, r


def make(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf by name in its served dtype: stacks filled slice by slice."""
    out = {}
    for lf in leaves(cfg):
        if not lf.stacked:
            out[name(lf)] = draw(lf, seed, 0, device)
            continue
        n = count(cfg, lf)
        buf = torch.empty((n, *lf.shape), dtype=W._DT[lf.dtype], device=device)
        for r in range(n):
            buf[r].copy_(draw(lf, seed, r, device))
        out[name(lf)] = buf
    return out


def program_tree(cfg: dict, tensors: Dict[str, torch.Tensor]) -> dict:
    """The port's params dict over the same tensors (no copies)."""
    tree: dict = {}
    for lf in leaves(cfg):
        node = tree
        for k in lf.path[:-1]:
            node = node.setdefault(k, {})
        node[lf.path[-1]] = tensors[name(lf)]
    return tree


TINY = dict(d_model=64, num_attention_heads=2, q_lora_rank=32, kv_lora_rank=16,
            qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16, intermediate_size=80,
            moe_intermediate_size=24, vocab_size=64, value_head_hidden=16, num_layers=3)


def tiny(cfg: dict, arch):
    """(file, ArchConfig) at the tiny size of `check_layout`."""
    from repro_torch.configs import MLAConfig
    t = dict(cfg, **TINY, n_routed_experts=2, num_experts_per_tok=2,
             published=dict(cfg["published"], n_routed_experts=4))
    small = dataclasses.replace(
        arch, d_model=64, num_heads=2, num_kv_heads=2, head_dim=24, d_ff=80, vocab_size=64,
        value_head_hidden=16, num_layers=3,
        d_ff_shared=24 * arch.moe.num_shared_experts,
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16, qk_rope_head_dim=8,
                      v_head_dim=16),
        moe=dataclasses.replace(arch.moe, num_experts=2, experts_per_token=2, d_ff_expert=24),
        router=dataclasses.replace(arch.router, experts=4))
    return t, small


def check_layout(cfg: dict, arch, init_params) -> None:
    """Hold `leaves` against the port's `init_params` at a tiny size: the
    same key paths in the same order, shapes and dtypes."""
    t, small = tiny(cfg, arch)
    want = [(lf.path, ((count(t, lf),) if lf.stacked else ()) + lf.shape, W._DT[lf.dtype])
            for lf in leaves(t)]
    got = [(p, tuple(x.shape), x.dtype)
           for p, x in W._paths(init_params(torch.Generator().manual_seed(0), small))]
    if want != got:
        raise RuntimeError(f"the port's params layout changed: want {want}, got {got}")
