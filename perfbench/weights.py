"""Seeded weights and data, made on the device from `--seed`.

The benchmark owns the model's weights: it draws them here and hands the
same tensors to the port, and the plain reference draws them again from
the same seed, leaf by leaf, so it never reads a tensor the port could
have changed. Every leaf is one stack (layers, *shape) or one global
tensor; each layer's slice of a stack is drawn by one call from its own
generator, seeded from (seed, leaf name, layer), so any slice can be drawn
again alone. A matrix is N(0, 1) clamped to +-2 and scaled by its fan-in
to the power -1/2, then rounded to the dtype it is served in; a norm's
scale is ones and a bias zeros. Both sides round through that dtype, so
the reference's fp32 weights are the served values exactly.

`leaves` describes the layout of the transformer in the benchmark's own
names; `program_tree` arranges the tensors as the port's params dict, and
`check_layout` holds that arrangement against the port's own `init_params`
at a tiny size, so a change to the port's layout fails loudly here.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, NamedTuple, Tuple

import torch

_DT = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class Leaf(NamedTuple):
    path: Tuple[str, ...]   # key path in the port's params dict
    shape: Tuple[int, ...]  # per layer for a stacked leaf
    init: str               # normal | ones | zeros
    scale: float
    dtype: str
    stacked: bool


def derive(seed: int, *salt) -> int:
    """A 63-bit generator seed from the run's seed and a salt (names, ints)."""
    h = hashlib.sha256(repr((int(seed),) + tuple(salt)).encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def leaves(cfg: dict) -> List[Leaf]:
    """The transformer's leaves in the port's params order (dense or MoE
    blocks, one attention sublayer per unit)."""
    d, H, KV, hd = cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    q, kv, V = H * hd, KV * hd, cfg["vocab_size"]
    pdt = cfg["param_dtype"]
    out = [Leaf(("embed", "table"), (V, d), "normal", 1.0, pdt, False)]
    blk = ("blocks", "sub0")
    out += [Leaf(blk + ("attn_norm", "scale"), (d,), "ones", 1.0, pdt, True),
            Leaf(blk + ("attn", "wq", "w"), (d, q), "normal", d ** -0.5, pdt, True),
            Leaf(blk + ("attn", "wk", "w"), (d, kv), "normal", d ** -0.5, pdt, True),
            Leaf(blk + ("attn", "wv", "w"), (d, kv), "normal", d ** -0.5, pdt, True),
            Leaf(blk + ("attn", "wo", "w"), (q, d), "normal", q ** -0.5, pdt, True)]
    if cfg.get("qk_norm"):
        out += [Leaf(blk + ("attn", "q_norm", "scale"), (hd,), "ones", 1.0, pdt, True),
                Leaf(blk + ("attn", "k_norm", "scale"), (hd,), "ones", 1.0, pdt, True)]
    out.append(Leaf(blk + ("mlp_norm", "scale"), (d,), "ones", 1.0, pdt, True))
    moe = cfg.get("moe")
    if moe:
        E, ff = moe["num_experts"], moe["d_ff_expert"]
        out += [Leaf(blk + ("moe", "router", "w"), (d, E), "normal", d ** -0.5, "float32", True),
                Leaf(blk + ("moe", "up"), (E, d, ff), "normal", d ** -0.5, pdt, True),
                Leaf(blk + ("moe", "gate"), (E, d, ff), "normal", d ** -0.5, pdt, True),
                Leaf(blk + ("moe", "down"), (E, ff, d), "normal", ff ** -0.5, pdt, True)]
    else:
        ff = cfg["d_ff"]
        out += [Leaf(blk + ("mlp", "up", "w"), (d, ff), "normal", d ** -0.5, pdt, True),
                Leaf(blk + ("mlp", "down", "w"), (ff, d), "normal", ff ** -0.5, pdt, True),
                Leaf(blk + ("mlp", "gate", "w"), (d, ff), "normal", d ** -0.5, pdt, True)]
    vh = cfg["value_head_hidden"]
    out += [Leaf(("final_norm", "scale"), (d,), "ones", 1.0, pdt, False),
            Leaf(("lm_head", "w"), (d, V), "normal", d ** -0.5, pdt, False),
            Leaf(("value_head", "h", "w"), (d, vh), "normal", d ** -0.5, pdt, False),
            Leaf(("value_head", "h", "b"), (vh,), "zeros", 1.0, pdt, False),
            Leaf(("value_head", "out", "w"), (vh, 1), "normal", vh ** -0.5, pdt, False),
            Leaf(("value_head", "out", "b"), (1,), "zeros", 1.0, pdt, False)]
    return out


def name(leaf: Leaf) -> str:
    return ".".join(leaf.path)


def draw(leaf: Leaf, seed: int, layer: int, device, dtype=None) -> torch.Tensor:
    """One layer's slice of `leaf` (layer 0 of a global leaf), rounded to
    the leaf's dtype, then given as `dtype` (default: the leaf's)."""
    own = _DT[leaf.dtype]
    if leaf.init == "ones":
        t = torch.ones(leaf.shape, dtype=own, device=device)
    elif leaf.init == "zeros":
        t = torch.zeros(leaf.shape, dtype=own, device=device)
    else:
        g = torch.Generator(device=device).manual_seed(derive(seed, name(leaf), layer))
        t = torch.randn(leaf.shape, generator=g, dtype=torch.float32, device=device)
        t = t.clamp_(-2.0, 2.0).mul_(leaf.scale).to(own)
    return t if dtype is None else t.to(dtype)


def make(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf, by name: stacks (layers, *shape) and globals, in their
    served dtypes. Each stack is allocated once and filled layer by layer,
    one draw per layer."""
    L = cfg["num_layers"]
    out = {}
    for leaf in leaves(cfg):
        if not leaf.stacked:
            out[name(leaf)] = draw(leaf, seed, 0, device)
            continue
        buf = torch.empty((L, *leaf.shape), dtype=_DT[leaf.dtype], device=device)
        for r in range(L):
            buf[r].copy_(draw(leaf, seed, r, device))
        out[name(leaf)] = buf
    return out


def layer(cfg: dict, seed: int, r: int, device, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Layer r's slices of every stacked leaf, by the name after `blocks.sub0.`."""
    return {name(lf)[len("blocks.sub0."):]: draw(lf, seed, r, device, dtype)
            for lf in leaves(cfg) if lf.stacked}


def globals_(cfg: dict, seed: int, device, dtype=torch.float32,
             only=None) -> Dict[str, torch.Tensor]:
    """The global leaves (embedding, final norm, heads), by name."""
    return {name(lf): draw(lf, seed, 0, device, dtype) for lf in leaves(cfg)
            if not lf.stacked and (only is None or name(lf) in only)}


def program_tree(cfg: dict, tensors: Dict[str, torch.Tensor]) -> dict:
    """The port's params dict over the same tensors (no copies)."""
    tree: dict = {}
    for leaf in leaves(cfg):
        node = tree
        for k in leaf.path[:-1]:
            node = node.setdefault(k, {})
        node[leaf.path[-1]] = tensors[name(leaf)]
    return tree


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    else:
        yield prefix, tree


def check_layout(cfg: dict, arch_cfg, init_params) -> None:
    """Hold `leaves` against the port's `init_params` at a tiny size: the
    same key paths in the same order, shapes and dtypes."""
    import dataclasses
    small = dataclasses.replace(arch_cfg, vocab_size=64, d_model=32, num_heads=2,
                                num_kv_heads=1, head_dim=16, d_ff=48,
                                value_head_hidden=cfg["value_head_hidden"], num_layers=2)
    tiny = dict(cfg, vocab_size=64, d_model=32, num_heads=2, num_kv_heads=1, head_dim=16,
                d_ff=48, num_layers=2)
    if small.moe is not None:
        small = dataclasses.replace(small, moe=dataclasses.replace(
            small.moe, num_experts=4, experts_per_token=2, d_ff_expert=24))
        tiny["moe"] = dict(cfg["moe"], num_experts=4, experts_per_token=2, d_ff_expert=24)
    want = [(lf.path, ((2,) if lf.stacked else ()) + lf.shape, _DT[lf.dtype])
            for lf in leaves(tiny)]
    got = [(p, tuple(t.shape), t.dtype)
           for p, t in _paths(init_params(torch.Generator().manual_seed(0), small))]
    if want != got:
        raise RuntimeError(f"the port's params layout changed: want {want}, got {got}")
