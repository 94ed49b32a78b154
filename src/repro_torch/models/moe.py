"""Top-k MoE with sort-based token dispatch (counterpart of `repro.models.moe`).

Plain PyTorch, on every device: `repro` reaches no Pallas kernel here (its
routing is `top_k`, `argsort` and a histogram, its expert products are
`einsum`s), so there is no TPU kernel to port. The expert products are
batched matmuls over the (E, C, d) buffer.

Routing keeps `repro`'s order and capacity exactly: top-k of the softmax
gates, flattened rank-major (all rank-0 choices first, so earlier ranks win
capacity) and sorted stably by expert; a choice past its expert's
`capacity` goes to the drop bucket, row E*C of the (E*C + PAD_ROWS, d)
buffer, which the gather reads back as zeros. The per-expert counts come
from a `scatter_add_` into zeros(E) rather than `torch.bincount`, which
reads its maximum back to the host: a decode step stays free of host
syncs. The capacity is a Python int of the shapes.

The expert-parallel path (`repro`'s `moe_apply_ep`, a `shard_map` over a
mesh) comes with the mesh in slice 12.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as L

PAD_ROWS = 16   # drop-bucket rows, as `repro` sizes its buffer


def init_moe(gen, cfg, dtype):
    e = cfg.moe
    d, ff = cfg.d_model, e.d_ff_expert
    scale = d ** -0.5
    p = {
        "router": {"w": L._normal(gen, (d, e.num_experts), scale, torch.float32)},
        "up": L._normal(gen, (e.num_experts, d, ff), scale, dtype),
        "gate": L._normal(gen, (e.num_experts, d, ff), scale, dtype),
        "down": L._normal(gen, (e.num_experts, ff, d), ff ** -0.5, dtype),
    }
    if e.num_shared_experts:
        p["shared"] = L.mlp_init(gen, d, cfg.d_ff * e.num_shared_experts, dtype,
                                 gated=cfg.mlp_gated)
    return p


def route_topk(gates: torch.Tensor, k: int, capacity: int):
    """gates: (N, E) fp32 probabilities. Returns (slot (N, k), weight (N, k),
    keep (N, k), counts (E,)): slot indexes an (E*capacity + PAD_ROWS)
    buffer, E*capacity being the drop bucket; counts are the choices per
    expert before capacity."""
    N, E = gates.shape
    topv, topi = torch.topk(gates, k, dim=-1)                  # (N, k), descending
    topv = topv / (topv.sum(-1, keepdim=True) + 1e-9)
    flat_e = topi.t().reshape(-1)                              # rank-major (k*N,)
    order = torch.argsort(flat_e, stable=True)
    counts = torch.zeros(E, dtype=torch.long, device=gates.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = counts.cumsum(0) - counts
    pos_sorted = torch.arange(k * N, device=gates.device) - starts[flat_e[order]]
    pos = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted).reshape(k, N).t()
    keep = pos < capacity
    slot = torch.where(keep, topi * capacity + pos, E * capacity)
    return slot, topv, keep, counts


def set_expert_parallel(on: bool):
    """`repro`'s toggle for `moe_apply_ep`. Only off is ported."""
    if on:
        raise NotImplementedError("expert-parallel MoE needs the mesh (slice 12)")


def moe_apply_ep(p, cfg, x, mesh):
    raise NotImplementedError("expert-parallel MoE (shard_map) comes with the mesh (slice 12)")


def moe_apply(p, cfg, x):
    """x: (B, T, d) -> (y (B, T, d), aux_loss fp32 scalar). Works for T == 1
    decode too. The experts' weights are cast to x's dtype per call, as
    `repro` casts them."""
    e = cfg.moe
    B, T, d = x.shape
    N = B * T
    xf = x.reshape(N, d)
    E, k = e.num_experts, e.experts_per_token
    capacity = max(int(N * k * e.capacity_factor / E), k)

    gates = torch.softmax(xf.float() @ p["router"]["w"].float(), dim=-1)   # (N, E)
    slot, weight, keep, counts = route_topk(gates, k, capacity)

    # scatter tokens into the expert buffers; the drop bucket is row E*C
    buf = x.new_zeros((E * capacity + PAD_ROWS, d))
    buf[slot.reshape(-1)] = xf[torch.arange(N * k, device=x.device) // k]
    expert_in = buf[:E * capacity].view(E, capacity, d)

    a = L.act_fn(cfg.activation)
    h = torch.bmm(expert_in, p["up"].to(x.dtype))
    g = torch.bmm(expert_in, p["gate"].to(x.dtype))
    out = torch.bmm(a(g) * h, p["down"].to(x.dtype))

    out_flat = torch.cat([out.reshape(E * capacity, d), x.new_zeros((PAD_ROWS, d))])
    w = (weight * keep).to(x.dtype)
    y = torch.einsum("nk,nkd->nd", w, out_flat[slot])

    if "shared" in p:
        y = y + L.mlp(p["shared"], xf, cfg.activation)

    # load-balance aux loss (Switch): E * sum_e f_e * p_e, f before capacity
    f = counts.float() / (N * k)
    aux = e.router_aux_coef * E * (f * gates.mean(0)).sum()
    return y.reshape(B, T, d), aux
