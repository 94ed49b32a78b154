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

Over a mesh (`distributed/sharding.py`), inside a data-parallel scope,
each rank routes its own tokens and the load-balance statistics are
averaged over the data axes, so the aux loss is the global batch's. A
model rank holds E/M of the experts (when E % M == 0) and runs only those:
every model rank routes the same tokens to the same choices, scatters
those of its experts into a local buffer, and the weighted outputs are
summed over 'model'. The capacity rule comes from the expert-parallel
toggle (`set_expert_parallel`), as `repro`'s does:
  - off (`repro`'s GSPMD `moe_apply`, whose expert buffers lie over
    'model'): the global capacity, C = max(int(N * k * cf / E), k) of
    every data rank's N tokens, a choice's position in its expert being its
    rank in the global rank-major order (`route_global`), so the mesh
    gives the single device's result whatever drops; the aux loss is
    computed over all E on every model rank;
  - on (`moe_apply_ep`, `repro`'s `shard_map` body run per rank): the
    per-(data shard) capacity, C = max(int(N_l * k * cf / E), k).

DeepSeek-V3's sigmoid router (`configs.RouterConfig`, `noaux_tc`; the
port's own: `repro` has none) runs on a single device: the
experts are chosen by the top-k of sigmoid(x W) + b over the router's
width R, b an untrained correction bias, and weighted by the chosen scores
s, renormalised and scaled; the balance term is DeepSeek-V3's
sequence-wise one (`seq_balance`). Where the layer holds E < R experts
(the share of rank 0 of an expert-parallel layer, experts 0..E-1), it
routes over all R with the capacity C = max(int(N * k * cf / R), k),
runs its E experts on the choices routed to them (`route_local`), and adds
the shared expert once: its result is this device's partial sum.
"""
from __future__ import annotations

import math

import torch

from repro_torch.distributed import sharding as SH
from repro_torch.models import layers as L
from repro_torch.utils import trace

PAD_ROWS = 16   # drop-bucket rows, as `repro` sizes its buffer
BIAS_SCALE = 0.02  # the correction bias's initial draw: N(0, 1) clipped to +-2, times this


def init_moe(gen, cfg, dtype):
    """The router over `cfg.router_experts` (with its correction bias, an
    fp32 (R,) buffer no loss reaches, where the router has one), the
    `num_experts` experts held, and the shared experts as one MLP of width
    `cfg.shared_ff`."""
    e = cfg.moe
    d, ff = cfg.d_model, e.d_ff_expert
    scale = d ** -0.5
    p = {
        "router": {"w": L._normal(gen, (d, cfg.router_experts), scale, torch.float32)},
        "up": L._normal(gen, (e.num_experts, d, ff), scale, dtype),
        "gate": L._normal(gen, (e.num_experts, d, ff), scale, dtype),
        "down": L._normal(gen, (e.num_experts, ff, d), ff ** -0.5, dtype),
    }
    if cfg.router is not None:
        p["router"]["bias"] = L._normal(gen, (cfg.router_experts,), BIAS_SCALE, torch.float32)
    if e.num_shared_experts:
        p["shared"] = L.mlp_init(gen, d, cfg.shared_ff, dtype, gated=cfg.mlp_gated)
    return p


def route_topk(gates: torch.Tensor, k: int, capacity: int):
    """gates: (N, E) fp32 probabilities. Returns (slot (N, k), weight (N, k),
    keep (N, k), counts (E,)): slot indexes an (E*capacity + PAD_ROWS)
    buffer, E*capacity being the drop bucket; counts are the choices per
    expert before capacity."""
    E = gates.shape[1]
    slot, topv, keep, counts = route_local(gates, k, capacity, 0, E)
    return slot, topv, keep, counts[:E]


# expert-parallel toggle, set by the step factory (`launch/steps.py`): a
# sharded run routes with the per-(data shard) capacity (expert
# parallelism) when it is on, and with the global one when it is off; the
# experts split over 'model' either way. A single device ignores it.
_EXPERT_PARALLEL = False


def set_expert_parallel(on: bool):
    global _EXPERT_PARALLEL
    _EXPERT_PARALLEL = bool(on)


def expert_parallel() -> bool:
    return _EXPERT_PARALLEL


def moe_apply(p, cfg, x):
    """x: (B, T, d) -> (y (B, T, d), aux_loss fp32 scalar). Works for T == 1
    decode too. The experts' weights are cast to x's dtype per call, as
    `repro` casts them. Inside a data-parallel scope the mesh path runs
    (`_moe_ranked`) over the experts this rank holds, expert-parallel when
    the toggle is on and the experts divide over 'model', as `repro`
    decides. Traced (`utils/trace.py`), the single-device path is three
    phases: `moe.route` (router, top-k, the scatter into the expert
    buffers), `moe.experts` (the expert products) and `moe.combine`. A
    layer that holds a share of the router's experts fills and combines
    its buffer row by row (`_slot_rows`)."""
    mesh = SH.dp_mesh()
    if mesh is not None:
        if cfg.router is not None:
            raise NotImplementedError(f"{cfg.name}: a mesh routes with the softmax router only")
        M = SH.mesh_sizes(mesh).get("model", 1)
        return _moe_ranked(p, cfg, x, mesh,
                           ep=expert_parallel() and cfg.moe.num_experts % M == 0)
    e = cfg.moe
    B, T, d = x.shape
    xf = x.reshape(B * T, d)
    N = xf.shape[0]
    E, k = e.num_experts, e.experts_per_token
    sigmoid = cfg.router is not None
    share = cfg.router_experts > E
    capacity = max(int(N * k * e.capacity_factor / cfg.router_experts), k)

    with trace.phase("moe.route", x):
        logits = xf.float() @ p["router"]["w"].float()
        if sigmoid:
            scores = torch.sigmoid(logits)                                  # (N, R)
            weight, topi = sigmoid_choices(scores, p["router"]["bias"], k,
                                           cfg.router.routed_scaling_factor)
            slot, weight, keep, _ = route_local(scores, k, capacity, 0, E, (weight, topi))
        else:
            gates = torch.softmax(logits, dim=-1)                           # (N, E)
            slot, weight, keep, counts = route_topk(gates, k, capacity)
        if share:
            tok, w_slot = _slot_rows(slot, weight * keep, N, E * capacity)
            expert_in = torch.cat([xf, xf.new_zeros((1, d))]).index_select(0, tok)
            expert_in = expert_in.view(E, capacity, d)
        else:
            # scatter tokens into the expert buffers; the drop bucket is row E*C
            buf = x.new_zeros((E * capacity + PAD_ROWS, d))
            buf[slot.reshape(-1)] = xf[torch.arange(N * k, device=x.device) // k]
            expert_in = buf[:E * capacity].view(E, capacity, d)

    with trace.phase("moe.experts", x):
        a = L.act_fn(cfg.activation)
        h = torch.bmm(expert_in, p["up"].to(x.dtype))
        g = torch.bmm(expert_in, p["gate"].to(x.dtype))
        out = torch.bmm(a(g) * h, p["down"].to(x.dtype))

    with trace.phase("moe.combine", x):
        if share:
            y = x.new_zeros((N + 1, d)).index_add(
                0, tok, out.reshape(E * capacity, d) * w_slot[:, None].to(x.dtype))[:N]
        else:
            out_flat = torch.cat([out.reshape(E * capacity, d), x.new_zeros((PAD_ROWS, d))])
            w = (weight * keep).to(x.dtype)
            y = torch.einsum("nk,nkd->nd", w, out_flat[slot])

        if "shared" in p:
            y = y + L.mlp(p["shared"], xf, cfg.activation)

        if sigmoid:
            aux = e.router_aux_coef * seq_balance(scores, topi, B)
        else:
            # load-balance aux loss (Switch): E * sum_e f_e * p_e, f before capacity
            f = counts.float() / (N * k)
            aux = e.router_aux_coef * E * (f * gates.mean(0)).sum()
    return y.reshape(B, T, d), aux


def _choices(gates, k: int):
    """(weight (N, k), expert (N, k)): the top-k gates, renormalised."""
    topv, topi = torch.topk(gates, k, dim=-1)
    return topv / (topv.sum(-1, keepdim=True) + 1e-9), topi


def _slot_rows(slot, weight, N: int, rows: int):
    """(token (rows,), weight (rows,)) of each row of the held experts'
    buffer: the token whose choice fills it and that choice's weight, or
    row N (a zero row) and weight 0 where no choice does. slot (N, k) as
    `route_local` gives it, weight (N, k) with dropped choices at 0. The
    buffer is filled and combined row by row from these, so the work
    scales with the held experts' rows, not with the N k choices, nearly
    all of which go to experts held elsewhere."""
    flat = slot.reshape(-1)
    k = slot.shape[1]
    src = torch.arange(N, device=slot.device).repeat_interleave(k)
    tok = torch.full((rows + PAD_ROWS,), N, dtype=torch.long, device=slot.device)
    tok = tok.scatter(0, flat, src)[:rows]        # the drop bucket's rows are cut off
    w = weight.new_zeros(rows + PAD_ROWS).scatter(0, flat, weight.reshape(-1))[:rows]
    return tok, w


def sigmoid_choices(scores, bias, k: int, scale: float):
    """(weight (N, k), expert (N, k)) of a sigmoid router: the top-k of
    scores + bias, weighted by their scores (the bias picks, it weighs
    nothing), renormalised and times `scale`."""
    topi = torch.topk(scores + bias.float(), k, dim=-1).indices
    topv = scores.gather(1, topi)
    return topv / (topv.sum(-1, keepdim=True) + 1e-20) * scale, topi


def seq_balance(scores, topi, B: int):
    """DeepSeek-V3's sequence-wise balance term (eqs. 17-20) over the
    router's R experts, the mean over the B sequences of sum_i f_i P_i:
    f_i = R / (k T) times the sequence's choices of expert i (before
    capacity), P_i the mean over its tokens of s_i / sum_j s_j.
    scores (B T, R) fp32, topi (B T, k)."""
    N, R = scores.shape
    T, k = N // B, topi.shape[1]
    f = torch.zeros((B, R), dtype=scores.dtype, device=scores.device).scatter_add_(
        1, topi.reshape(B, T * k), torch.ones((B, T * k), dtype=scores.dtype,
                                              device=scores.device)) * (R / (k * T))
    P = (scores / scores.sum(-1, keepdim=True)).reshape(B, T, R).mean(1)
    return (f * P).sum(-1).mean()


def _positions(e, buckets: int):
    """e: (N, k) bucket of each choice. Returns (pos (N, k), counts
    (buckets,)): each choice's position in its bucket in rank-major order
    (all rank-0 choices first) from a stable sort, and the choices per
    bucket."""
    N, k = e.shape
    flat_e = e.t().reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    counts = torch.zeros(buckets, dtype=torch.long, device=e.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = counts.cumsum(0) - counts
    pos_sorted = torch.arange(k * N, device=e.device) - starts[flat_e[order]]
    return torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted).reshape(k, N).t(), counts


def route_local(gates, k: int, capacity: int, m_idx: int, E_l: int, choices=None):
    """`route_topk` for model rank `m_idx`'s experts [m_idx * E_l, (m_idx +
    1) * E_l): choices of other ranks' experts are dropped here (their rank
    takes them). `choices` (weight, expert), each (N, k), where the router
    chose otherwise than by the top-k of `gates`. Returns (slot (N, k) into
    an (E_l * capacity + PAD_ROWS) buffer, weight (N, k), keep (N, k),
    counts (E_l + 1,): the local experts' choices before capacity, then the
    other ranks')."""
    topv, topi = _choices(gates, k) if choices is None else choices
    local_e = topi - m_idx * E_l
    valid = (local_e >= 0) & (local_e < E_l)
    pos, counts = _positions(torch.where(valid, local_e, E_l), E_l + 1)
    keep = valid & (pos < capacity)
    slot = torch.where(keep, local_e * capacity + pos, E_l * capacity)
    return slot, topv, keep, counts


def route_global(gates, k: int, capacity_factor: float, mesh, axes, m_idx: int = 0,
                 E_l: int = 0):
    """`route_topk` over the global batch of a data-parallel scope, for
    this rank's N tokens: the capacity is `repro`'s GSPMD one, max(int(D *
    N * k * cf / E), k) over the D data ranks' tokens, and a choice's
    position in its expert is its rank in the global rank-major order: the
    choices of lower top-k ranks on every data rank, then those of its own
    top-k rank on earlier data ranks, then its local position. Each data
    rank's (k, E) choice counts are all-gathered over `axes` to place them.

    Returns (slot (N, k), weight (N, k), keep (N, k), counts (E,) before
    capacity, rows). A rank's kept choices are a prefix of each expert's
    local order and number fewer than min(capacity, N), so `slot` indexes a
    local (E_l * rows + PAD_ROWS) buffer over model rank `m_idx`'s experts
    [m_idx * E_l, (m_idx + 1) * E_l) (all E when E_l is 0), rows =
    min(capacity, N), E_l * rows being the drop bucket, where the choices
    of other ranks' experts go too (their rank takes them)."""
    N, E = gates.shape
    topv, topi = _choices(gates, k)
    pos, counts = _positions(topi, E)
    mine = torch.zeros((k, E), dtype=torch.long, device=gates.device).scatter_add_(
        1, topi.t(), torch.ones_like(topi.t()))
    every = SH.all_gather(mine[None], 0, mesh, axes)             # (D, k, E)
    D, d = every.shape[0], SH.data_index(mesh, axes)
    total = every.sum(0)
    before = (total.cumsum(0) - total) + every[:d].sum(0) - (mine.cumsum(0) - mine)
    gpos = pos + before.gather(1, topi.t()).t()
    capacity = max(int(D * N * k * capacity_factor / E), k)
    keep = gpos < capacity
    rows = min(capacity, N)
    E_l = E_l or E
    local_e = topi - m_idx * E_l
    mine = keep & (local_e >= 0) & (local_e < E_l)
    slot = torch.where(mine, local_e * rows + pos, E_l * rows)
    return slot, topv, keep, counts, rows


def _local_experts(t, E, E_l, m_idx):
    """This model rank's (E_l, ...) experts: a DTensor's 'model' shard,
    gathered over the data axes (ZeRO-3; the backward reduce-scatters the
    grads), or a slice of a plain tensor that holds all E."""
    t = SH.gather(t, keep=("model",))
    return t[m_idx * E_l:(m_idx + 1) * E_l] if t.shape[0] == E and E_l != E else t


def moe_apply_ep(p, cfg, x, mesh):
    """Expert-parallel MoE on a DeviceMesh, `repro`'s `shard_map` body run
    on every rank. x is this rank's (B_l, T, d) rows of the data axes (a
    DTensor is taken as its local rows); returns this rank's rows of y and
    the aux loss, the same on every rank.

      - the expert weights come as this rank's E/M experts, gathered over
        the data axes (ZeRO-3: the backward reduce-scatters their grads);
      - routing runs on every model rank (one (N_l, E) matmul);
      - each model rank scatters only the choices routed to its experts
        into a local (E_l * C + PAD_ROWS, d) buffer;
      - the combine is an all-reduce over 'model' of each rank's weighted
        outputs;
      - the shared expert is split over 'model' on its hidden dim;
      - aux: f and the mean gate p are averaged over the data axes before
        the product, then summed over 'model', as `repro`'s.

    Capacity is per (data shard, expert): C = max(int(N_l * k * cf / E), k),
    the global capacity's expected load with a slightly different drop
    boundary, as in `repro`."""
    E = cfg.moe.num_experts
    M = SH.mesh_sizes(mesh).get("model", 1)
    m_idx = SH.axis_index(mesh, "model") if M > 1 else 0
    q = dict(p, router={"w": SH.gather(p["router"]["w"])})
    for n in ("up", "gate", "down"):
        q[n] = _local_experts(p[n], E, E // M, m_idx)
    if "shared" in p:
        q["shared"] = {n: {k: SH.gather(t) for k, t in leaf.items()}
                       for n, leaf in p["shared"].items()}
    return _moe_ranked(q, cfg, x, mesh, ep=True)


def _hidden_slice(mlp, M, m):
    """Model rank m's slice of a bias-free MLP's hidden dim: up's and
    gate's columns, down's rows."""
    if any(set(leaf) != {"w"} for leaf in mlp.values()):
        raise ValueError("a split shared expert takes no bias")
    cut = lambda t, dim: t.narrow(dim, t.shape[dim] // M * m, t.shape[dim] // M)
    return {n: {"w": cut(leaf["w"], -2 if n == "down" else -1)} for n, leaf in mlp.items()}


def _moe_ranked(p, cfg, x, mesh, ep: bool):
    """The MoE on one rank of a mesh: this rank's tokens, routed with the
    global capacity (`route_global`), or with `ep` with the per-shard one
    (`route_local`), over the experts this rank holds. `p` holds plain
    tensors: the router whole, the experts whole or this model rank's E/M,
    the shared expert whole or a slice of its hidden dim."""
    e = cfg.moe
    sizes = SH.mesh_sizes(mesh)
    dp = SH.data_axes(mesh)
    D = math.prod(sizes[ax] for ax in dp)
    E, k = e.num_experts, e.experts_per_token
    E_l = p["up"].shape[0]
    M = E // E_l                                # model ranks the experts split over
    m_idx = SH.axis_index(mesh, "model") if M > 1 else 0
    a = L.act_fn(cfg.activation)

    xl = SH.local_rows(x)
    B_l, T, d = xl.shape
    N_l = B_l * T
    xf = xl.reshape(N_l, d)

    gates = torch.softmax(xf.float() @ p["router"]["w"].float(), dim=-1)
    if ep:
        C = max(int(N_l * k * e.capacity_factor / E), k)
        slot, topv, keep, counts = route_local(gates, k, C, m_idx, E_l)
    else:
        slot, topv, keep, counts, C = route_global(gates, k, e.capacity_factor, mesh,
                                                   SH.dp_axes(), m_idx, E_l)

    buf = xl.new_zeros((E_l * C + PAD_ROWS, d))
    buf[slot.reshape(-1)] = xf[torch.arange(N_l * k, device=xl.device) // k]
    expert_in = buf[:E_l * C].view(E_l, C, d)
    h = torch.bmm(expert_in, p["up"].to(xl.dtype))
    g = torch.bmm(expert_in, p["gate"].to(xl.dtype))
    out = torch.bmm(a(g) * h, p["down"].to(xl.dtype))
    out_flat = torch.cat([out.reshape(E_l * C, d), xl.new_zeros((PAD_ROWS, d))])
    w = (topv * keep).to(xl.dtype)
    y = torch.einsum("nk,nkd->nd", w, out_flat[slot])
    if M > 1:
        y = SH.all_reduce_sum(y, mesh, ("model",))             # combine

    if "shared" in p:
        sh, ff = p["shared"], cfg.shared_ff
        Mm = sizes.get("model", 1)
        if ep and Mm > 1 and sh["up"]["w"].shape[-1] == ff and ff % Mm == 0:
            sh = _hidden_slice(sh, Mm, SH.axis_index(mesh, "model"))
        ys = L.mlp(sh, xf, cfg.activation)
        if sh["up"]["w"].shape[-1] != ff:                     # a slice of the hidden dim
            ys = SH.all_reduce_sum(ys, mesh, ("model",))
        y = y + ys

    # load-balance aux: the global load fraction times the global mean gate
    # probability, averaged over data before the product; with `ep` each
    # model rank's experts' terms, summed over 'model', else every expert's
    # on every model rank
    lo, n = (m_idx * E_l, E_l) if ep else (0, E)
    f_local = counts[:n].float() / (N_l * k)
    p_local = gates.mean(0)[lo:lo + n]
    if dp:
        f_local = SH.all_reduce_sum(f_local, mesh, dp) / D
        p_local = SH.all_reduce_sum(p_local, mesh, dp) / D
    aux = e.router_aux_coef * E * (f_local * p_local).sum()
    if ep and M > 1:
        aux = SH.all_reduce_sum(aux, mesh, ("model",))
    return y.reshape(B_l, T, d), aux
