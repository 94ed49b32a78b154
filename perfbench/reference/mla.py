"""Plain PyTorch reference of a latent-attention MoE learner (the `learn_mla`
cells): Kimi K2's layers as DeepSeek-V3 publishes them, and the learner's
loss, gradients, clip and AdamW. Nothing here imports the port or JAX.

Written from the published architecture (the file's `config.json` keys):

- MLA (`DeepseekV3Attention`, non-absorbed): q = W_qb rmsnorm(W_qa x)
  ((T, H, nope + rope)), [c_kv, k_pe] = W_kva x, [k_nope, v] =
  W_kvb rmsnorm(c_kv) ((T, H, nope + v)); rotary embeddings on q's last
  `qk_rope_head_dim` columns and on k_pe (one for all heads) with the
  checkpoints' pairing of adjacent dims, written out evens then odds;
  YaRN's frequencies (`DeepseekV3YarnRotaryEmbedding`); causal attention
  at the scale qk_head_dim^-0.5 times YaRN's mscale squared; W_o.
- the dense layers: a SiLU-gated MLP of `intermediate_size`.
- the MoE layers' share held here: a sigmoid router over all R experts
  (`published.n_routed_experts`), the top-k of s + b chosen, the chosen s
  renormalised times `routed_scaling_factor`; the held experts 0..E-1 run
  on the choices routed to them, each keeping the first C = max(int(N k cf
  / R), k) in rank-major order (the port's capacity rule); one shared
  expert of `moe_intermediate_size` x `n_shared_experts`; the
  sequence-wise balance term (DeepSeek-V3 eqs. 17-20) over all R experts,
  weighted by `moe.router_aux_coef`.

Every function computes in the dtype of its inputs, norms, rotary
embeddings, softmaxes and the router in fp32 inside; the checks pass fp32
with TF32 off. `lowp` rounds both inputs of every projection, expert and
head matmul to fp8 (`model.mm`): on bf16 weights, the control.

`readings` follows the learner's first steps from the seed's weights as
`learn.readings` does, leaf slice by leaf slice (`weights_mla.slices`).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench import weights_mla as WM
from perfbench.reference import learn as RL
from perfbench.reference import model as M

# -- rotary embeddings and scale (YaRN) ---------------------------------------

def yarn_mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def inv_freq(cfg, device=None):
    """YaRN's inverse frequencies of the rotary dims, as
    `DeepseekV3YarnRotaryEmbedding` computes them."""
    dim, base, rs = cfg["qk_rope_head_dim"], float(cfg["rope_theta"]), cfg["rope_scaling"]
    pos = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    extra, inter = 1.0 / base ** pos, 1.0 / (rs["factor"] * base ** pos)

    def corr(rot):
        return (dim * math.log(rs["original_max_position_embeddings"] / (rot * 2 * math.pi))
                / (2 * math.log(base)))
    low = max(math.floor(corr(rs["beta_fast"])), 0)
    high = min(math.ceil(corr(rs["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
            / (high - low)).clamp(0, 1)
    mask = 1.0 - ramp                    # 1: keep the frequency
    return inter * (1 - mask) + extra * mask


def cos_scale(cfg) -> float:
    rs = cfg["rope_scaling"]
    return yarn_mscale(rs["factor"], rs["mscale"]) / yarn_mscale(rs["factor"], rs["mscale_all_dim"])


def softmax_scale(cfg) -> float:
    rs = cfg["rope_scaling"]
    m = yarn_mscale(rs["factor"], rs["mscale_all_dim"]) if rs.get("mscale_all_dim") else 1.0
    return (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5 * m * m


def rope(x, cfg):
    """x (B, T, H, dim) at positions 0..T-1: adjacent pairs rotated,
    written out evens then odds (`apply_rotary_pos_emb` after its
    de-interleave)."""
    T = x.shape[1]
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] * inv_freq(cfg, x.device)
    m = cos_scale(cfg)
    cos, sin = (ang.cos() * m)[:, None, :], (ang.sin() * m)[:, None, :]
    xf = x.float()
    x1, x2 = xf[..., 0::2], xf[..., 1::2]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# -- attention ----------------------------------------------------------------

def _attend_block(q, k, v, start: int, scale: float):
    """Causal attention of query rows start.. start + Tq against keys up to
    the block's last row. q (B, H, Tq, dq), k (B, H, Tk, dq), v (B, H, Tk, dv)."""
    Tq, end = q.shape[2], start + q.shape[2]
    k, v = k[:, :, :end], v[:, :, :end]
    s = torch.einsum("bhqd,bhsd->bhqs", q, k) * scale
    qpos = torch.arange(start, end, device=q.device)[:, None]
    kpos = torch.arange(end, device=q.device)[None, :]
    s = s.float().masked_fill(kpos > qpos, float("-inf"))
    return torch.einsum("bhqs,bhsd->bhqd", torch.softmax(s, dim=-1).to(v.dtype), v)


def attend(q, k, v, scale, remat=False):
    """q, k (B, T, H, dq), v (B, T, H, dv) -> (B, T, H, dv), in blocks of
    query rows so that one block's scores are all that is alive at once."""
    B, T, H, _ = q.shape
    q, k, v = (t.permute(0, 2, 1, 3) for t in (q, k, v))
    rows = max(1, min(T, M.SCORE_ELEMS // max(B * H * T, 1)))
    outs = []
    for s in range(0, T, rows):
        blk = q[:, :, s:s + rows]
        outs.append(checkpoint(_attend_block, blk, k, v, s, scale, use_reentrant=False)
                    if remat else _attend_block(blk, k, v, s, scale))
    return torch.cat(outs, dim=2).permute(0, 2, 1, 3)


def mla(p, cfg, x, lowp=False, remat=False):
    """x (B, T, d) -> (B, T, d)."""
    B, T, _ = x.shape
    H = cfg["num_attention_heads"]
    nope, rp, dv = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    q = M.mm(M.rmsnorm(M.mm(x, p["attn.wq_a.w"], lowp), p["attn.q_a_norm.scale"]),
             p["attn.wq_b.w"], lowp).reshape(B, T, H, nope + rp)
    c_kv, k_pe = M.mm(x, p["attn.wkv_a.w"], lowp).split([cfg["kv_lora_rank"], rp], dim=-1)
    kv = M.mm(M.rmsnorm(c_kv, p["attn.kv_a_norm.scale"]), p["attn.wkv_b.w"], lowp)
    k_nope, v = kv.reshape(B, T, H, nope + dv).split([nope, dv], dim=-1)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], cfg)], dim=-1)
    k = torch.cat([k_nope, rope(k_pe[:, :, None], cfg).expand(B, T, H, rp)], dim=-1)
    o = attend(q, k, v, softmax_scale(cfg), remat)
    return M.mm(o.reshape(B, T, H * dv), p["attn.wo.w"], lowp)


# -- the MoE's share ----------------------------------------------------------

def route(p, cfg, xf):
    """(scores (N, R) fp32, weights (N, k), experts (N, k)) of the sigmoid
    router: the top-k of s + b, weighted by s, renormalised and scaled."""
    s = torch.sigmoid(xf.float() @ p["moe.router.w"].float())
    topi = torch.topk(s + p["moe.router.bias"].float(), cfg["num_experts_per_tok"], dim=-1).indices
    topv = s.gather(1, topi)
    w = topv / (topv.sum(-1, keepdim=True) + 1e-20) * cfg["routed_scaling_factor"]
    return s, w, topi


def balance(s, topi, B: int):
    """DeepSeek-V3's sequence-wise balance term over all R experts: the
    mean over sequences of sum_i f_i P_i (module docstring)."""
    N, R = s.shape
    T, k = N // B, topi.shape[1]
    f = torch.stack([torch.bincount(topi[b * T:(b + 1) * T].reshape(-1), minlength=R)
                     for b in range(B)]).to(s.dtype) * (R / (k * T))
    P = (s / s.sum(-1, keepdim=True)).reshape(B, T, R).mean(1)
    return (f * P).sum(-1).mean()


def moe(p, cfg, x, lowp=False):
    """x (B, T, d): the N = B T tokens routed together. Returns (this
    chip's partial sum (B, T, d), the balance term)."""
    B, T, d = x.shape
    xf = x.reshape(-1, d)
    N, k = xf.shape[0], cfg["num_experts_per_tok"]
    E, R = cfg["n_routed_experts"], WM.router_experts(cfg)
    s, w, topi = route(p, cfg, xf)
    C = max(int(N * k * cfg["moe"]["capacity_factor"] / R), k)
    flat = topi.t().reshape(-1)                     # choice j of token n at j * N + n
    y = torch.zeros_like(xf)
    for ex in range(E):
        idx = (flat == ex).nonzero()[:C, 0]         # its first C choices, rank-major
        if idx.numel() == 0:
            continue
        n, j = idx % N, idx // N
        xe = xf[n]
        h = F.silu(M.mm(xe, p["moe.gate"][ex], lowp)) * M.mm(xe, p["moe.up"][ex], lowp)
        y = y.index_add(0, n, M.mm(h, p["moe.down"][ex], lowp) * w[n, j][:, None].to(y.dtype))
    shared = {"mlp." + n[len("moe.shared."):]: t for n, t in p.items()
              if n.startswith("moe.shared.")}
    y = y + M.mlp(shared, xf, lowp)
    return y.reshape(B, T, d), balance(s, topi, B)


def block(p, cfg, x, dense: bool, lowp=False, remat=False):
    """One pre-norm layer: MLA, then the dense MLP or the MoE's share.
    Returns (x, balance term; 0 for a dense layer)."""
    x = x + mla(p, cfg, M.rmsnorm(x, p["attn_norm.scale"]), lowp, remat)
    h = M.rmsnorm(x, p["mlp_norm.scale"])
    if dense:
        return x + M.mlp(p, h, lowp), torch.zeros((), device=x.device)
    y, aux = moe(p, cfg, h, lowp)
    return x + y, aux


def _layer(P, pre, r):
    """Layer r's slices of the group under prefix `pre`, by the name after it."""
    return {k[len(pre):-len(f"[{r}]")]: t for k, t in P.items()
            if k.startswith(pre) and k.endswith(f"[{r}]")}


def layer_order(cfg):
    """(prefix, r, dense) of every layer in the order the model runs them:
    the dense prefix, then the MoE blocks."""
    return ([("dense_prefix.sub0.", r, True) for r in range(WM.layers(cfg, "dense_prefix"))]
            + [("blocks.sub0.", r, False) for r in range(WM.layers(cfg, "blocks"))])


def forward(P, cfg, tokens, lowp=False, remat=False):
    """(x (B, T, d) after the last layer, summed balance terms) from the
    slices P (`name[r]` keys, or the globals' names)."""
    x = F.embedding(tokens, P["embed.table"])
    aux = torch.zeros((), device=x.device)
    for pre, r, dense in layer_order(cfg):
        lp = _layer(P, pre, r)
        names = sorted(lp)

        def run(x, *ts, names=names, dense=dense):
            return block(dict(zip(names, ts)), cfg, x, dense, lowp, remat)
        if remat:
            x, a = checkpoint(run, x, *[lp[n] for n in names], use_reentrant=False)
        else:
            x, a = run(x, *[lp[n] for n in names])
        aux = aux + a
    return x, cfg["moe"]["router_aux_coef"] * aux


GLOBALS = ("final_norm.scale", "lm_head.w", "value_head.h.w", "value_head.h.b",
           "value_head.out.w", "value_head.out.b")


def behave(cfg, tensors, batch):
    """The initial policy's log-probabilities of the batch's actions and its
    values from this reference in bf16 (no grad), into `batch`: what an
    actor served by the initial policy records. `tensors` are the served
    weights by leaf name (stacks by layer)."""
    P = {}
    for key, lf, r in WM.slices(cfg):
        t = tensors[WM.name(lf)]
        P[key] = t[r] if lf.stacked else t
    with torch.no_grad():
        x, _ = forward(P, cfg, batch["tokens"])
        B, T, d = x.shape
        xf, a = x.reshape(B * T, d), batch["actions"].reshape(-1)
        g = {k: P[k] for k in GLOBALS}
        lps, vals = [], []
        for s in range(0, B * T, RL.HEAD_ROWS):
            lg, v = M.heads(g, xf[s:s + RL.HEAD_ROWS])
            a_s = a[s:s + RL.HEAD_ROWS, None]
            lps.append(torch.log_softmax(lg.float(), -1).gather(-1, a_s)[:, 0])
            vals.append(v.float())
        batch["behavior_logp"] = torch.cat(lps).reshape(B, T)
        batch["behavior_values"] = torch.cat(vals).reshape(B, T)


def loss_and_grads(P, cfg, hp, batch, lowp=False):
    """(loss, {key: grad}) of one batch at the fp32 slices P, as
    `learn.loss_and_grads`; with `lowp`, the control, on bf16 copies with
    fp8 products."""
    tokens = batch["tokens"]
    B, T = tokens.shape
    keys = list(P)
    dt = torch.bfloat16 if lowp else torch.float32
    leaves = [P[k].detach().to(dt).requires_grad_(True) for k in keys]
    Q = dict(zip(keys, leaves))
    g = {k: Q[k] for k in GLOBALS}
    with torch.enable_grad():
        x, aux = forward(Q, cfg, tokens, lowp, remat=True)
        xf = x.reshape(B * T, -1)
        with torch.no_grad():           # the targets come from the detached forward
            lps, vals = [], []
            for s in range(0, B * T, RL.HEAD_ROWS):
                lg, v = M.heads(g, xf[s:s + RL.HEAD_ROWS], lowp)
                a = batch["actions"].reshape(-1)[s:s + RL.HEAD_ROWS]
                lps.append(torch.log_softmax(lg, -1).gather(-1, a[:, None])[:, 0])
                vals.append(v)
            logp, values = torch.cat(lps).reshape(B, T), torch.cat(vals).reshape(B, T)
        vs, adv = RL.vtrace(batch["behavior_logp"], logp, batch["rewards"], values,
                            batch["discounts"], batch["bootstrap_value"],
                            hp["clip_rho"], hp["clip_c"], hp["lam"])
        n = B * T
        vs, adv = vs.reshape(-1), adv.reshape(-1)

        def part(xc, a, vsc, advc, *gs):
            gg = dict(zip(sorted(g), gs))
            lg, v = M.heads(gg, xc, lowp)
            lsm = torch.log_softmax(lg, -1)
            lp = lsm.gather(-1, a[:, None])[:, 0]
            ent = -(lsm.exp() * lsm).sum(-1)
            return (-(lp * advc).sum() + hp["value_coef"] * 0.5 * (v - vsc).square().sum()
                    - hp["entropy_coef"] * ent.sum()) / n

        loss = aux.to(torch.float32)
        for s in range(0, n, RL.HEAD_ROWS):
            sl = slice(s, s + RL.HEAD_ROWS)
            loss = loss + checkpoint(part, xf[sl], batch["actions"].reshape(-1)[sl], vs[sl],
                                     adv[sl], *[g[k] for k in sorted(g)], use_reentrant=False)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    return loss.detach().float(), dict(zip(keys, grads))


def readings(cfg, opt, hp, seed, batches, device, lowp=False):
    """Follow len(batches) steps from the seed's weights; the same numbers,
    under the same keys, as `learn.readings`."""
    b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
    out = {"loss": [], "grad_norm": [], "grad1": {}, "grad1_raw": {}, "change": {}}
    with M.exact_matmuls():
        P = {k: WM.draw(lf, seed, r, device, torch.float32) for k, lf, r in WM.slices(cfg)}
        m = {k: torch.zeros_like(t) for k, t in P.items()}
        v = {k: torch.zeros_like(t) for k, t in P.items()}
        for s, batch in enumerate(batches, start=1):
            loss, grads = loss_and_grads(P, cfg, hp, batch, lowp)
            with torch.no_grad():
                gn = torch.sqrt(sum(gr.double().square().sum() for gr in grads.values()))
                scale = min(1.0, opt["clip_norm"] / (float(gn) + 1e-9))
                lr = opt["lr"] * min(s / opt["warmup_steps"], 1.0)
                bc1, bc2 = 1 - b1 ** s, 1 - b2 ** s
                for k in P:
                    gr = grads[k].float() * scale
                    if s == 1:
                        out["grad1"][k] = float(gr.norm())
                        out["grad1_raw"][k] = float(grads[k].float().norm())
                    m[k].mul_(b1).add_(gr, alpha=1 - b1)
                    v[k].mul_(b2).addcmul_(gr, gr, value=1 - b2)
                    P[k] -= lr * (m[k] / bc1) / (torch.sqrt(v[k] / bc2) + eps)
                del grads
            out["loss"].append(float(loss))
            out["grad_norm"].append(float(gn))
        del m, v
        with torch.no_grad():
            for k, lf, r in WM.slices(cfg):
                out["change"][k] = float((P[k] - WM.draw(lf, seed, r, device,
                                                         torch.float32)).norm())
    return out
