"""The plain reference of a policy flush: the same observation rows the
port served in one flush (the MoE's capacity depends on every token
routed together, so a flush is recomputed whole), through every layer in
fp32, then the action log-probabilities and the value at each row's last
position.

`readings` runs layer by layer over all the sampled flushes at once,
drawing each layer's weights from the seed only while that layer runs.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench import weights as W
from perfbench.reference import model as M

# A served row is off when its log-probability or value gap passes this.
# Routing flips near gate ties put up to 1 % of a sound flush's rows over
# it; a slot answered from another slot's observation, or the control's fp8
# products, put 10 % or more (PERF.md §2).
ROW_GAP = 0.15


def readings(cfg, seed, flushes, num_actions, device, lowp=False):
    """flushes: a list of (rows, T) int observation batches. Returns a
    list of (action log-probabilities (rows, num_actions), values (rows,))
    in fp32, one per flush. The reference runs in fp32; with `lowp`, the
    control, on bf16 weights and activations with fp8 products."""
    dt = torch.bfloat16 if lowp else torch.float32
    with M.exact_matmuls(), torch.no_grad():
        emb = W.globals_(cfg, seed, device, dt, only={"embed.table"})["embed.table"]
        xs = [F.embedding(torch.as_tensor(f, device=device).long(), emb) for f in flushes]
        del emb
        for r in range(cfg["num_layers"]):
            p = W.layer(cfg, seed, r, device, dt)
            xs = [M.block(p, cfg, x, lowp) for x in xs]
            del p
        g = W.globals_(cfg, seed, device, dt, only={
            "final_norm.scale", "lm_head.w", "value_head.h.w", "value_head.h.b",
            "value_head.out.w", "value_head.out.b"})
        out = []
        for x in xs:
            logits, values = M.heads(g, x[:, -1], lowp, actions=num_actions)
            out.append((torch.log_softmax(logits, -1), values))
    return out


def gaps(served, ref):
    """served: a list of (actions, logp, values) numpy rows per flush, as
    the port answered them; ref: `readings` of the same flushes. Per row
    of every flush: the gap of a served action's log-probability from the
    reference's log-probability of that action (inf for an action outside
    the action set), and the gap of its value."""
    lp_gaps, v_gaps = [], []
    for (a, lp, v), (rlp, rv) in zip(served, ref):
        a = torch.as_tensor(a).long()
        ok = (a >= 0) & (a < rlp.shape[-1])
        want = rlp.cpu().gather(-1, a.clamp(0, rlp.shape[-1] - 1)[:, None])[:, 0]
        gap = (torch.as_tensor(lp).float() - want).abs()
        lp_gaps.append(torch.where(ok, gap, torch.full_like(gap, float("inf"))))
        v_gaps.append((torch.as_tensor(v).float() - rv.cpu()).abs())
    return torch.cat(lp_gaps), torch.cat(v_gaps)


def rows_off(lp, v, row_gap=ROW_GAP) -> float:
    """The share of rows whose log-probability or value gap is over
    `row_gap`."""
    return float((torch.maximum(lp, v) > row_gap).float().mean())


def compare(served, ref) -> dict:
    """The numbers over `gaps`' rows: the count of actions outside the
    action set; the median, 90th percentile and widest log-probability gap
    (over the actions inside the set) and value gap; and `rows_off`, the
    share of rows either of whose gaps is over `ROW_GAP`."""
    lp, v = gaps(served, ref)
    ok = torch.isfinite(lp)
    out = {"bad_actions": int((~ok).sum()), "rows_off": rows_off(lp, v)}
    for name, g in (("logp", lp[ok]), ("value", v)):
        q = (torch.quantile(g, torch.tensor([0.5, 0.9])).tolist() if g.numel()
             else [float("nan")] * 2)
        out.update({f"{name}_median": q[0], f"{name}_p90": q[1],
                    name: float(g.max()) if g.numel() else float("nan")})
    return out
