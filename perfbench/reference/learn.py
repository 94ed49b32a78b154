"""The plain reference of the learner: the V-trace loss with its reverse
scan, the gradients, the global-norm clip and AdamW with fp32 master
weights and moments, followed from the seed's initial weights through the
first steps of a cell.

`readings` returns what the check compares, keyed as the harness keys the
port's: the loss and the global gradient norm of each step, each leaf's
norm of the first (clipped) gradient, each leaf's unclipped first gradient
(for the rule that leaves out leaves whose gradient is rounding), and each
leaf's norm of the change of its weights after the last step. A leaf is
one layer's slice of a stacked weight (`name[r]`) or a global weight.

The model runs layer by layer under checkpoints, and the heads and the
loss over blocks of rows, so that the fp32 step fits beside its state.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench import weights as W
from perfbench.reference import model as M

HEAD_ROWS = 1024               # rows of the heads and the loss at once


def vtrace(behavior_logp, target_logp, rewards, values, discounts, bootstrap,
           clip_rho=1.0, clip_c=1.0, lam=1.0):
    """(vs, pg_advantages), both (B, T), from IMPALA's definitions, the
    correction sum acc_t = delta_t + gamma_t c_t acc_{t+1} by a plain loop
    over time in float64 on the host."""
    rho = torch.exp(target_logp - behavior_logp)
    rho_c = rho.clamp(max=clip_rho)
    c = lam * rho.clamp(max=clip_c)
    v_next = torch.cat([values[:, 1:], bootstrap[:, None]], dim=1)
    deltas = (rho_c * (rewards + discounts * v_next - values)).double().cpu().numpy()
    decay = (discounts * c).double().cpu().numpy()
    acc = np.zeros_like(deltas)
    run = np.zeros(deltas.shape[0])
    for t in range(deltas.shape[1] - 1, -1, -1):
        run = deltas[:, t] + decay[:, t] * run
        acc[:, t] = run
    vs = values + torch.from_numpy(acc).to(values)
    vs_next = torch.cat([vs[:, 1:], bootstrap[:, None]], dim=1)
    return vs, rho_c * (rewards + discounts * vs_next - values)


def _keys(cfg):
    """(key, leaf, layer) of every leaf slice."""
    for lf in W.leaves(cfg):
        for r in range(cfg["num_layers"] if lf.stacked else 1):
            yield (f"{W.name(lf)}[{r}]" if lf.stacked else W.name(lf)), lf, r


def _layer(P, cfg, r):
    pre = "blocks.sub0."
    return {k[len(pre):-len(f"[{r}]")]: t for k, t in P.items()
            if k.startswith(pre) and k.endswith(f"[{r}]")}


def loss_and_grads(P, cfg, hp, batch, lowp=False):
    """(loss, {key: grad}) of one batch at the weights P (fp32 leaves);
    with `lowp`, the control, the forward and backward run on bf16 copies
    of them with fp8 products, and the grads are bf16."""
    tokens = batch["tokens"]
    B, T = tokens.shape
    keys = list(P)
    dt = torch.bfloat16 if lowp else torch.float32
    leaves = [P[k].detach().to(dt).requires_grad_(True) for k in keys]
    Q = dict(zip(keys, leaves))
    g = {k: Q[k] for k in ("final_norm.scale", "lm_head.w", "value_head.h.w",
                           "value_head.h.b", "value_head.out.w", "value_head.out.b")}
    with torch.enable_grad():
        x = F.embedding(tokens, Q["embed.table"])
        for r in range(cfg["num_layers"]):
            lp = _layer(Q, cfg, r)
            names = sorted(lp)
            x = checkpoint(lambda x, *ts, names=names: M.block(dict(zip(names, ts)), cfg, x,
                                                               lowp, remat=True),
                           x, *[lp[n] for n in names], use_reentrant=False)
        xf = x.reshape(B * T, -1)
        with torch.no_grad():           # the targets come from the detached forward
            lps, vals = [], []
            for s in range(0, B * T, HEAD_ROWS):
                lg, v = M.heads(g, xf[s:s + HEAD_ROWS], lowp)
                a = batch["actions"].reshape(-1)[s:s + HEAD_ROWS]
                lps.append(torch.log_softmax(lg, -1).gather(-1, a[:, None])[:, 0])
                vals.append(v)
            logp, values = torch.cat(lps).reshape(B, T), torch.cat(vals).reshape(B, T)
        vs, adv = vtrace(batch["behavior_logp"], logp, batch["rewards"], values,
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

        loss = 0.0
        for s in range(0, n, HEAD_ROWS):
            sl = slice(s, s + HEAD_ROWS)
            loss = loss + checkpoint(part, xf[sl], batch["actions"].reshape(-1)[sl], vs[sl],
                                     adv[sl], *[g[k] for k in sorted(g)], use_reentrant=False)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach().float(), dict(zip(keys, grads))


def readings(cfg, opt, hp, seed, batches, device, lowp=False):
    """Follow len(batches) steps from the seed's weights (module docstring)."""
    b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
    out = {"loss": [], "grad_norm": [], "grad1": {}, "grad1_raw": {}, "change": {}}
    with M.exact_matmuls():
        P = {k: W.draw(lf, seed, r, device, torch.float32) for k, lf, r in _keys(cfg)}
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
            for k, lf, r in _keys(cfg):
                out["change"][k] = float((P[k] - W.draw(lf, seed, r, device, torch.float32)).norm())
    return out


def _gap(a, b, floor):
    return abs(a - b) / max(abs(b), floor)


def compare(port, ref) -> dict:
    """The numbers the check holds to their limits:

    - loss: the widest gap of a step's loss, over max(|reference|, 1);
    - grad_norm: the widest relative gap of a step's global gradient norm;
    - grad1: the worst leaf's gap between its norms of the first clipped
      gradient, over the larger of the reference's norm of that leaf and
      of the median leaf;
    - change: the same for the norm of the weights' change after the last
      step, over the leaves whose reference gradient is at least a
      thousandth of the median leaf's (below that, Adam moves a leaf by
      rounding alone)."""
    med_g = float(np.median(list(ref["grad1"].values())))
    med_raw = float(np.median(list(ref["grad1_raw"].values())))
    moving = [k for k, g in ref["grad1_raw"].items() if g >= 1e-3 * med_raw]
    med_c = float(np.median([ref["change"][k] for k in moving]))
    return {
        "loss": max(_gap(a, b, 1.0) for a, b in zip(port["loss"], ref["loss"])),
        "grad_norm": max(_gap(a, b, 1e-30) for a, b in zip(port["grad_norm"], ref["grad_norm"])),
        "grad1": max(_gap(port["grad1"][k], g, med_g) for k, g in ref["grad1"].items()),
        "change": max(_gap(port["change"][k], ref["change"][k], med_c) for k in moving),
    }


def finite(x) -> bool:
    return all(math.isfinite(v) for v in (x if isinstance(x, (list, tuple)) else [x]))
