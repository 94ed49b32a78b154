"""Runner of the `learn_mla` traffic kind: a V-trace learner fed unrolls,
on a latent-attention MoE (Kimi K2's layers, `weights_mla.py`).

It is the `learn` kind's runner (`cells/learn.py`: its batches, its window
and its check) on this model's own weights, behaviour pass and reference
(`reference/mla.py`). Set-up, counted in `setup_s`: the port's kernels
built or loaded, the configuration held against the port's registered
architecture (the published keys of the file: latent attention's sizes,
YaRN's rope scaling, the sigmoid router, the widths of the dense layers
and the shared expert; a file that differs, or asks for group-limited
routing, is refused), the weights drawn on the device from the seed, the
pool of batches (tokens and actions over the vocabulary's slice), their
behaviour log-probabilities and values from the reference in bf16 at the
initial weights, the port's train step and its first `check_steps` steps.

Traced (`--trace 1`), the summary's kind is `learn_mla`: its readers take
the step's model FLOPs from `work_mla.learn_step_flops` and the attention
kernels' bound from `work_mla`'s (192, 128) counts, v's width from the
file.
"""
from __future__ import annotations

import time

import torch

from perfbench import trace as TR
from perfbench import weights_mla as WM
from perfbench import work_mla
from perfbench.cells import learn as CL
from perfbench.harness import Outcome, Refused, phase
from perfbench.reference import learn as RL
from perfbench.reference import mla as RM


def check_arch(cfg: dict, arch) -> None:
    """Refuse a file whose published keys the port's architecture does not
    have (see the module's docstring)."""
    m, moe, router, ys = arch.mla, arch.moe, arch.router, arch.rope_scaling
    if cfg["n_group"] != 1 or cfg["topk_group"] != 1:
        raise Refused(f"{cfg['name']}: group-limited routing (n_group {cfg['n_group']}, "
                      f"topk_group {cfg['topk_group']}) is not ported")
    rs = cfg["rope_scaling"]
    want = {
        "attention": ("mla", "mla" if m is not None else "gqa"),
        "hidden_size": (cfg["hidden_size"], arch.d_model),
        "num_attention_heads": (cfg["num_attention_heads"], arch.num_heads),
        "q_lora_rank": (cfg["q_lora_rank"], m and m.q_lora_rank),
        "kv_lora_rank": (cfg["kv_lora_rank"], m and m.kv_lora_rank),
        "qk_nope_head_dim": (cfg["qk_nope_head_dim"], m and m.qk_nope_head_dim),
        "qk_rope_head_dim": (cfg["qk_rope_head_dim"], m and m.qk_rope_head_dim),
        "v_head_dim": (cfg["v_head_dim"], m and m.v_head_dim),
        "intermediate_size": (cfg["intermediate_size"], arch.d_ff),
        "moe_intermediate_size": (cfg["moe_intermediate_size"], moe.d_ff_expert),
        "shared width": (cfg["moe_intermediate_size"] * cfg["n_shared_experts"],
                         arch.shared_ff),
        "n_routed_experts": (cfg["n_routed_experts"], moe.num_experts),
        "router width": (WM.router_experts(cfg), arch.router_experts),
        "num_experts_per_tok": (cfg["num_experts_per_tok"], moe.experts_per_token),
        "first_k_dense_replace": (cfg["first_k_dense_replace"], moe.first_k_dense),
        "router": ((cfg["scoring_func"], cfg["topk_method"]),
                   ("sigmoid", "noaux_tc") if router is not None else ("softmax", "greedy")),
        "routed_scaling_factor": (cfg["routed_scaling_factor"],
                                  router and router.routed_scaling_factor),
        "norm_topk_prob": (cfg["norm_topk_prob"], True),
        "rope_theta": (cfg["rope_theta"], arch.rope_theta),
        "rope_scaling": ((rs["type"], rs["factor"], rs["original_max_position_embeddings"],
                          rs["beta_fast"], rs["beta_slow"], rs["mscale"], rs["mscale_all_dim"]),
                         ys and ("yarn", ys.factor, ys.original_max_position, ys.beta_fast,
                                 ys.beta_slow, ys.mscale, ys.mscale_all_dim)),
        "vocab_size": (cfg["vocab_size"], arch.vocab_size),
    }
    for k, (file_v, port_v) in want.items():
        if file_v != port_v:
            raise Refused(f"{cfg['name']}: the file's {k} is {file_v!r}, the port's {port_v!r}")


class Prepared(CL.Prepared):
    """The port's train step, its params and state, and the cell's data, as
    the `learn` kind's, from this model's weights and behaviour pass."""

    def __init__(self, cell):
        from repro_torch import learners, models, optim
        from repro_torch.kernels import _build
        from repro_torch.rl.vtrace_loss import VTraceConfig

        dev, cfg, tr = cell.device, cell.cfg, cell.traffic
        oc = tr["optimizer"]
        check_arch(cfg, cell.arch)
        if dev.type == "cuda":
            _build.library()
            torch.zeros(1, device=dev)          # the allocator, before its peak is reset
            torch.cuda.reset_peak_memory_stats(dev)
        phase(cell, "kernels")
        WM.check_layout(cfg, cell.arch, models.init_params)
        tensors = WM.make(cfg, cell.seed, dev)
        self.pool = CL.batches(cell, dev)
        CL._sync(dev)
        phase(cell, "weights and batches")
        for b in self.pool:
            RM.behave(cfg, tensors, b)
        CL._sync(dev)
        phase(cell, "behavior")
        self.ref_batches = [{k: v.clone() for k, v in b.items()}
                            for b in self.pool[:tr["check_steps"]]]
        self.params = WM.program_tree(cfg, tensors)
        del tensors
        opt = optim.adamw(optim.linear(0.0, oc["lr"], oc["warmup_steps"]), b1=oc["b1"],
                          b2=oc["b2"], eps=oc["eps"], clip_norm=oc["clip_norm"],
                          master_fp32=oc["master_fp32"], inplace=True)
        self.step = learners.build_seq_train_step(cell.arch, opt, hp=VTraceConfig(**tr["loss"]),
                                                  loss="vtrace", remat=tr["remat"])
        self.state = opt.init(self.params)
        CL._sync(dev)
        phase(cell, "optimizer state")
        self.n = 0


def _slices(cfg, tree):
    """(key, leaf, layer, tensor) of every leaf slice of a params-shaped tree."""
    for key, lf, r in WM.slices(cfg):
        t = CL._get(tree, lf.path)
        yield key, lf, r, (t[r] if lf.stacked else t)


def first_steps(cell, prep: Prepared) -> dict:
    """The port's readings over the steps the reference follows, as the
    `learn` kind's `first_steps`."""
    cfg, b1 = cell.cfg, cell.traffic["optimizer"]["b1"]
    losses, gnorms, grad1 = [], [], {}
    for s in range(cell.traffic["check_steps"]):
        m = prep.next()
        losses.append(m["loss"])
        gnorms.append(m["grad_norm"])
        if s == 0:
            grad1 = {k: t.float().norm() / (1 - b1)
                     for k, _, _, t in _slices(cfg, prep.state["mu"])}
    base = prep.state.get("master", prep.params)
    change = {k: (t.float() - WM.draw(lf, cell.seed, r, cell.device, torch.float32)).norm()
              for k, lf, r, t in _slices(cfg, base)}
    return {"loss": torch.stack(losses).tolist(), "grad_norm": torch.stack(gnorms).tolist(),
            "grad1": dict(zip(grad1, torch.stack(list(grad1.values())).tolist())),
            "change": dict(zip(change, torch.stack(list(change.values())).tolist()))}


def reference(cell, ref_batches, lowp=False) -> dict:
    tr = cell.traffic
    return RM.readings(cell.cfg, tr["optimizer"], tr["loss"], cell.seed, ref_batches,
                       cell.device, lowp)


def run(cell) -> Outcome:
    from repro_torch.kernels import cost

    dev, cfg, tr = cell.device, cell.cfg, cell.traffic
    prep = Prepared(cell)
    port = first_steps(cell, prep)
    CL._sync(dev)
    phase(cell, "first steps")

    B, T = tr["batch"], tr["unroll"]
    metrics, summary, health = {}, None, []
    if cell.trace:
        upd = CL.UpdateStart() if dev.type == "cuda" else None
        if upd:
            cost.listeners.append(upd)
        try:
            with TR.profiled(dev) as (spans, prof):
                for _ in range(tr["trace_steps"]):
                    with TR.unit():
                        m = prep.next()
                    if upd:
                        upd.end()
                    health.append(torch.stack([m["loss"], m["grad_norm"]]))
                CL._sync(dev)
        finally:
            if upd:
                cost.listeners.remove(upd)
        summary = TR.summarize(prof.events())
        att = summary["spans"].get("attention", {})
        dv = cfg["v_head_dim"]
        fw = [work_mla.attention_fwd(q, k, dv, e, c, w)
              for q, k, e, c, w in (spans.attention[i] for i in att.get("ids", []))]
        bw = [work_mla.attention_bwd(q, k, dv, e, c, w)
              for q, k, e, c, w in (spans.attention[i] for i in att.get("bwd_ids", []))]
        summary.update(kind="learn_mla",
                       model_flops_per_unit=work_mla.learn_step_flops(cfg, B, T),
                       attention_fwd_bound_s=sum(w.seconds() for w in fw),
                       attention_bwd_bound_s=sum(w.seconds() for w in bw),
                       update_ms=upd.ms() if upd else [])
    else:
        t0 = time.perf_counter()
        setup_s = t0 - cell.t_start
        prev = None
        while True:
            m = prep.next()
            cur = torch.stack([m["loss"], m["grad_norm"]])
            if prev is not None:
                health.append(prev.tolist())
            prev = cur
            if time.perf_counter() - t0 >= cell.seconds:
                break
        health.append(prev.tolist())
        CL._sync(dev)
        wall = time.perf_counter() - t0
        done = sum(map(RL.finite, health))
        metrics = {"learn_frames_per_s": done * B * T / wall, "setup_s": setup_s}
    health = [h.tolist() if torch.is_tensor(h) else h for h in health]
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    ref_batches = prep.ref_batches
    del prep, m
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    phase(cell, "window closed")
    checks = RL.compare(port, reference(cell, ref_batches))
    phase(cell, "reference")
    return Outcome(attempted=len(health), failed=sum(not RL.finite(h) for h in health),
                   metrics=metrics, checks=checks, memory_peak=peak, summary=summary)
