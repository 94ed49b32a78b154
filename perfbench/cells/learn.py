"""Runner of the `learn` traffic kind: a V-trace learner fed unrolls.

Set-up (counted in `setup_s` from the process's start): the port's kernels
built or loaded, the weights drawn on the device from the seed, a pool of
`pool` batches of `batch` unrolls of `unroll` tokens drawn from the seed
(tokens and actions uniform over the vocabulary, rewards N(0, 1),
discounts `gamma` but 0 where an episode ends with probability `done_p`,
bootstrap values N(0, 1)), their behavior log-probabilities and values
given by the benchmark's plain model in bf16 at the initial weights
(on-policy data, as an actor served by the initial policy records), the
port's train step (`learners.build_seq_train_step`, V-trace, remat) with
the traffic's optimizer, and its first `check_steps` steps on the pool's
first batches: those steps are the ones the reference follows, and the
window goes on from the same step object and state.

Window: steps on the pool's batches in turn, each enqueued before the
host waits for the one before it, until `seconds` have passed; then every
step is waited for. A step whose loss or global gradient norm is not
finite is attempted and failed; `learn_frames_per_s` is the batch * unroll
frames of every other step over the window's seconds.

Traced (`--trace 1`): `trace_steps` steps under the profiler, with the
harness's spans and a listener on the port's `cost.phase("update")` that
records a CUDA event where the optimizer starts.

Check: the plain reference follows the first `check_steps` steps from the
seed's weights on the same batches (`reference/learn.py`), once the
port's state is freed.
"""
from __future__ import annotations

import time

import torch
import torch.nn.functional as F

from perfbench import trace as TR
from perfbench import weights as W
from perfbench import work
from perfbench.harness import Outcome, phase
from perfbench.reference import learn as RL
from perfbench.reference import model as RM

PRE = "blocks.sub0."


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def batches(cell, dev):
    tr, V = cell.traffic, cell.cfg["vocab_size"]
    B, T = tr["batch"], tr["unroll"]
    out = []
    for i in range(tr["pool"]):
        g = torch.Generator(device=dev).manual_seed(W.derive(cell.seed, "batch", i))
        out.append({
            "tokens": torch.randint(0, V, (B, T), generator=g, device=dev),
            "actions": torch.randint(0, V, (B, T), generator=g, device=dev),
            "rewards": torch.randn((B, T), generator=g, device=dev),
            "discounts": tr["gamma"] * (torch.rand((B, T), generator=g, device=dev)
                                        >= tr["done_p"]).float(),
            "bootstrap_value": torch.randn((B,), generator=g, device=dev)})
    return out


def behave(cfg, tensors, batch):
    """The initial policy's log-probabilities of the batch's actions and
    its values, from the benchmark's plain model in bf16."""
    with torch.no_grad():
        x = F.embedding(batch["tokens"], tensors["embed.table"])
        for r in range(cfg["num_layers"]):
            p = {k[len(PRE):]: t[r] for k, t in tensors.items() if k.startswith(PRE)}
            x = RM.block(p, cfg, x)
        g = {k: t for k, t in tensors.items() if not k.startswith(PRE)}
        B, T, d = x.shape
        xf, a = x.reshape(B * T, d), batch["actions"].reshape(-1)
        lps, vals = [], []
        for s in range(0, B * T, RL.HEAD_ROWS):
            lg, v = RM.heads(g, xf[s:s + RL.HEAD_ROWS])
            a_s = a[s:s + RL.HEAD_ROWS, None]
            lps.append(torch.log_softmax(lg.float(), -1).gather(-1, a_s)[:, 0])
            vals.append(v.float())
        batch["behavior_logp"] = torch.cat(lps).reshape(B, T)
        batch["behavior_values"] = torch.cat(vals).reshape(B, T)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _slices(cfg, tree):
    """(key, leaf, layer, tensor) of every leaf slice of a params-shaped tree."""
    for lf in W.leaves(cfg):
        t = _get(tree, lf.path)
        if lf.stacked:
            for r in range(cfg["num_layers"]):
                yield f"{W.name(lf)}[{r}]", lf, r, t[r]
        else:
            yield W.name(lf), lf, 0, t


class UpdateStart:
    """A `cost` listener: a CUDA event where each step's update starts."""

    def __init__(self):
        self.starts, self.ends = [], []

    def kernel(self, *_):
        pass

    def phase(self, name):
        if name == "update":
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.starts.append(e)

    def end(self):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        self.ends.append(e)

    def ms(self):
        return [a.elapsed_time(b) for a, b in zip(self.starts, self.ends)]


class Prepared:
    """The port's train step, its params and state, and the cell's data."""

    def __init__(self, cell):
        from repro_torch import learners, models, optim
        from repro_torch.kernels import _build
        from repro_torch.rl.vtrace_loss import VTraceConfig

        dev, cfg, tr = cell.device, cell.cfg, cell.traffic
        oc = tr["optimizer"]
        if dev.type == "cuda":
            _build.library()
            torch.zeros(1, device=dev)          # the allocator, before its peak is reset
            torch.cuda.reset_peak_memory_stats(dev)
        phase(cell, "kernels")
        W.check_layout(cfg, cell.arch, models.init_params)
        tensors = W.make(cfg, cell.seed, dev)
        self.pool = batches(cell, dev)
        _sync(dev)
        phase(cell, "weights and batches")
        for b in self.pool:
            behave(cfg, tensors, b)
        _sync(dev)
        phase(cell, "behavior")
        self.ref_batches = [{k: v.clone() for k, v in b.items()}
                            for b in self.pool[:tr["check_steps"]]]
        self.params = W.program_tree(cfg, tensors)
        del tensors
        opt = optim.adamw(optim.linear(0.0, oc["lr"], oc["warmup_steps"]), b1=oc["b1"],
                          b2=oc["b2"], eps=oc["eps"], clip_norm=oc["clip_norm"],
                          master_fp32=oc["master_fp32"], inplace=True)
        self.step = learners.build_seq_train_step(cell.arch, opt, hp=VTraceConfig(**tr["loss"]),
                                                  loss="vtrace", remat=tr["remat"])
        self.state = opt.init(self.params)
        _sync(dev)
        phase(cell, "optimizer state")
        self.n = 0

    def next(self):
        """One train step on the pool's next batch; its metrics."""
        self.params, self.state, m = self.step(self.params, self.state,
                                               self.pool[self.n % len(self.pool)])
        self.n += 1
        return m


def first_steps(cell, prep: Prepared) -> dict:
    """The port's readings over the steps the reference follows: each
    step's loss and global gradient norm, each leaf's norm of the first
    clipped gradient (its first moment after one step, over 1 - b1) and of
    its master weights' change after the last of them."""
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
    change = {k: (t.float() - W.draw(lf, cell.seed, r, cell.device, torch.float32)).norm()
              for k, lf, r, t in _slices(cfg, base)}
    return {"loss": torch.stack(losses).tolist(), "grad_norm": torch.stack(gnorms).tolist(),
            "grad1": dict(zip(grad1, torch.stack(list(grad1.values())).tolist())),
            "change": dict(zip(change, torch.stack(list(change.values())).tolist()))}


def reference(cell, ref_batches, lowp=False) -> dict:
    tr = cell.traffic
    return RL.readings(cell.cfg, tr["optimizer"], tr["loss"], cell.seed, ref_batches,
                       cell.device, lowp)


def run(cell) -> Outcome:
    from repro_torch.kernels import cost

    dev, cfg, tr = cell.device, cell.cfg, cell.traffic
    prep = Prepared(cell)
    port = first_steps(cell, prep)
    _sync(dev)
    phase(cell, "first steps")

    B, T = tr["batch"], tr["unroll"]
    metrics, summary, health = {}, None, []
    if cell.trace:
        upd = UpdateStart() if dev.type == "cuda" else None
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
                _sync(dev)
        finally:
            if upd:
                cost.listeners.remove(upd)
        summary = TR.summarize(prof.events())
        att = summary["spans"].get("attention", {})
        fw = [work.attention_fwd(*spans.attention[i]) for i in att.get("ids", [])]
        bw = [work.attention_bwd(*spans.attention[i]) for i in att.get("bwd_ids", [])]
        summary.update(kind="learn", model_flops_per_unit=work.learn_step_flops(cfg, B, T),
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
        _sync(dev)
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
