#!/usr/bin/env python3
"""Where the card's memory goes in one family's train step.

    python3 tools/train_memory.py [--arch qwen3-moe-235b-a22b] [--steps 2]

Builds the arch as `chip_smoke.py`'s `train_families` phase does
(TRAIN_FAMILIES' depth, batch and tokens; random weights from a seed;
`build_seq_train_step` under adamw(3e-4, clip_norm=1.0, master_fp32 for
bf16 params, in place)) and gives, in MB of allocated device memory:

- what stays: params, the optimizer state, the batch;
- the peak of each part of a step above what was allocated when it began:
  the forward and backward (`torch.autograd.grad`, the grads included)
  and the update; and the steps' peak.

Prints one JSON line. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

MB = 2 ** 20


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("train_memory: needs a CUDA card", file=sys.stderr)
        return 2
    from chip_smoke import TRAIN_FAMILIES, seq_batch
    from repro_torch.configs import get_arch
    from repro_torch.learners import steps as S
    from repro_torch.models import forward_train, init_params
    from repro_torch.optim import adamw
    from repro_torch.utils import tree_leaves

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-moe-235b-a22b", choices=sorted(TRAIN_FAMILIES))
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda")
    depth, B, T, P = TRAIN_FAMILIES[args.arch]
    cfg = get_arch(args.arch)
    if depth:
        cfg = dataclasses.replace(cfg, num_layers=depth)
    alloc = lambda: torch.cuda.memory_allocated() / MB
    size = lambda tree: sum(t.numel() * t.element_size() for t in tree_leaves(tree)) / MB
    out = {"arch": args.arch, "card": smi, "layers": cfg.num_layers, "batch": [B, T],
           "patches": P}

    torch.cuda.reset_peak_memory_stats()
    params = init_params(torch.Generator(device=dev).manual_seed(24), cfg)
    out["init_peak_mb"] = torch.cuda.max_memory_allocated() / MB
    out["params_mb"] = size(params)
    batch = seq_batch(np.random.default_rng(23), T, cfg.vocab_size, dev, B=B)
    if P:
        batch["patch_embeds"] = torch.randn(B, P, cfg.d_model, device=dev,
                                            generator=torch.Generator(device=dev).manual_seed(25))
    with torch.inference_mode():
        inputs = {k: batch[k] for k in ("tokens", "patch_embeds") if k in batch}
        lg, v, _ = forward_train(params, cfg, inputs)
        batch["behavior_logp"] = torch.log_softmax(lg[:, -T:], -1).gather(
            -1, batch["actions"][..., None])[..., 0]
        batch["behavior_values"] = v[:, -T:]
        del lg, v
    opt = adamw(3e-4, clip_norm=1.0, master_fp32=cfg.param_dtype == "bfloat16", inplace=True)
    state = opt.init(params)
    out["opt_state_mb"] = size({k: v for k, v in state.items() if k != "step"})
    out["batch_mb"] = size(batch)

    # the step's two parts, each with its own peak above what it began with
    parts, peaks = {}, []

    def value_and_grad(loss_fn, p):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = alloc()
        res = value_and_grad_impl(loss_fn, p)
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated() / MB)
        parts.setdefault("fwd_bwd_peak_above_mb", []).append(peaks[-1] - before)
        parts.setdefault("grads_mb", []).append(size(res[2]))
        return res

    def update(grads, st, p):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = alloc()
        res = opt.update(grads, st, p)
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated() / MB)
        parts.setdefault("update_peak_above_mb", []).append(peaks[-1] - before)
        return res

    value_and_grad_impl = S._value_and_grad
    S._value_and_grad = value_and_grad         # what `_apply` calls
    step = S.build_seq_train_step(cfg, opt._replace(update=update))
    torch.cuda.synchronize()
    out["resting_mb"] = alloc()
    losses = []
    for _ in range(args.steps):
        params, state, m = step(params, state, batch)
        losses.append(m["loss"].item())
        del m
    torch.cuda.synchronize()
    out.update(parts, losses=losses, steps_peak_mb=max(peaks))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
