#!/usr/bin/env python3
"""Time the flash-attention kernels at the main path's shapes.

    python3 tools/time_flash.py [ROOT ...]

Each ROOT is a checkout of this repository (default: this one). Its
`src/repro_torch` kernels are built and timed in a process of their own,
so a parent tree unpacked under `build/` and this tree can be compared on
one card in turns:

    python3 tools/time_flash.py build/parent . . build/parent

Shapes, all head_dim 32 on the model's (B, T, H, d) activations viewed as
(B, H, T, d): the policy-s and policy-m serving flushes ((256, 4/2, 26)
and (256, 8/4, 26), bf16), the env step ((512, 4/2, 26), bf16; forward,
dq and dk/dv) and the seq step ((1, 4/2, 4096), fp32, window 512, softcap 30;
forward, dq and dk/dv). At the two learner shapes `dq_ms` times what gives dq
and delta: one `flash_attention_bwd_dq` call where the dq kernel computes
delta in its prologue, and a tree whose API still has
`flash_attention_bwd_preprocess` gets the preprocess and then dq, timed
together and alone (`preprocess_ms`, `dq_alone_ms`), so `dq_ms` compares
like with like. Each time is the median of 30 CUDA-event-timed calls
after a warm-up, with the L2 cache warm; `sdpa` is
F.scaled_dot_product_attention at the shapes it computes (no window, no
softcap), a yardstick the port never calls. Prints one JSON line per root
with the card's name and power limit. Needs one CUDA card.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve()
# name, B, H, KV, T, dtype, window, cap, time dk/dv too
SHAPES = [("serve_policy_s", 256, 4, 2, 26, "bfloat16", 0, 0.0, False),
          ("serve_policy_m", 256, 8, 4, 26, "bfloat16", 0, 0.0, False),
          ("env_step", 512, 4, 2, 26, "bfloat16", 0, 0.0, True),
          ("seq_step", 1, 4, 2, 4096, "float32", 512, 30.0, True)]


def time_one(root: Path) -> dict:
    sys.path.insert(0, str(root / "src"))
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops

    torch.backends.cuda.matmul.allow_tf32 = False

    def device_ms(fn, n=30):
        fn()
        torch.cuda.synchronize()
        ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(n)]
        torch.cuda._sleep(100_000_000)    # keep the card busy while the host enqueues
        for a, b in ev:
            a.record()
            fn()
            b.record()
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in ev)

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for name, B, H, KV, T, dt, window, cap, bwd in SHAPES:
        d, dtype = 32, getattr(torch, dt)

        def make(heads):
            return torch.randn(B, T, heads, d, generator=gen, device="cuda").to(dtype).transpose(1, 2)

        q, k, v, do = make(H), make(KV), make(KV), make(H)
        kw = dict(scale=d ** -0.5, causal=True, window=window, cap=cap)
        r = {"fwd_ms": device_ms(lambda: ops.flash_attention_fwd(q, k, v, **kw))}
        if not window and not cap:
            r["sdpa_ms"] = device_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, scale=d ** -0.5, enable_gqa=True))
        if bwd:
            o, lse = ops.flash_attention_fwd(q, k, v, **kw)
            if hasattr(ops, "flash_attention_bwd_preprocess"):   # delta in a kernel of its own
                pre, dq_of = ops.flash_attention_bwd_preprocess, ops.flash_attention_bwd_dq
                delta = pre(o, do)
                r["dq_ms"] = device_ms(lambda: dq_of(q, k, v, do, lse, pre(o, do), **kw))
                r["preprocess_ms"] = device_ms(lambda: pre(o, do))
                r["dq_alone_ms"] = device_ms(lambda: dq_of(q, k, v, do, lse, delta, **kw))
            else:
                delta = ops.flash_attention_bwd_dq(q, k, v, o, do, lse, **kw)[1]
                r["dq_ms"] = device_ms(lambda: ops.flash_attention_bwd_dq(q, k, v, o, do, lse, **kw))
            r["dkv_ms"] = device_ms(
                lambda: ops.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw))
        out[name] = r
    return out


def main() -> int:
    if sys.argv[1:2] == ["--one"]:
        print(json.dumps(time_one(Path(sys.argv[2]).resolve())), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("time_flash: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    for root in sys.argv[1:] or [str(HERE.parents[1])]:
        run = subprocess.run([sys.executable, str(HERE), "--one", root],
                             capture_output=True, text=True)
        if run.returncode:
            print(run.stdout + run.stderr, file=sys.stderr)
            return run.returncode
        times = json.loads(run.stdout.strip().splitlines()[-1])
        print(json.dumps({"root": root, "card": card, **times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
