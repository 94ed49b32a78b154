#!/usr/bin/env python3
"""Time the RMSNorm and reverse-scan kernels at the main path's shapes.

    python3 tools/time_norm_scan.py [ROOT ...]

Each ROOT is a checkout of this repository (default: this one). Its
`src/repro_torch` kernels are built and timed in a process of their own,
so a parent tree unpacked under `build/` and this tree can be compared on
one card in turns:

    python3 tools/time_norm_scan.py build/parent . . build/parent

RMSNorm at the policy-s and policy-m serving flushes ((256 x 26, 128) and
(256 x 26, 256) bf16, one weight row), their grouped theta + phi flushes
((2, 128, 26, d) bf16, weights (2, d)), the env step ((512 x 26, 128)
bf16) and the seq step ((4096, 128) fp32), with F.rms_norm beside it
where one weight row applies (a yardstick the port never calls). The
reverse scan at the env step's (32, 16) and the seq step's (1, 4096), fp32.
`launch_floor_ms` is an empty kernel (`torch.cuda._sleep(0)`) timed the
same way: the least any kernel's time can be under this timer. Each time
is the median of 30 CUDA-event-timed calls after a warm-up, with the L2
cache warm. Prints one JSON line per root with the card's name and power
limit. Needs one CUDA card.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve()
# name, x shape, weight rows, dtype
RMSNORM = [("serve_policy_s", (256 * 26, 128), 1, "bfloat16"),
           ("serve_policy_m", (256 * 26, 256), 1, "bfloat16"),
           ("grouped_policy_s", (2, 128, 26, 128), 2, "bfloat16"),
           ("grouped_policy_m", (2, 128, 26, 256), 2, "bfloat16"),
           ("env_step", (512 * 26, 128), 1, "bfloat16"),
           ("seq_step", (4096, 128), 1, "float32")]
SCAN = [("env_step", 32, 16), ("seq_step", 1, 4096)]   # name, B, T (fp32)


def time_one(root: Path) -> dict:
    sys.path.insert(0, str(root / "src"))
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.vtrace_scan.ops import reverse_discounted_scan_p

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
    out = {"launch_floor_ms": device_ms(lambda: torch.cuda._sleep(0)), "rmsnorm": {}, "scan": {}}
    for name, shape, models, dt in RMSNORM:
        dtype, d = getattr(torch, dt), shape[-1]
        x = torch.randn(*shape, generator=gen, device="cuda").to(dtype)
        w = 1.0 + 0.1 * torch.randn(*((models, d) if models > 1 else (d,)), generator=gen,
                                    device="cuda")
        r = {"ms": device_ms(lambda: rmsnorm(x, w))}
        if models == 1:
            wl = w.to(dtype)
            r["f_rms_norm_ms"] = device_ms(lambda: F.rms_norm(x, (d,), wl, 1e-6))
        out["rmsnorm"][name] = r
    for name, B, T in SCAN:
        deltas = torch.randn(B, T, generator=gen, device="cuda")
        decays = 0.99 * torch.rand(B, T, generator=gen, device="cuda")
        init = torch.randn(B, generator=gen, device="cuda")
        out["scan"][name] = {"ms": device_ms(lambda: reverse_discounted_scan_p(deltas, decays, init))}
    return out


def main() -> int:
    if sys.argv[1:2] == ["--one"]:
        print(json.dumps(time_one(Path(sys.argv[2]).resolve())), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("time_norm_scan: needs a CUDA card", file=sys.stderr)
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
