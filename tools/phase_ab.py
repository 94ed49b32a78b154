"""Runs the model paths' phases of one checkout's `chip_smoke.py` on the
card (`decode`, `families` and `train_families`: prefill, decode and
train steps at full width), so that two checkouts can be set side by
side in one call. Each phase prints its own JSON lines (step ms,
peak CUDA MB, launches) as in the whole script; its checks hold as
there.

Usage (from the root of the checkout that holds this file; `--root` the
checkout to run, which builds its own kernels):
  python tools/phase_ab.py --root build/parent
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

PHASES = ("decode_phase", "families_phase", "train_families_phase")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=".")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root / "src"), str(root)]
    os.chdir(root)

    import torch
    if not torch.cuda.is_available():
        print("phase_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
        flash_attention_fwd,
    )
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.vtrace_scan.ops import reverse_discounted_scan_p

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    _build.library()
    counters = (rmsnorm, flash_attention_fwd, flash_attention_bwd_dq,
                flash_attention_bwd_dkv, reverse_discounted_scan_p)
    dev = torch.device("cuda")
    for name in PHASES:
        t0 = time.perf_counter()
        getattr(chip_smoke, name)(dev, counters, smi)
        print(json.dumps({"phase_ab": name, "root": str(root), "card": smi,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
