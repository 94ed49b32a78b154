#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / CUDA port (`src/repro_torch`).

    python3 chip_smoke.py            # from the repository root, one CUDA card

Builds the port's CUDA kernels from `src/repro_torch/kernels/csrc`, holds
each against its plain PyTorch version at the serving shapes, serves the
league's policy nets (tleague-policy-s, tleague-policy-m) through the
InfServer on the card, and checks the card's forward against the port's CPU
forward. Phases print one JSON line each; any failed check raises and the
script exits non-zero. The last line is
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
Without a CUDA device it exits with code 2 and prints no result.

Imports neither jax nor the JAX package `repro`.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_FLOPS = {"float32": 67e12,    # fp32 on the CUDA cores (IEEE, no TF32)
              "bfloat16": 989e12}  # bf16 on the tensor cores, dense
NUM_ACTIONS = 6
OBS_LEN = 26                       # pommerman_lite: 5x5 view + 1 token
ROWS = 256                         # one full flush at max_batch=256
TOL = {"float32": {"rmsnorm": 2e-5, "attention": 1e-4}, "bfloat16": 2e-2}
CARD_VS_CPU_TOL = 1e-4


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def ptxas_summary(log: str):
    """Registers and spill bytes per kernel, from the build's -Xptxas=-v
    output (empty when the library was already built)."""
    out, name, spill = [], None, 0
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            name = m.group(1)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spill = int(m.group(1)) + int(m.group(2))
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            out.append({"kernel": name, "registers": int(m.group(1)), "spill_bytes": spill})
            name = None
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card",
              file=sys.stderr)
        return 2

    import torch.nn.functional as F

    from repro_torch.actors.policy import make_obs_policy
    from repro_torch.configs import get_arch
    from repro_torch.infserver import InfServer
    from repro_torch.kernels import _build, dispatch
    from repro_torch.kernels.flash_attention.ops import flash_attention_fwd
    from repro_torch.kernels.flash_attention.ref import attention_fwd_ref
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.models import init_params
    from repro_torch.utils import tree_map, tree_stack

    import numpy as np

    # -- 1. device ----------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    emit("device", nvidia_smi=smi, kind=kind, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)

    # -- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    emit("build", seconds=build_s, nvcc_seconds=_build.build_seconds,
         sources=[str(p.relative_to(ROOT)) for p in _build.sources()],
         ptxas=ptxas_summary(_build.build_log))

    # -- 3. kernels against their plain versions ------------------------------
    def device_ms(fn, n=20):
        """Median device time of one call, from CUDA events around each of n
        back-to-back calls. A sleep kernel keeps the card busy while the host
        enqueues them, so host launch overhead does not show as device time."""
        fn()
        torch.cuda.synchronize()
        ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(n)]
        torch.cuda._sleep(100_000_000)
        for a, b in ev:
            a.record()
            fn()
            b.record()
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in ev)

    def bound(nbytes, flops, dtype_name):
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = flops / PEAK_FLOPS[dtype_name]
        return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"

    gen = torch.Generator(device=dev).manual_seed(0)
    dname = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
    results = {"rmsnorm": [], "flash_attention_fwd": []}

    # the single flush normalises (256, 26, d) rows with one (d,) weight;
    # the grouped theta + phi flush (2, 128, 26, d) rows with one weight row
    # per model, (2, d)
    rms_cases = [((ROWS * OBS_LEN, 128), 1, torch.bfloat16, "policy-s serving"),
                 ((ROWS * OBS_LEN, 256), 1, torch.bfloat16, "policy-m serving"),
                 ((2, ROWS // 2, OBS_LEN, 128), 2, torch.bfloat16, "policy-s grouped"),
                 ((2, ROWS // 2, OBS_LEN, 256), 2, torch.bfloat16, "policy-m grouped"),
                 ((37, 96), 1, torch.float32, "odd")]
    for (shape, models, dtype, label) in rms_cases:
        d = shape[-1]
        x = torch.randn(*shape, generator=gen, device=dev).to(dtype)
        w = 1.0 + 0.1 * torch.randn(*((models, d) if models > 1 else (d,)),
                                    generator=gen, device=dev)
        err = (rmsnorm(x, w).float() - rmsnorm_ref(x, w).float()).abs().max().item()
        tol = TOL["bfloat16"] if dtype == torch.bfloat16 else TOL["float32"]["rmsnorm"]
        check(err <= tol, f"rmsnorm {label} {shape} {dtype}: err {err} > {tol}")
        ms = device_ms(lambda: rmsnorm(x, w))
        plain_ms = device_ms(lambda: rmsnorm_ref(x, w))
        library_ms = None                     # F.rms_norm takes one weight row
        if models == 1:
            wl = w.to(dtype)
            library_ms = device_ms(lambda: F.rms_norm(x, (d,), wl, 1e-6))
        b_ms, b_by = bound(2 * x.numel() * x.element_size() + w.numel() * 4,
                           4 * x.numel(), "float32")
        r = dict(shape=list(shape), weight_rows=models, dtype=dname[dtype], label=label,
                 max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                 library_ms=library_ms, bound_ms=b_ms, bound_by=b_by)
        results["rmsnorm"].append(r)
        emit("kernel", name="rmsnorm", **r)

    def live_pairs(Tq, Tk, causal, window):
        qp = torch.arange(Tq, device=dev)[:, None]
        kp = torch.arange(Tk, device=dev)[None, :]
        mask = torch.ones(Tq, Tk, dtype=torch.bool, device=dev)
        if causal:
            mask &= kp <= qp
        if window:
            mask &= qp - kp < window
        return int(mask.sum().item())

    flash_cases = [
        # B, H, KV, T, d, dtype, mixed, window, cap, label
        (ROWS, 4, 2, OBS_LEN, 32, torch.bfloat16, False, 0, 0.0, "policy-s serving"),
        (ROWS, 4, 2, OBS_LEN, 32, torch.bfloat16, True, 0, 0.0, "policy-s serving, mixed"),
        (ROWS, 8, 4, OBS_LEN, 32, torch.bfloat16, False, 0, 0.0, "policy-m serving"),
        (ROWS, 8, 4, OBS_LEN, 32, torch.bfloat16, True, 0, 0.0, "policy-m serving, mixed"),
        (3, 4, 2, 37, 64, torch.float32, False, 0, 0.0, "odd T, GQA"),
        (2, 4, 2, 37, 128, torch.float32, False, 0, 0.0, "odd T, GQA, d=128"),
        (2, 8, 2, 37, 256, torch.float32, False, 0, 0.0, "odd T, GQA, d=256"),
        (1, 4, 2, 4096, 32, torch.float32, False, 512, 30.0, "learner seq shape"),
    ]
    for (B, H, KV, T, d, dtype, mixed, window, cap, label) in flash_cases:
        if "serving" in label:
            # the model's layout: (B, T, H, d) activations viewed as (B, H, T, d)
            q = torch.randn(B, T, H, d, generator=gen, device=dev).to(dtype).transpose(1, 2)
            k = torch.randn(B, T, KV, d, generator=gen, device=dev).to(dtype).transpose(1, 2)
            v = torch.randn(B, T, KV, d, generator=gen, device=dev).to(dtype).transpose(1, 2)
        else:
            q = torch.randn(B, H, T, d, generator=gen, device=dev).to(dtype)
            k = torch.randn(B, KV, T, d, generator=gen, device=dev).to(dtype)
            v = torch.randn(B, KV, T, d, generator=gen, device=dev).to(dtype)
        kw = dict(scale=d ** -0.5, causal=True, window=window, cap=cap, mixed=mixed)
        o, lse = flash_attention_fwd(q, k, v, **kw)
        ro, rlse = attention_fwd_ref(q, k, v, **kw)
        err = max((o.float() - ro.float()).abs().max().item(),
                  (lse - rlse).abs().max().item())
        # fp32: 1e-4, looser than tests/test_kernels.py's 2e-5 for fp32
        # forwards because the kernel sums the score and p.V products in
        # another order than the plain version's matmuls
        tol = TOL["bfloat16"] if dtype == torch.bfloat16 else TOL["float32"]["attention"]
        check(err <= tol, f"flash {label}: err {err} > {tol}")
        check(bool(torch.isfinite(o.float()).all()), f"flash {label}: non-finite o")
        ms = device_ms(lambda: flash_attention_fwd(q, k, v, **kw))
        plain_ms = device_ms(lambda: attention_fwd_ref(q, k, v, **kw))
        library_ms = None
        if not window and not cap:
            library_ms = device_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, scale=d ** -0.5, enable_gqa=True))
        nbytes = (q.numel() + k.numel() + v.numel() + o.numel()) * q.element_size() \
            + lse.numel() * 4
        flops = 4 * d * B * H * live_pairs(T, T, True, window)
        b_ms, b_by = bound(nbytes, flops, dname[dtype])
        r = dict(shape=[B, H, KV, T, d], strided=not q.is_contiguous(),
                 dtype=dname[dtype], mixed=mixed, window=window,
                 cap=cap, label=label, max_abs_err=err, tol=tol, ms=ms,
                 plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms, bound_by=b_by)
        results["flash_attention_fwd"].append(r)
        emit("kernel", name="flash_attention_fwd", **r)

    # edge cases the serving shapes do not reach: the RMSNorm scalar path
    # (odd d, misaligned x), and flash attention on strided (B, T, H, d)
    # views with a tail (kv_len), a window that leaves rows with no live key
    # (o = 0, lse = 0), and bidirectional attention with Tq != Tk
    edge = {}
    for d, off in ((33, 0), (64, 1)):
        x = torch.randn(9 * d + off, generator=gen, device=dev)[off:].view(9, d)
        w = torch.randn(d, generator=gen, device=dev)
        edge[f"rmsnorm d={d} offset={off}"] = (
            (rmsnorm(x, w) - rmsnorm_ref(x, w)).abs().max().item(), TOL["float32"]["rmsnorm"])
    for (Tq, Tk, causal, window, kv_len) in ((48, 48, True, 8, 40), (5, 40, False, 0, None)):
        q = torch.randn(2, Tq, 4, 32, generator=gen, device=dev).transpose(1, 2)
        k = torch.randn(2, Tk, 2, 32, generator=gen, device=dev).transpose(1, 2)
        v = torch.randn(2, Tk, 2, 32, generator=gen, device=dev).transpose(1, 2)
        kw = dict(scale=0.2, causal=causal, window=window, cap=30.0 if window else 0.0,
                  kv_len=kv_len)
        o, lse = flash_attention_fwd(q, k, v, **kw)
        ro, rlse = attention_fwd_ref(q, k, v, **kw)
        check(o.stride() == q.stride(), "flash: o not in q's layout")
        edge[f"flash Tq={Tq} Tk={Tk} causal={causal} window={window} kv_len={kv_len}"] = (
            max((o - ro).abs().max().item(), (lse - rlse).abs().max().item()),
            TOL["float32"]["attention"])
    for label, (err, tol) in edge.items():
        check(err <= tol, f"edge case {label}: err {err} > {tol}")
    emit("kernel_edges", max_abs_err={k: e for k, (e, _) in edge.items()})

    # -- 4. serve the policy nets through the InfServer -----------------------
    counters = (rmsnorm, flash_attention_fwd)
    serve = {}
    for c in counters:
        c.launches = 0
    rng = np.random.default_rng(0)
    for arch in ("tleague-policy-s", "tleague-policy-m"):
        cfg = get_arch(arch)
        L = cfg.num_layers
        per_flush = {"rmsnorm": 2 * L + 1, "flash_attention_fwd": L}
        pgen = torch.Generator(device=dev).manual_seed(1)
        theta, phi = init_params(pgen, cfg), init_params(pgen, cfg)
        server = InfServer(cfg, NUM_ACTIONS, theta, max_batch=ROWS)
        server.register_model("phi", phi)
        actors, per_actor = 8, ROWS // 8

        def round_trip(models):
            """Each of 8 actors submits per_actor rows; the last submit fills
            the queue to max_batch and flushes once. Returns results."""
            obs = rng.integers(0, cfg.vocab_size, (actors, per_actor, OBS_LEN)).astype(np.int32)
            before = (rmsnorm.launches, flash_attention_fwd.launches, server.batches_run)
            tickets = [server.submit(obs[i], model=models[i]) for i in range(actors)]
            out = [server.get(t) for t in tickets]
            check(server.batches_run == before[2] + 1, f"{arch}: one flush per round")
            check(rmsnorm.launches - before[0] == per_flush["rmsnorm"],
                  f"{arch}: rmsnorm launches per flush {rmsnorm.launches - before[0]}")
            check(flash_attention_fwd.launches - before[1] == per_flush["flash_attention_fwd"],
                  f"{arch}: flash launches per flush {flash_attention_fwd.launches - before[1]}")
            for a, logp, v in out:
                check(a.shape == (per_actor,) and logp.shape == (per_actor,)
                      and v.shape == (per_actor,), f"{arch}: result shapes")
                check(bool(np.isfinite(logp).all() and np.isfinite(v).all()),
                      f"{arch}: non-finite results")
                check(bool((logp <= 0).all()), f"{arch}: logp > 0")
                check(bool(((a >= 0) & (a < NUM_ACTIONS)).all()), f"{arch}: action range")
            return out

        single = [None] * actors               # all to theta (default route)
        grouped = [None] * 4 + ["phi"] * 4     # theta + phi: grouped flush
        stats = {}
        for name, models in (("single", single), ("grouped", grouped)):
            round_trip(models)                  # warm-up (allocator, cuBLAS handles)
            check(server.last_batch_models == (1 if name == "single" else 2),
                  f"{arch}: {name} flush hosted {server.last_batch_models} models")
            lat, t0 = [], time.perf_counter()
            n_rounds = 20
            for _ in range(n_rounds):
                round_trip(models)
                lat.append(server.last_batch_latency_s)
            wall = time.perf_counter() - t0
            stats[name] = {"median_flush_ms": 1e3 * statistics.median(lat),
                           "rows_per_s": n_rounds * ROWS / wall}

        # hot-swap theta: the same observations give new values
        probe = rng.integers(0, cfg.vocab_size, (per_actor, OBS_LEN)).astype(np.int32)
        v0 = server.get(server.submit(probe))[2]
        v0b = server.get(server.submit(probe))[2]
        check(np.array_equal(v0, v0b), f"{arch}: values not deterministic")
        server.update_params(init_params(pgen, cfg), content_hash="theta-v1", version=1)
        v1 = server.get(server.submit(probe))[2]
        check(float(np.abs(v1 - v0).max()) > 0, f"{arch}: hot-swap left values unchanged")
        server.update_params(theta, content_hash="theta-v1", version=2)
        check(server.swap_noops == 1, f"{arch}: hash-gated swap did not no-op")

        # once more under the bf16 serving mode
        os.environ["REPRO_KERNELS_INFER"] = "bf16"
        try:
            key = "attention|kernel|bf16"
            n0 = dispatch.stats().get(key, 0)
            round_trip(single)
            round_trip(grouped)
            st = server.stats()
            check(st["infer_mode"] == "bf16", f"{arch}: infer_mode {st['infer_mode']}")
            check(st["dispatch"].get(key, 0) - n0 == 2 * L, f"{arch}: no mixed attention")
        finally:
            del os.environ["REPRO_KERNELS_INFER"]
        check(server.stats()["dispatch"].get("attention|reference", 0) == 0,
              f"{arch}: attention went to the reference tier on the card")
        serve[arch] = {k: [round(v["median_flush_ms"], 3), round(v["rows_per_s"])]
                       for k, v in stats.items()}
        emit("serve", arch=arch, rows_per_flush=ROWS, obs_len=OBS_LEN,
             launches_per_flush=per_flush, **stats,
             occupancy=server.stats()["occupancy"], batches_run=server.batches_run)
    launches = {c.__name__: c.launches for c in counters}
    for name, n in launches.items():
        check(n > 0, f"{name} was never launched on the main path")

    # -- 5. card vs CPU at fp32 compute ----------------------------------------
    def perturb_norms(tree, gen):
        """`tree` with every norm scale replaced by 1 + 0.1 * N(0, 1) from `gen`."""
        return {k: (1.0 + 0.1 * torch.randn(v.shape, generator=gen, dtype=v.dtype)
                    if k == "scale" else perturb_norms(v, gen) if isinstance(v, dict) else v)
                for k, v in tree.items()}

    card_vs_cpu = {}
    for arch in ("tleague-policy-s", "tleague-policy-m"):
        cfg = dataclasses.replace(get_arch(arch), compute_dtype="float32")
        cpu_gen = torch.Generator(device="cpu").manual_seed(2)
        # distinct norm scales per model (init sets them all to one), so a
        # grouped forward that read the wrong weight row would disagree
        p_cpu = perturb_norms(init_params(cpu_gen, cfg), cpu_gen)
        p2_cpu = perturb_norms(init_params(cpu_gen, cfg), cpu_gen)
        to_dev = lambda t: tree_map(lambda a: a.to(dev), t)
        obs = torch.from_numpy(rng.integers(0, cfg.vocab_size, (64, OBS_LEN))).long()
        pol = make_obs_policy(cfg, NUM_ACTIONS)
        errs = {}
        with torch.inference_mode():
            lg_c, v_c = pol.logits_values(p_cpu, obs)
            lg_g, v_g = pol.logits_values(to_dev(p_cpu), obs.to(dev))
            errs["single"] = max((lg_g.cpu() - lg_c).abs().max().item(),
                                 (v_g.cpu() - v_c).abs().max().item())
            stacked = tree_stack([p_cpu, p2_cpu])
            obs2 = torch.stack([obs, obs.flip(0)])
            lg_c, v_c = pol.logits_values(stacked, obs2)
            lg_g, v_g = pol.logits_values(to_dev(stacked), obs2.to(dev))
            errs["grouped"] = max((lg_g.cpu() - lg_c).abs().max().item(),
                                  (v_g.cpu() - v_c).abs().max().item())
        card_vs_cpu[arch] = max(errs.values())
        for name, e in errs.items():
            check(e <= CARD_VS_CPU_TOL, f"{arch} card vs CPU ({name}): {e} > {CARD_VS_CPU_TOL}")
        emit("card_vs_cpu", arch=arch, compute_dtype="float32", max_abs_err=errs,
             tol=CARD_VS_CPU_TOL)

    # -- 6. summary --------------------------------------------------------------
    sources = {"rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                           "src/repro/kernels/rmsnorm/kernel.py:25"),
               "flash_attention_fwd": ("src/repro_torch/kernels/csrc/flash_fwd.cu",
                                       "src/repro/kernels/flash_attention/kernel.py:101")}
    kernels = []
    for name, (src, replaces) in sources.items():
        head = results[name][0]               # the policy-s serving shape
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": max(r["max_abs_err"] for r in results[name]),
                        "ms": head["ms"], "plain_ms": head["plain_ms"],
                        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
                        "library_ms": head["library_ms"], "shape": head["shape"],
                        "dtype": head["dtype"]})
    # a short digest first, so a log that keeps only the tail still has it:
    # serve is [median flush ms, rows/s] per flush kind at 256 rows
    emit("summary", card=smi, build_s=round(build_s, 2), nvcc_s=_build.build_seconds,
         serve=serve, card_vs_cpu_max_err=card_vs_cpu)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
