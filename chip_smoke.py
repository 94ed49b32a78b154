#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / CUDA port (`src/repro_torch`).

    python3 chip_smoke.py            # from the repository root, one CUDA card

Builds the port's CUDA kernels from `src/repro_torch/kernels/csrc` and
drives the port's paths on the card:

- serving: holds the forward kernels (RMSNorm, flash-attention forward)
  against their plain PyTorch versions at the serving shapes, serves the
  league's policy nets (tleague-policy-s, tleague-policy-m) through the
  InfServer, and checks the card's forward against the port's CPU forward;
- learning: holds the learner's kernels (the two flash-attention backward
  kernels, dq with the delta preprocess in its prologue and dk/dv, and the
  reverse scan, forward and closed-form backward) against their plain
  versions at the train steps' shapes, and the optimizer's (AdamW's update
  and the global norm, which replace no TPU kernel) bit for bit against
  the plain body at the learn cells' largest leaf and at policy-s's params
  (the train steps' fp32 functional update), runs 10 env train steps
  (tleague-policy-s, PPO + GAE, 32 x 16 rows of 26-token observations, bf16
  compute) and 3 sequence train steps (V-trace over 4096 tokens, window
  512, softcap 30, fp32, remat), and checks step 1 on the card against the
  port's CPU step at fp32 compute;
- league: the learner's side of the league loop (paper §3.2). A Learner
  trains tleague-policy-s (bf16 compute) for 10 iterations from a blocking
  DataServer on the card, each on a 32 x 16 segment whose actions, logp and
  values the InfServer served; each learn step pushes theta to the
  ModelPool and the InfServer hot-swaps it in through a CachedPuller. Then
  the learning period ends and one more iteration runs on the new key.
  Checks: staged batches bitwise equal to the ring rows, a prefetch hit per
  step, the hosted version and content hash, served logp and values against
  the CPU's plain forward on the Learner's params, NotModified on an
  unchanged pull, a zero-byte cross-key adopt of the new key, fresh
  moments, and exactly an env step's launches per learn step and a
  flush's per segment served; then the loop again with a producer thread
  putting while the previous step runs (prefetch on and off), and two
  fp32 iterations on the card against the same on the CPU;
- envs: rps, duel and pommerman_lite at 256 slots, 64 steps on the card
  and on the CPU from one state, bitwise; env-step ms at 16, 64, 256 slots;
- actors: an Actor on pommerman_lite (16 envs x unroll 16, policy-s, bf16
  compute), local (2T + 1 forwards per segment, one segment's T steps
  under `set_sync_debug_mode("error")`, logp and values against the CPU's
  plain forward) and served (T + 1 coalesced flushes per segment);
- league_loop: `examples/quickstart.py`'s loop (Actor -> DataServer ->
  Learner -> freeze -> payoff), 2 periods x 8 iterations;
- runtime: `build_runtime` with `examples/league_specs/main_minimax.json`'s
  two roles under a step gate of 4, to 2 freezes per role: local actors
  with the DataServer's prefetch on and off, then served actors, each
  launching exactly its learner steps' and its segments' or flushes'
  kernels; `learn()` wall with prefetch on and off;
- checkpoint: the Learner's θ on the card saved and loaded on the CPU,
  bitwise;
- transport: an on-card InfServer, a DataServer and a ModelPool behind
  one `RpcServer`: a 256-row flush over RPC equal to the in-process one,
  θ pushed from the card and pulled back bitwise (under this machine's
  codec and under pickle) with the in-process pool's manifest hashes; the
  round trip, the pulls and a segment's `put_when_room` timed;
- multiprocess: `python -m repro_torch.launch.train --workers W` (W = 2
  with local actors, 2 served), to 16 learner steps per role under
  a step gate of 8, no actor respawned: a clean shutdown with no actor
  restarted and no segment dropped, every learner froze, and every
  process (coordinator, learners, actors) on the card with exactly its
  learner steps', segments' or flushes' launches, read from the JSON line
  each prints; the league's rate once every learner has stepped;
- fleet: `serve_fleet(2)`: two replica processes behind a ServingGateway,
  a probe per lineage against the CPU's plain forward, both replicas
  serving with exactly their flushes' launches, rows/s in warm windows
  alternated with one in-process InfServer's;
- faults: the league under real faults, the port's four fault smokes
  (`tests/smoke_torch_*.py --device cuda`) as subprocesses: the shm ring's
  producer kill -9'd mid-stream (its segment gone within 10 s, a fresh
  client bit-exact) beside the kill-coordinator smoke (the coordinator
  SIGSTOP'd, its learner and actor out through the heartbeat timeout with
  exit 0), then chaos (collector_smoke.json's league under a seeded
  FaultPlan: two actors and the pool replica SIGKILLed, a third actor
  SIGSTOP'd past the stale threshold; reaped, re-issued and a late result
  dropped, the target reached) and serving (a 3-replica fleet, the
  busiest replica kill -9'd: availability, the 2 s bucket's hit rate and
  p99); every child that reported ran on the card, each learner launched
  all five kernels;
- examples: `examples/torch_{quickstart,rps_nash,pommerman_league,
  serve_policy}.py` through their `main(argv)` on the card: quickstart's
  launches exactly its steps' and segments', rps_nash's distributions,
  the Fig. 4 win rate lockstep and async, gemma2's reduced decode and the
  batched InfServer;
- decode: the dense family's serving path at full width: gemma2-2b and
  qwen3-8b at full depth (bf16 compute over fp32 params), command-r-35b at
  full depth and mistral-large-123b at 20 of 88 layers (bf16 params): the
  decode demo (`launch.serve.serve`; gemma2 and qwen3), prefill of 4 x 1024
  tokens and greedy KV-cache decode steps with exactly their launches
  (RMSNorm 105 / 145 / 0 / 41 per prefill and per step, command-r's norms
  being LayerNorms; the flash forward once per layer per prefill and none
  per step),
  a step with no host sync, decode against forward_train at fp32, gemma2's
  sliding ring (a 4608-token prompt) and long_500k state, the InfServer
  over the gemma2 backbone, and one repeat unit card vs CPU;
- families: the moe, ssm, hybrid and vlm families at full width, one arch
  at a time: qwen3-moe-235b-a22b (4 of 94 layers), kimi-k2-1t-a32b (its
  dense prefix and 1 MoE layer of 61), rwkv6-3b and hymba-1.5b (4 of 32
  layers; their decode demo at full depth) and pixtral-12b (full depth,
  with the decode demo), prefill of
  4 x 1024 tokens (pixtral's after 1024 patch embeddings; rwkv6's and
  hymba's cut to 4 x 256: their scans are loops over time) and greedy
  decode steps with exactly their launches, a step with no host sync (MoE
  routing included), the MoE choices dropped at prefill, long_500k steps
  for hymba (its ring) and rwkv6 (its O(1) state), decode against
  forward_train (rwkv6's also at fp64 compute, a rounding witness), and
  one unit card vs CPU with equal routing slots (kimi-k2's: its dense
  prefix and one MoE layer, the experts cut to 16);
- audio: hubert-xlarge at full width and depth (48 layers, d 1280, 16
  heads of 80, bidirectional): `prefill` over 1 x 32,768 frame embeddings
  (prefill_32k, batch cut from 32), `build_mlm_train_step` on 4 x 4,096
  frames under a seeded HuBERT mask (train_4k, batch cut from 256), each
  with exactly its launches and profiled, and one layer card vs CPU
  (prefill, and a masked-unit step's loss, masked_acc and every grad);
- train_families: `build_seq_train_step` (PPO + GAE, adamw with fp32
  master params for bf16 params, updated in place) for qwen3-moe (1
  layer), rwkv6 and hymba (2 layers, T = 256), pixtral (2 layers, 1,024
  patches + 1,024 tokens) and gemma2-2b (full depth, 4 x 1,024): exact
  launches, finite grads, a falling loss over 3 steps on one batch, one
  unit card vs CPU (loss and every grad leaf);
- mesh: the mesh on a (1, 1) NCCL DeviceMesh of the card
  (`launch.mesh.make_local_mesh()`): the sharded InfServer at policy-s
  (`repro`'s local-mesh sequence at fp32 against the unsharded server,
  flush ms sharded and unsharded), `launch.steps.make_dryrun_step`'s train
  step for qwen3-8b at full width (2 of 36 layers, 1 x 4,096 tokens, DTensor
  params: loss and grads at fp32 against the unsharded step, then the
  whole step at bf16 with adamw on the DTensors), and `moe_apply_ep` on
  qwen3-moe's MoE layer (128 experts, 4 x 1,024 tokens) against
  `moe_apply`, and the factory's prefill and decode fns (tensor-parallel
  serving) for command-r-35b at full width (2 of 40 layers) bitwise
  against the unsharded prefill and decode; one more bf16 step under the
  per-rank counter, its FLOPs, collectives and peak held against the
  dry-run's count of the same step (made by a subprocess started with the
  script, `DryrunHolds`). The multiprocess phase's
  served run is `--served --sharded`, its InfServer on a (1, 1) mesh of the
  coordinator's card;
- mesh_split: `tools/mesh_two_ranks.py --split`, two gloo ranks of the
  card on a (1, 2) mesh: rwkv6-3b (each rank 20 of the 40 heads) and
  hymba-1.5b (each rank 1,600 of the 3,200 Mamba channels) prefill 4 x 256
  and 4 decode steps at full width, 2 layers, fp32, through the factory's
  fns, and one qwen3-moe unit (64 of the 128 experts a rank, no
  `moe_ep`) forward and backward on 4 x 1,024 tokens, each within 1e-4 of
  one rank's run, each rank's state bytes printed; rwkv6-3b's prefill
  under the per-rank counter in each rank, its FLOPs and collectives by
  kind equal to the dry-run's; a refused collective, a timeout or a
  missing case fails the run. Each rank's launches are the kernel line's
  `mesh_split` path.

- latent attention (the `mla` phase, after the families' train steps):
  the (192, 128) flash kernels (q and k 192 wide, v 128) at the benchmark
  cell's shape against their plain versions one head at a time, timed,
  and kimi-k2-instruct's train step at the cell's stage (6 layers, 8 of
  384 experts held, 1 x 8192 tokens, V-trace, remat), whose launches are
  those kernels' rows of the kernel line.

Phase 3 and 3b also hold the flash kernels at head dim 80 (hubert's train
shape in bf16, the fp32 regime at T = 1,024), the forward at G = 12
(mistral's prefill), RMSNorm at d = 12,288 and the backward at G = 16, 8
and 5 against their plain versions.

Each path runs with the kernels' launch counts set to 0 just before it and
read just after; a kernel of the path that was never launched fails the
run. A train step's launches include the optimizer's: one AdamW update a
leaf, and one norm launch a leaf and the norm's finish. Phases print one JSON line each (among them `launch_floor`: an empty
kernel timed as the kernels are); any failed check raises and the script
exits non-zero. The line before the last lists every kernel with its
time, bound and launches; the last line is
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
Without a CUDA device it exits with code 2 and prints no result.

Imports neither jax nor the JAX package `repro`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.append(str(ROOT / "tests"))           # torch_smoke_lib: process plumbing

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_FLOPS = {"float32": 67e12,    # fp32 on the CUDA cores (IEEE, no TF32)
              "bfloat16": 989e12}  # bf16 on the tensor cores, dense
NUM_ACTIONS = 6
OBS_LEN = 26                       # pommerman_lite: 5x5 view + 1 token
ROWS = 256                         # one full flush at max_batch=256
TOL = {"float32": {"rmsnorm": 2e-5, "attention": 1e-4}, "bfloat16": 2e-2}
CARD_VS_CPU_TOL = 1e-4
# backward kernels: of max(1, max |plain|), so long sums are held relative
# to their size; bf16 outputs round once
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
SCAN_TOL = 1e-5                    # of max |y|: the kernel reassociates the recurrence
ENV_B, ENV_T = 32, 16              # 16 envs x team_size 2, unroll 16 (launch/train.py)
SEQ_T = 4096                       # benchmarks/run.py's sequence-scale learner shape
ENV_STEPS, SEQ_STEPS = 10, 3
# the actors' and the league runtime's paths: pommerman_lite at
# launch/train.py's defaults (16 envs, unroll 16), so a segment is the
# learner's ENV_B x ENV_T batch
ACT_E, ACT_T = ENV_B // 2, ENV_T
ACT_SEGMENTS = 6
ENV_SLOTS = (16, 64, 256)          # env-step timing; the card-vs-CPU check runs at 256
ENV_CHECK_STEPS, ENV_TIMED_STEPS = 64, 20
ENV_REWARD_TOL = 1e-6
LOOP_PERIODS, LOOP_ITERS = 2, 8    # examples/quickstart.py's loop
# the runtime's step gate cut from 8 to 4 for the script's time: the same
# 2 freezes per role at half the learner steps (so is its profiled run)
RUNTIME_STEP_GATE, RUNTIME_FREEZES = 4, 2
RUNTIME_MAX_S = 300.0
# the league across processes: the transport in one process, the
# multiprocess league as `launch.train --workers W` runs it, the fleet
TRANSPORT_SEGMENT_ROWS = 2 * ACT_E
TRANSPORT_FLUSHES, TRANSPORT_RTT_CALLS, TRANSPORT_PULLS, TRANSPORT_PUTS = 20, 200, 10, 8
# (actor processes, served); the served run's InfServer is mesh-sharded
# (`--sharded`: a (1, 1) mesh of the card). The W = 4 run is cut for the
# script's time (the faults phase runs 4-actor leagues)
MP_RUNS = ((2, False), (2, True))
MP_STEPS, MP_STEP_GATE, MP_TIMEOUT_S = 16, 8, 300.0
FLEET_REPLICAS, FLEET_ROUNDS, FLEET_ROWS = 2, 50, 64
# rows/s through the warm fleet and through one in-process InfServer,
# alternated: windows of rounds of FLEET_REPLICAS x FLEET_ROWS rows each
FLEET_WINDOWS, FLEET_WINDOW_ROUNDS = 3, 200
FLEET_DEADLINE_MS = 250.0                      # serve_fleet's default
# the decode path: the dense archs at full width in the configs' own
# dtypes (gemma2-2b and qwen3-8b: bf16 compute over fp32 params, full
# depth; command-r-35b and mistral-large-123b: bf16 params), seeded
# params; arch -> (greedy steps, layers or None for full depth).
# mistral's depth is cut to fit the card: 88 layers of 1.384 B params hold
# 245 GB in bf16, 20 of them 55.4 GB, with 1.61 GB of untied embed and
# lm_head. command-r at its 40 layers holds 30.3 B params, 60.6 GB.
DECODE_B, DECODE_T = 4, 1024                   # prompts longer than prefill's reserve (64)
DECODE_ARCHS = {"gemma2-2b": (32, None), "qwen3-8b": (16, None),
                "command-r-35b": (16, None), "mistral-large-123b": (16, 20)}
# the archs that also run the decode demo (`launch.serve.serve`, which
# draws its own params) and the one-unit card-vs-CPU check; the others'
# params take most of the card, and their CPU unit 16-26 s of the
# script's time (command-r's 256,000-wide tied head on the host)
DECODE_EXTRAS = ("gemma2-2b", "qwen3-8b")
DECODE_PREFILLS = 3                            # timed prefills, after one warm-up
SLIDING_T, SLIDING_STEPS = 4608, 16            # past gemma2's 4096 window
LONG_STEPS = 16                                # long_500k: O(window) state
DECODE_CPU_B, DECODE_CPU_T, DECODE_CPU_STEPS = 2, 80, 4
CONSISTENCY_TOL = 1e-3                         # of max(1, max |logits|)
# the families phase: qwen3-moe-235b-a22b, kimi-k2-1t-a32b (depth cut to
# fit the card: 4 of 94 layers; the dense prefix and 1 MoE layer of 61),
# rwkv6-3b and hymba-1.5b (depth cut to 4 of 32 layers for the script's
# time: their host-bound loops over time cost in proportion to depth) and
# pixtral-12b at full depth; full width, seeded, the configs' own dtypes;
# DECODE_B prompts of DECODE_T tokens (pixtral's after PATCHES patch
# embeddings; FAMILY_PROMPT's for rwkv6 and hymba), FAMILY_STEPS greedy
# steps
FAMILY_DEPTH = {"qwen3-moe-235b-a22b": 4, "kimi-k2-1t-a32b": 2, "rwkv6-3b": 4,
                "hymba-1.5b": 4, "pixtral-12b": None}
PATCHES = 1024                                 # configs/pixtral_12b.py NUM_PATCHES
# rwkv6's and hymba's prompts are cut to 256 tokens: their scans are
# Python loops over time (~5 eager ops per token per layer), so a 4 x 1024
# prefill takes seconds and the phase minutes
FAMILY_PROMPT = {"rwkv6-3b": 256, "hymba-1.5b": 256}
# the archs whose decode demo (`launch.serve.serve`) runs at full depth
# although the rest of their phase runs at FAMILY_DEPTH's cut
FAMILY_DEMO = ("rwkv6-3b", "hymba-1.5b")
FAMILY_STEPS = 16
# decode vs forward_train for the MoE archs: a prompt short enough that no
# choice is dropped (capacity grows with the token count, so both runs
# must drop none). The capacity is at least top-k (8) and an expert takes
# at most one choice per token, so up to 8 tokens a run cannot drop; at
# 2 x 16 the seeded qwen3-moe routes unevenly enough to drop choices.
# kimi-k2's at bf16 compute (fp32 would copy its 33.8 GB of experts to
# fp32), within BF16_CONSISTENCY_TOL
MOE_CONS_B, MOE_CONS_T = 1, 7
BF16_CONSISTENCY_TOL = 2e-2
STATE_TOL = 1e-5                               # card vs CPU, recurrent and cache states
# kimi-k2's card-vs-CPU unit: its dense prefix and one MoE layer at full
# width, the experts cut from 384 to 16 (top-8 of 16) so that the CPU holds
# the unit (~3.9 B params, bf16)
KIMI_CPU_EXPERTS = 16
# the audio path: hubert-xlarge at full width and depth (48 layers, d 1280,
# 16 heads of 80; fp32 params, bf16 compute), seeded. prefill_32k's length
# with its batch cut from 32 to 1; train_4k's length with its batch cut
# from 256 to 4 and the HuBERT mask (arXiv:2106.07447, after wav2vec 2.0):
# span starts drawn at p = 0.08, spans of 10 frames
AUDIO_PREFILL_B, AUDIO_PREFILL_T = 1, 32768
AUDIO_PREFILLS = 2                             # timed, after one warm-up
AUDIO_B, AUDIO_T = 4, 4096
AUDIO_MASK_P, AUDIO_MASK_SPAN = 0.08, 10
AUDIO_STEPS = 3                                # timed, after one warm-up
AUDIO_CPU_B, AUDIO_CPU_T = 2, 128              # card vs CPU, one full-width layer
# the families' train steps (build_seq_train_step: PPO + GAE, remat,
# adamw(3e-4, clip_norm=1.0, master_fp32 for bf16 params), updated in
# place): full width, the depth cut to fit one card; arch -> (layers, or
# None for full depth, batch, tokens, patch embeddings first)
TRAIN_FAMILIES = {"qwen3-moe-235b-a22b": (1, 1, 1024, 0), "rwkv6-3b": (2, 4, 256, 0),
                  "hymba-1.5b": (2, 4, 256, 0), "pixtral-12b": (2, 4, 1024, PATCHES),
                  "gemma2-2b": (None, 4, 1024, 0)}
TRAIN_STEPS = 3                                # timed, after one step on the same batch
# the descent check's linear warmup: repro's launch optimizer (constant
# 3e-4) makes a first Adam step that moves PPO's ratio by 10^3 or more at
# these widths (in both packages), so the loss may rise before it falls
TRAIN_WARMUP = 100
TRAIN_CPU_B, TRAIN_CPU_T, TRAIN_CPU_PATCHES = 2, 64, 16   # card vs CPU, one unit
# q is drawn at this scale in the gemma2 flash rows: scores of std ~8 reach
# the softcap of 50, so dropping the cap moves o and lse past the tolerance
GEMMA2_Q_SCALE = 8.0
INF_REQUESTS, INF_OBS_LEN = 32, 8              # examples/serve_policy.py step 3
# a plain version this slow (at the prefill shapes: hubert's 0.57 s, the
# scan's 0.1 s) is timed over SLOW_CALLS calls, not 20; kernels and library
# calls always over 20
SLOW_CALL_S, SLOW_CALLS = 0.05, 5
# the optimizer's kernels (csrc/adamw.cu) replace no TPU kernel; timed at the
# learner cells' largest leaf, mistral-large's stacked FFN weight at 2 layers
OPT_LEAF = 2 * 12288 * 28672
# latent attention's kernels (q and k 192 wide, v 128) and the train step
# that runs them: kimi-k2-instruct at the benchmark cell's stage (6 of 61
# layers, 8 of 384 experts held, 20,480 of 163,840 vocabulary rows) on one
# 1 x 8192-token unroll; the kernels at that step's attention shape
MLA_LAYERS, MLA_HELD, MLA_VOCAB, MLA_T = 6, 8, 20480, 8192
MLA_STEPS = 3                                  # timed, after one warm-up step
MLA_KERNELS = {  # the kernel line's row -> (wrapper, CUDA source, dk/dv design)
    "flash_fwd_bf16_dv<192, 128>": ("flash_attention_fwd",
                                    "src/repro_torch/kernels/csrc/flash_fwd.cu", None),
    "bwd_dq_bf16_dv<192, 128>": ("flash_attention_bwd_dq",
                                 "src/repro_torch/kernels/csrc/flash_bwd.cu", None),
    "bwd_dkv_wgmma<192, 128>": ("flash_attention_bwd_dkv",
                                "src/repro_torch/kernels/csrc/flash_bwd.cu", "wgmma"),
    "bwd_dkv_bf16_dv<192, 128>": ("flash_attention_bwd_dkv",
                                  "src/repro_torch/kernels/csrc/flash_bwd.cu", "mma_sync"),
}
# (B, H, KV, T) below one 128-key tile, where the (192, 128) dk/dv keeps
# its mma.sync kernel (G = 4)
MLA_SHORT = (2, 4, 1, 77)
# the dense learn cells' attention (mistral-large-123b: 96 query heads on 8
# KV heads of 128, causal, bf16): label -> (batch, unroll); the dk/dv kernel
# takes its warpgroup-MMA design there, as at MLA_T (the mla phase)
DKV_CELLS = {"mistral-large b1-t8192": (1, 8192), "mistral-large b4-t2048": (4, 2048)}
DKV_H, DKV_KV, DKV_D = 96, 8, 128
SOURCES = {  # kernel -> (CUDA source, the TPU kernel it replaces)
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm/kernel.py:25"),
    "flash_attention_fwd": ("src/repro_torch/kernels/csrc/flash_fwd.cu",
                            "src/repro/kernels/flash_attention/kernel.py:101"),
    "flash_attention_bwd_preprocess": ("src/repro_torch/kernels/csrc/flash_bwd.cu",
                                       "src/repro/kernels/flash_attention/kernel.py:204"),
    "flash_attention_bwd_dq": ("src/repro_torch/kernels/csrc/flash_bwd.cu",
                               "src/repro/kernels/flash_attention/kernel.py:254"),
    "flash_attention_bwd_dkv": ("src/repro_torch/kernels/csrc/flash_bwd.cu",
                                "src/repro/kernels/flash_attention/kernel.py:323"),
    "reverse_discounted_scan_p": ("src/repro_torch/kernels/csrc/reverse_scan.cu",
                                  "src/repro/kernels/vtrace_scan/kernel.py:36"),
}


def optimizer_kernels(dev, device_ms, bound):
    """AdamW's update and the global norm at OPT_LEAF elements (704.6 M) as
    the benchmark's learn cells run them: bf16 grad and param, fp32 master
    and moments, clip, in place (~20 GB of state at the peak). One step of
    the kernel, into fresh outputs, against the plain body in 2^24-element
    slices (the in-place CPU path, which the card ran before the kernels):
    bit for bit; the kernel's norm within 1e-6 of `tree_global_norm`. ms of
    each kernel, of the plain body and of one library call (the port never
    calls it): `torch.optim.AdamW(fused=True)` on an fp32 param, which also
    moves 28 bytes a param, and `torch.linalg.vector_norm`; the bytes bound.
    Returns {kernel: record}."""
    import torch

    from repro_torch.kernels import cost
    from repro_torch.kernels.adamw import adamw_update, global_norm
    from repro_torch.kernels.adamw.ops import _SLICE_ELEMS
    from repro_torch.kernels.adamw.ref import adamw_ref
    from repro_torch.utils import tree_global_norm

    n = OPT_LEAF
    gen = torch.Generator(device=dev).manual_seed(9)
    g = (1e-4 * torch.randn(n, generator=gen, device=dev)).to(torch.bfloat16)
    p = torch.randn(n, generator=gen, device=dev).to(torch.bfloat16)
    master = p.float()
    m = 1e-5 * torch.randn(n, generator=gen, device=dev)
    v = 1e-10 * torch.rand(n, generator=gen, device=dev)
    scal = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    k = dict(scale=scal(0.5), lr=scal(3e-6), bc1=1 - 0.9 ** scal(2.0), bc2=1 - 0.999 ** scal(2.0))
    hyper = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0)
    slices = [slice(i, i + _SLICE_ELEMS) for i in range(0, n, _SLICE_ELEMS)]

    def plain(s):
        return adamw_ref(g[s], m[s], v[s], master[s], k["scale"], k["lr"], k["bc1"], k["bc2"],
                         **hyper)

    out = (torch.empty_like(m), torch.empty_like(v), torch.empty_like(master), torch.empty_like(p))
    adamw_update(g, m, v, master, out, **k, **hyper)
    differ = 0
    for s in slices:
        nm, nv, nb = plain(s)
        differ += int(not (torch.equal(nm, out[0][s]) and torch.equal(nv, out[1][s])
                           and torch.equal(nb, out[2][s]) and torch.equal(nb.to(p.dtype), out[3][s])))
    check(differ == 0, f"adamw_update at {n} elements: {differ} of {len(slices)} slices "
                       f"differ from the plain body")
    del out

    def plain_step():
        for s in slices:
            m[s], v[s], new = plain(s)
            master[s] = new
            p[s] = new.to(p.dtype)

    inplace = (m, v, master, p)
    upd_ms = device_ms(lambda: adamw_update(g, m, v, master, inplace, **k, **hyper))
    upd_plain_ms = device_ms(plain_step, plain=True)
    upd_bound = bound(cost.adamw(g, m, v, master, inplace, **k, **hyper), "float32")

    norm, want = global_norm([g], 1.0)[0].item(), tree_global_norm([g]).item()
    norm_err = abs(norm - want) / want
    check(norm_err <= 1e-6, f"global_norm at {n} elements: {norm_err} of the plain norm")
    norm_ms = device_ms(lambda: global_norm([g], 1.0))
    norm_plain_ms = device_ms(lambda: tree_global_norm([g]), plain=True)
    norm_lib_ms = device_ms(lambda: torch.linalg.vector_norm(g, dtype=torch.float32))
    norm_bound = bound(cost.global_norm([g]), "float32")
    del g, p, master, m, v, inplace

    w = torch.nn.Parameter(torch.randn(n, generator=gen, device=dev))
    w.grad = 1e-4 * torch.randn(n, generator=gen, device=dev)
    lib = torch.optim.AdamW([w], lr=3e-6, weight_decay=0.0, fused=True)
    upd_lib_ms = device_ms(lib.step)
    del w, lib
    torch.cuda.empty_cache()
    shape = [n]
    recs = {"adamw_update": dict(ms=upd_ms, plain_ms=upd_plain_ms, library_ms=upd_lib_ms,
                                 bound_ms=upd_bound[0], bound_by=upd_bound[1], max_abs_err=0.0,
                                 dtype="bfloat16 grad and param, fp32 master and moments"),
            "global_norm": dict(ms=norm_ms, plain_ms=norm_plain_ms, library_ms=norm_lib_ms,
                                bound_ms=norm_bound[0], bound_by=norm_bound[1],
                                max_abs_err=norm_err, dtype="bfloat16 grad")}
    recs["adamw_update"]["policy_s_fp32_functional"] = policy_update_check(dev)
    for name, r in recs.items():
        r.update(shape=shape, label="learn cells' largest leaf")
        emit("kernel", name=name, **r)
    return recs


def policy_update_check(dev):
    """The env and seq train steps' own update at policy-s's params:
    `adamw(3e-4, clip_norm=1.0)`, fp32, functional, its second step (the
    moments not 0) with the clip in force, against the plain body on the
    card with the kernel's clip scale: params and moments bit for bit; the
    norm the same from the wrapper called again, within 1e-6 of
    `tree_global_norm`. Returns what was held."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels.adamw import global_norm
    from repro_torch.kernels.adamw.ref import adamw_ref
    from repro_torch.models import init_params
    from repro_torch.optim import adamw
    from repro_torch.utils import tree_global_norm, tree_leaves, tree_map

    gen = torch.Generator(device=dev).manual_seed(10)
    params = init_params(gen, get_arch("tleague-policy-s"))
    check(all(p.dtype == torch.float32 for p in tree_leaves(params)),
          "policy-s update: the params are not fp32")
    grad = lambda p: 1e-2 * torch.randn(p.shape, generator=gen, device=dev)
    opt = adamw(3e-4, clip_norm=1.0)
    state = opt.init(params)
    params, state, _ = opt.update(tree_map(grad, params), state, params)
    grads = tree_map(grad, params)
    new_params, new_state, metrics = opt.update(grads, state, params)
    norm, scale = global_norm(tree_leaves(grads), 1.0)
    want = tree_global_norm(grads)
    norm_err = abs(norm.item() - want.item()) / want.item()
    check(torch.equal(norm, metrics["grad_norm"]) and norm_err <= 1e-6,
          f"policy-s update: norm {metrics['grad_norm'].item()}, again {norm.item()}, "
          f"plain {want.item()}")
    check(scale.item() < 1.0, f"policy-s update: the clip is not in force ({scale.item()})")
    step = (state["step"] + 1).float()
    k = dict(lr=metrics["lr"], bc1=1 - 0.9 ** step, bc2=1 - 0.999 ** step)
    differ = 0
    for g, m, v, p, m1, v1, p1 in zip(*(tree_leaves(t) for t in (
            grads, state["mu"], state["nu"], params, new_state["mu"], new_state["nu"],
            new_params))):
        nm, nv, nb = adamw_ref(g, m, v, p, scale, k["lr"], k["bc1"], k["bc2"], b1=0.9,
                               b2=0.999, eps=1e-8, weight_decay=0.0)
        differ += int(not (torch.equal(nm, m1) and torch.equal(nv, v1) and torch.equal(nb, p1)))
    leaves = len(tree_leaves(params))
    check(differ == 0, f"policy-s update: {differ} of {leaves} leaves differ from the plain body")
    return {"leaves": leaves, "params": sum(p.numel() for p in tree_leaves(params)),
            "leaves_differing": differ, "norm_rel_err": norm_err, "clip_scale": scale.item()}


def optimizer_launches(params):
    """An adamw step's launches over the param tree `params` (plain or
    DTensor leaves, each with elements): one update a leaf, and one norm
    launch a leaf and the norm's finish."""
    from repro_torch.utils import tree_leaves
    n = len(tree_leaves(params))
    return {"adamw_update": n, "global_norm": n + 1}


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


def rel_err(got, want) -> float:
    """max |got - want| over max(1, max |want|), in fp32 (fp64 where either
    is fp64)."""
    import torch
    dt = torch.float64 if torch.float64 in (got.dtype, want.dtype) else torch.float32
    want = want.to(dt)
    return ((got.to(dt) - want).abs().max() / max(1.0, want.abs().max().item())).item()


def seq_config(get_arch):
    """tleague-policy-s as benchmarks/run.py trains it at sequence scale:
    every layer local with window 512, softcap 30, fp32 compute."""
    return dataclasses.replace(get_arch("tleague-policy-s"), sliding_window=512,
                               attn_logit_softcap=30.0, layer_pattern=("local",),
                               compute_dtype="float32", max_position=8192)


def env_batch(rng, B, T, dev):
    """One on-policy segment: B rows of T steps of 26-token observations."""
    import torch
    return {k: torch.from_numpy(v).to(dev) for k, v in {
        "obs": rng.integers(0, 16, (B, T, OBS_LEN)).astype(np.int64),
        "actions": rng.integers(0, NUM_ACTIONS, (B, T)).astype(np.int64),
        "behavior_logp": (-np.abs(rng.normal(size=(B, T))) - 1.0).astype(np.float32),
        "behavior_values": rng.normal(size=(B, T)).astype(np.float32),
        "rewards": rng.normal(size=(B, T)).astype(np.float32),
        "done": rng.random((B, T)) < 0.05,
        "bootstrap_value": rng.normal(size=(B,)).astype(np.float32)}.items()}


def seq_batch(rng, T, vocab, dev, B=1):
    """B T-token trajectories whose actions are tokens (V-trace, PPO)."""
    import torch
    return {k: torch.from_numpy(v).to(dev) for k, v in {
        "tokens": rng.integers(0, vocab, (B, T)).astype(np.int64),
        "actions": rng.integers(0, vocab, (B, T)).astype(np.int64),
        "behavior_logp": (-np.abs(rng.normal(size=(B, T))) - 6.0).astype(np.float32),
        "behavior_values": rng.normal(size=(B, T)).astype(np.float32),
        "rewards": rng.normal(size=(B, T)).astype(np.float32),
        "discounts": (0.99 * (rng.random((B, T)) >= 0.01)).astype(np.float32),
        "bootstrap_value": rng.normal(size=(B,)).astype(np.float32)}.items()}


def hubert_mask(rng, B, T):
    """HuBERT's mask: each frame starts a span with probability
    AUDIO_MASK_P, and a span masks AUDIO_MASK_SPAN frames from its start."""
    starts = rng.random((B, T)) < AUDIO_MASK_P
    mask = np.zeros((B, T), dtype=bool)
    for s in range(AUDIO_MASK_SPAN):
        mask[:, s:] |= starts[:, :T - s]
    return mask


def grads_only():
    """An optimizer that changes nothing and returns the grads it was fed
    among its metrics: a train step's loss and grads, with no optimizer
    memory (the card-vs-CPU checks of full-width units)."""
    from repro_torch.optim import Optimizer
    return Optimizer(lambda params: {}, lambda grads, state, params: (params, state,
                                                                      {"grads": grads}))


def with_grads(opt):
    """`opt` that also returns the grads it was fed, among its metrics."""
    from repro_torch.optim import Optimizer

    def update(grads, state, params):
        p, st, m = opt.update(grads, state, params)
        return p, st, {**m, "grads": grads}
    return Optimizer(opt.init, update)


def league_loop(dev, cfg, theta0, iters, segments=None, freeze=False, on_iter=None,
                producer=False, prefetch=True):
    """The learner's side of the league loop (paper §3.2) on `dev`: a
    ModelPool and a LeagueMgr with one self-play PFSP agent, a Learner over a
    blocking DataServer, and an InfServer that hosts the current key through
    a CachedPuller. Each iteration takes a segment (made here from the
    InfServer's answers for seeded observations, as a served actor would,
    unless `segments` gives it), puts it, learns one step, and pulls the new
    theta into the InfServer. With `freeze`, the agent's learning period then
    ends and one more iteration runs on the new key. With `producer`, a
    thread of its own puts the given segments, each as soon as the Learner
    has taken the previous one, so the put and its staging run while the
    previous step does, as an actor thread's would; `prefetch` is the
    DataServer's (without it a batch is staged when the Learner asks for
    it). `on_iter(state, when)` runs after each iteration's learn and again
    after its refresh. Returns the state (league, learner, server, puller,
    metered pool, segments, metrics, and the InfServer flushes that served
    segments)."""
    import threading

    import torch

    from repro_torch.core import LeagueMgr, SelfPlayPFSPGameMgr
    from repro_torch.infserver import InfServer
    from repro_torch.learners import DataServer, Learner, build_env_train_step
    from repro_torch.optim import adamw
    from repro_torch.params import CachedPuller, NotModified
    from repro_torch.utils import tree_flatten_with_path, tree_leaves

    class Metered:
        """The pool's pull surface, recording each answer and the param
        bytes it ships (hash references and NotModified ship none)."""

        def __init__(self, pool):
            self.pool, self.last, self.bytes = pool, None, 0

        def pull_if_changed(self, key, have_version=None, copy=None, have_hashes=None):
            r = self.pool.pull_if_changed(key, have_version, copy=copy, have_hashes=have_hashes)
            shipped = ([] if isinstance(r, NotModified) else
                       [x for _, x in tree_flatten_with_path(r.params)[0]] if r.full
                       else list((r.leaves or {}).values()))
            self.last, self.bytes = r, sum(x.numel() * x.element_size() for x in shipped)
            return r

    class StagedDataServer(DataServer):
        """Records each staged batch with the ring rows its slots select at
        the time of the call, the call's wall time, and whether the staging
        thread had already finished the batch when the call came."""

        def __init__(self, **kw):
            super().__init__(**kw)
            self.staged, self.stage_ms, self.ready_at_call = [], [], []
            self.taken = threading.Event()

        def sample_to_device(self, batch_rows=None):
            self.ready_at_call.append(self._staged is not None and self._staged[3].done())
            t0 = time.perf_counter()
            batch = super().sample_to_device(batch_rows)
            self.stage_ms.append(1e3 * (time.perf_counter() - t0))
            slots = self.last_sample_info()["slots"]
            self.staged.append((batch, [np.take(b, slots, axis=0) for b in self._buffers]))
            self.taken.set()
            return batch

    league = LeagueMgr(seed=0)
    league.add_learning_agent("main", theta0, game_mgr=SelfPlayPFSPGameMgr(payoff=None))
    opt = adamw(3e-4, clip_norm=1.0)
    learner = Learner(league, build_env_train_step(cfg, NUM_ACTIONS, opt), opt, theta0,
                      data_server=StagedDataServer(device=dev, prefetch=prefetch), device=dev)
    pool = Metered(league.model_pool)
    puller = CachedPuller(pool)
    server = InfServer(cfg, NUM_ACTIONS, device=dev, max_batch=ROWS)
    st = {"league": league, "learner": learner, "server": server, "puller": puller,
          "pool": pool, "segments": [], "metrics": [], "refresh_bytes": [], "seg_flushes": 0}

    def refresh():
        key = learner.current_key
        params, man = puller.get_with_manifest(key)
        server.update_params(params, key=key, content_hash=man.tree_hash, version=man.version)
        st["refresh_bytes"].append(pool.bytes)
        return man

    def produce():
        for i, seg in enumerate(segments[:iters]):
            if i:
                learner.data_server.taken.wait()
                learner.data_server.taken.clear()
            learner.data_server.put(seg)

    refresh()
    if producer:
        thread = threading.Thread(target=produce, name="smoke-producer", daemon=True)
        thread.start()
    rng = np.random.default_rng(11)
    for i in range(iters + (1 if freeze else 0)):
        if freeze and i == iters:
            st["old_key"] = learner.current_key
            st["cross_key_before"] = league.model_pool.pull_stats["cross_key"]
            st["new_key"] = learner.end_learning_period(reason="smoke")
            moments = [t for k in ("mu", "nu") for t in tree_leaves(learner.opt_state[k])]
            st["fresh_moments"] = (int(learner.opt_state["step"]) == 0
                                   and not any(bool(t.any()) for t in moments))
            st["adopt"] = refresh()
            st["adopt_answer"], st["adopt_bytes"] = pool.last, pool.bytes
        if segments is None:
            obs = rng.integers(0, 16, (ENV_B, ENV_T, OBS_LEN)).astype(np.int32)
            flushes = server.batches_run
            a, logp, v = server.get(server.submit(obs.reshape(-1, OBS_LEN),
                                                  model=learner.current_key))
            st["seg_flushes"] += server.batches_run - flushes
            shape = (ENV_B, ENV_T)
            seg = {"obs": obs, "actions": a.reshape(shape), "behavior_logp": logp.reshape(shape),
                   "behavior_values": v.reshape(shape),
                   "rewards": rng.normal(size=shape).astype(np.float32),
                   "done": rng.random(shape) < 0.05,
                   "bootstrap_value": rng.normal(size=(ENV_B,)).astype(np.float32)}
        else:
            seg = segments[i]
        st["segments"].append(seg)
        if producer:
            check(learner.data_server.wait_ready(timeout=60), "league: the producer put nothing")
        else:
            learner.data_server.put(seg)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = learner.learn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        st["learn_ms"] = 1e3 * (time.perf_counter() - t0)
        st["metrics"].append({k: v.item() for k, v in metrics.items()})
        if on_iter:
            on_iter(st, "learned")
        st["man"] = refresh()
        if on_iter:
            on_iter(st, "refreshed")
    if producer:
        thread.join()
    return st


def league_phase(dev, cfg_env, counters, smi, per_step):
    """The league path on the card: the Learner trains policy-s (bf16
    compute) from a blocking DataServer on segments whose actions, logp and
    values the InfServer served; every learn step pushes theta to the
    ModelPool, and the InfServer hot-swaps it in through a CachedPuller.
    Then the learning period ends (theta frozen into the opponent pool) and
    one more iteration runs on the new key. The kernels' launch counts are
    set to 0 before the path and read after it; the launches of what only
    measures or checks the path (the bare step timed beside each learn, the
    probe's flush and its direct forward) are taken out, and the rest must
    equal the path's own: an env step's per learn step and a policy-s
    flush's per segment served.

    The probe served after each refresh is held twice: against
    `make_obs_policy` on the Learner's params on the card, which runs the
    same code and kernels as the InfServer and so shows only that the swap
    delivered the Learner's params; and against the same forward on the
    CPU's plain versions (bf16 compute), which checks the served numbers.

    Then the same loop runs again with a producer thread that puts each
    segment while the previous step runs (as the league runtime's actor
    threads would), with the DataServer's prefetch and without, to measure
    whether the staging is hidden; and two fp32 iterations on the card are
    held against the same on the CPU. Returns (launches, numbers)."""
    import torch

    from repro_torch.actors.policy import make_obs_policy
    from repro_torch.kernels import dispatch
    from repro_torch.models import init_params
    from repro_torch.params import NotModified, build_manifest
    from repro_torch.rl import categorical_logp
    from repro_torch.utils import tree_flatten_with_path, tree_leaves, tree_map

    for c in counters:
        c.launches = 0
    dispatch.stats(reset=True)
    excluded = {c.__name__: 0 for c in counters}

    def uncounted(fn):
        """Run `fn`, adding the launches it makes to `excluded`."""
        before = {c.__name__: c.launches for c in counters}
        out = fn()
        for c in counters:
            excluded[c.__name__] += c.launches - before[c.__name__]
        return out

    pol_env = make_obs_policy(cfg_env, NUM_ACTIONS)
    probe = np.random.default_rng(12).integers(0, 16, (64, OBS_LEN)).astype(np.int32)
    lg = {"learn_ms": [], "step_ms": [], "stage_ms": [], "h2d_bytes": [], "mint_ms": [],
          "hash_ms": [], "refresh_bytes": [], "served_err": [], "served": []}

    def sync_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0), out

    def check_staged(learner, lg):
        """The newest staged batch against the ring rows its slots select;
        records its H2D bytes and its `sample_to_device` and `learn` ms.
        Returns the batch."""
        batch, rows = learner.data_server.staged[-1]
        leaves = [x for _, x in tree_flatten_with_path(batch)[0]]
        check(all(x.is_cuda for x in leaves), "league: a staged leaf is not on the card")
        check(all(np.array_equal(x.cpu().numpy(), r) for x, r in zip(leaves, rows)),
              "league: a staged batch differs from the ring rows its slots select")
        lg["h2d_bytes"].append(sum(x.numel() * x.element_size() for x in leaves))
        lg["stage_ms"].append(learner.data_server.stage_ms[-1])
        return batch

    def bare_step_ms(learner, batch):
        """The bare train step on the same batch (functional: nothing kept)."""
        return uncounted(lambda: sync_ms(lambda: learner.train_step(
            learner.params, learner.opt_state, batch))[0])

    def on_iter(st, when):
        learner, server, league = st["learner"], st["server"], st["league"]
        key = learner.current_key
        if when == "learned":
            batch = check_staged(learner, lg)
            lg["learn_ms"].append(st["learn_ms"])
            lg["step_ms"].append(bare_step_ms(learner, batch))
            # the push's manifest, minted on its own with the card idle, and
            # the same content's manifest from host copies (the hashing alone)
            lg["mint_ms"].append(sync_ms(lambda: league.model_pool.manifest(key))[0])
            host = tree_map(lambda t: t.cpu(), learner.params)
            lg["hash_ms"].append(sync_ms(lambda: build_manifest(host, 0))[0])
            st["host_params"] = host
            return
        lg["refresh_bytes"].append(st["refresh_bytes"][-1])
        check(server._pool_versions[key] == league.model_pool.version(key),
              f"league: hosted version {server._pool_versions[key]} != pool's")
        check(server.has_model(key, build_manifest(learner.params, 0).tree_hash),
              "league: the hosted content hash is not the Learner's params'")

        def probe_forward():
            a, logp, v = server.get(server.submit(probe, model=key))
            with torch.no_grad():
                lgts, vd = pol_env.logits_values(learner.params,
                                                 torch.from_numpy(probe).to(dev).long())
                ld = categorical_logp(lgts, torch.from_numpy(a).to(dev))
            return a, logp, v, ld.cpu().numpy(), vd.float().cpu().numpy()
        a, logp, v, ld, vd = uncounted(probe_forward)
        err = max(np.abs(logp - ld).max(), np.abs(v - vd).max())
        lg["served_err"].append(float(err))
        check(err <= TOL["bfloat16"], f"league: served logp/value off by {err}")
        # held against the CPU's plain forward once the path's routing is read
        lg["served"].append((a, logp, v, st["host_params"]))
        noops = server.swap_noops
        params, man = st["puller"].get_with_manifest(key)
        check(isinstance(st["pool"].last, NotModified), "league: an unchanged pull was not NotModified")
        server.update_params(params, key=key, content_hash=man.tree_hash, version=man.version)
        check(server.swap_noops == noops + 1, "league: an unchanged refresh swapped")

    theta0 = init_params(torch.Generator(device=dev).manual_seed(7), cfg_env)
    t_league = time.perf_counter()
    st = league_loop(dev, cfg_env, theta0, ENV_STEPS, freeze=True, on_iter=on_iter)
    league_s = time.perf_counter() - t_league
    launches = {c.__name__: c.launches - excluded[c.__name__] for c in counters}
    excluded = dict(excluded)
    learner, league = st["learner"], st["league"]
    ans = st["adopt_answer"]
    check(not isinstance(ans, NotModified) and not ans.full and not ans.leaves
          and set(ans.by_hash) == set(st["adopt"].leaf_hashes),
          "league: the adopted key did not arrive wholly by hash")
    check(st["adopt_bytes"] == 0, f"league: adopting the new key shipped {st['adopt_bytes']} bytes")
    check(league.model_pool.pull_stats["cross_key"] > st["cross_key_before"],
          "league: the adopt was not a cross-key answer")
    check(str(st["old_key"]) in league.league_state()["frozen_pool"],
          "league: the old key is not in the frozen pool")
    check(st["fresh_moments"], "league: the optimizer moments were not fresh after the freeze")
    check(learner.data_server.prefetch_hits == learner.step_count == ENV_STEPS + 1,
          f"league: prefetch hits {learner.data_server.prefetch_hits}, "
          f"steps {learner.step_count}")
    check(all(np.isfinite(list(m.values())).all() for m in st["metrics"]),
          "league: non-finite metrics")
    # the path's own launches: an env step's per learn step, and a policy-s
    # flush's (2L + 1 RMSNorms, L forwards) per segment the InfServer served
    L = cfg_env.num_layers
    per_flush = {"rmsnorm": 2 * L + 1, "flash_attention_fwd": L}
    check(st["seg_flushes"] == ENV_STEPS + 1,
          f"league: {st['seg_flushes']} flushes served {ENV_STEPS + 1} segments")
    for name in launches:
        want = (learner.step_count * per_step["env"][name]
                + st["seg_flushes"] * per_flush.get(name, 0))
        check(launches[name] == want,
              f"league path: {name} launched {launches[name]} times, want {want}")
    st_disp = dispatch.stats()
    check(not any("|reference" in key for key in st_disp),
          f"league path: plain versions ran on the card: {st_disp}")

    # the served probes against the CPU's plain forward on the same params,
    # each of logp and value relative to max(1, max |plain|) as BWD_TOL holds
    # bf16 outputs: the logits are rounded to bf16 once, so an error of an
    # ulp grows with their size (one ulp at 2 to 4 is 0.0156)
    cpu_err, cpu_abs = 0.0, 0.0
    with torch.no_grad():
        for a, logp, v, host in lg["served"]:
            lgts, vc = pol_env.logits_values(host, torch.from_numpy(probe).long())
            lc = categorical_logp(lgts, torch.from_numpy(a).long())
            for got, want in ((logp, lc.float().numpy()), (v, vc.float().numpy())):
                e = float(np.abs(got - want).max())
                cpu_abs = max(cpu_abs, e)
                cpu_err = max(cpu_err, e / max(1.0, float(np.abs(want).max())))
    check(cpu_err <= BWD_TOL["bfloat16"],
          f"league: served logp/value off the CPU's plain forward by {cpu_err} of its size")

    # the same loop with a producer thread (the path's counts are read): each
    # put lands while the previous step runs, so with prefetch its staging
    # can finish before the Learner asks for it; without, the batch is
    # staged when asked. Two rounds of each, alternated.
    ov = {mode: {"learn_ms": [], "step_ms": [], "stage_ms": [], "h2d_bytes": [],
                 "ready": [], "seconds": 0.0} for mode in ("prefetch", "on_demand")}
    for _ in range(2):
        for mode, d in ov.items():
            def on_iter_overlap(st, when, d=d):
                if when == "learned":
                    batch = check_staged(st["learner"], d)
                    d["learn_ms"].append(st["learn_ms"])
                    d["step_ms"].append(bare_step_ms(st["learner"], batch))
            t_ov = time.perf_counter()
            st_ov = league_loop(dev, cfg_env, theta0, ENV_STEPS, segments=st["segments"],
                                on_iter=on_iter_overlap, producer=True,
                                prefetch=mode == "prefetch")
            d["seconds"] += time.perf_counter() - t_ov
            ds_ov = st_ov["learner"].data_server
            d["ready"] += [bool(x) for x in ds_ov.ready_at_call]
            hits = ENV_STEPS if mode == "prefetch" else 0
            check(ds_ov.prefetch_hits == hits and st_ov["learner"].step_count == ENV_STEPS,
                  f"league producer ({mode}): prefetch hits {ds_ov.prefetch_hits}, "
                  f"steps {st_ov['learner'].step_count}")

    # card against CPU: two iterations at fp32 compute from the same theta0
    # and the same segments (the card's served ones)
    cfg32 = dataclasses.replace(cfg_env, compute_dtype="float32")
    theta_cpu = init_params(torch.Generator().manual_seed(8), cfg32)
    runs = {"card": league_loop(dev, cfg32, tree_map(lambda t: t.to(dev), theta_cpu), 2)}
    runs["cpu"] = league_loop(torch.device("cpu"), cfg32, theta_cpu, 2,
                              segments=runs["card"]["segments"])
    card, cpu = runs["card"], runs["cpu"]
    p_err = max((a.cpu() - b).abs().max().item() for a, b in
                zip(tree_leaves(card["learner"].params), tree_leaves(cpu["learner"].params)))
    m_err = max(abs(a[k] - b[k]) for a, b in zip(card["metrics"], cpu["metrics"]) for k in a)
    check(p_err <= CARD_VS_CPU_TOL and m_err <= CARD_VS_CPU_TOL,
          f"league card vs CPU: params {p_err}, metrics {m_err} > {CARD_VS_CPU_TOL}")
    key = card["learner"].current_key
    check(card["league"].model_pool.version(key) == cpu["league"].model_pool.version(key),
          "league card vs CPU: pool versions differ")
    counters_of = lambda r: {k: r["learner"].data_server.throughput()[k]
                             for k in ("prefetch_hits", "prefetch_misses", "repeat_ratio")}
    check(counters_of(card) == counters_of(cpu), "league card vs CPU: feed counters differ")

    med = statistics.median
    paired = lambda d: med(a - b for a, b in zip(d["learn_ms"], d["step_ms"]))
    league_out = {"learn_ms": med(lg["learn_ms"]), "bare_step_ms": med(lg["step_ms"]),
                  "learn_minus_bare_ms": paired(lg),
                  "sample_to_device_ms": med(lg["stage_ms"]),
                  "h2d_bytes_per_step": lg["h2d_bytes"][0], "mint_ms": med(lg["mint_ms"]),
                  "host_hash_ms": med(lg["hash_ms"]),
                  "pull_bytes_per_refresh": med(lg["refresh_bytes"]),
                  "adopt_bytes": st["adopt_bytes"], "seconds": league_s,
                  **{f"producer_{mode}_{k}": f(d) for mode, d in ov.items() for k, f in (
                      ("learn_ms", lambda d: med(d["learn_ms"])),
                      ("bare_step_ms", lambda d: med(d["step_ms"])),
                      ("learn_minus_bare_ms", paired),
                      ("sample_to_device_ms", lambda d: med(d["stage_ms"])),
                      ("staged_ready_at_call", lambda d: sum(d["ready"])))}}
    emit("league", card=smi, arch=cfg_env.name, compute_dtype=cfg_env.compute_dtype,
         iterations=ENV_STEPS + 1, segment=[ENV_B, ENV_T, OBS_LEN],
         param_bytes=st["adopt"].nbytes, **league_out,
         learn_ms_each=[round(x, 3) for x in lg["learn_ms"]],
         bare_step_ms_each=[round(x, 3) for x in lg["step_ms"]],
         mint_ms_each=[round(x, 3) for x in lg["mint_ms"]],
         staged_ready_at_call=sum(learner.data_server.ready_at_call),
         sample_to_device_ms_each=[round(x, 3) for x in lg["stage_ms"]],
         served_max_err=max(lg["served_err"]), served_vs_cpu_rel_err=cpu_err,
         served_vs_cpu_abs_err=cpu_abs,
         pull_stats=league.model_pool.pull_stats,
         swaps=st["server"].swaps, swap_noops=st["server"].swap_noops,
         frozen_pool=league.league_state()["frozen_pool"],
         throughput=learner.data_server.throughput(), launches=launches,
         launches_excluded=excluded, segment_flushes=st["seg_flushes"],
         producer={mode: {"iterations": 2 * ENV_STEPS, "seconds": d["seconds"],
                          "ready_at_call": d["ready"],
                          "learn_ms_each": [round(x, 3) for x in d["learn_ms"]],
                          "bare_step_ms_each": [round(x, 3) for x in d["step_ms"]],
                          "sample_to_device_ms_each": [round(x, 3) for x in d["stage_ms"]]}
                   for mode, d in ov.items()},
         card_vs_cpu={"params": p_err, "metrics": m_err, "tol": CARD_VS_CPU_TOL})

    return launches, league_out


def zero(counters):
    """Set the kernels' launch counts, and the dispatch's per-tier counts
    that `check_on_card` reads, to 0 just before a path runs."""
    from repro_torch.kernels import dispatch
    for c in counters:
        c.launches = 0
        for design in getattr(c, "design_launches", {}):
            c.design_launches[design] = 0
    dispatch.stats(reset=True)


def read(counters):
    return {c.__name__: c.launches for c in counters}


def dkv_designs():
    """The dk/dv kernel's launches per design since its counts were last
    set to 0 (`zero`)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_bwd_dkv
    return dict(flash_attention_bwd_dkv.design_launches)


def check_on_card(what):
    """No op of the path run since the last call went to a plain version
    (the dispatch counts are read and set to 0)."""
    from repro_torch.kernels import dispatch
    st = dispatch.stats(reset=True)
    check(not any("|reference" in k for k in st), f"{what}: plain versions ran on the card: {st}")
    return st


def sync_wall(fn):
    """(ms on the host clock, fn's result), the card idle before and after."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0), out


def profiled(fn, n):
    """Run fn n times under torch.profiler, each call between synchronises.
    Returns the median call's wall ms, the device busy ms and device ops per
    call (the profiler's CUDA events), the device's idle share over the
    profiled window: 1 - busy / wall, and the 8 device ops that took the
    most time as [name, ms per call, launches per call]."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    walls = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            walls.append(sync_wall(fn)[0])
        window_s = time.perf_counter() - t0
    dev = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    out = {"wall_ms_profiled": statistics.median(walls), "device_busy_ms": busy_ms / n,
           "device_ops": sum(e.count for e in dev) / n,
           "idle_share": 1 - busy_ms / 1e3 / window_s}
    dev.sort(key=lambda e: -e.self_device_time_total)
    out["top_device_ops"] = [[e.key[:120], e.self_device_time_total / 1e3 / n, e.count / n]
                             for e in dev[:8]]
    return out


def envs_phase(dev, smi):
    """Each env at 256 slots, stepped 64 times on the card and on the CPU
    from one initial state (reset on the card, copied to the CPU) with
    actions from a numpy seed: states, obs, done and info bitwise equal,
    rewards within ENV_REWARD_TOL. Then the median env-step ms on each
    device at 16, 64 and 256 slots, and the card's device ops per step."""
    import torch

    from repro_torch.envs import make_env

    cpu = torch.device("cpu")
    out = {}
    for name in ("rps", "duel", "pommerman_lite"):
        envs = {"card": make_env(name, device=dev), "cpu": make_env(name, device=cpu)}
        spec, S = envs["card"].spec, ENV_SLOTS[-1]
        state, _ = envs["card"].reset(torch.Generator(device=dev).manual_seed(0), S)
        states = {"card": state, "cpu": {k: v.cpu() for k, v in state.items()}}
        acts = np.random.default_rng(1).integers(
            0, spec.num_actions, (ENV_CHECK_STEPS, S, spec.num_agents)).astype(np.int32)
        rew_err, dones = 0.0, 0
        for t in range(ENV_CHECK_STEPS):
            res = {}
            for d, env in envs.items():
                states[d], *res[d] = env.step(states[d], torch.from_numpy(acts[t]).to(env.device),
                                              None)
            (o_c, r_c, d_c, i_c), (o_h, r_h, d_h, i_h) = res["card"], res["cpu"]
            same = lambda a, b: a.dtype == b.dtype and torch.equal(a.cpu(), b)
            check(all(same(states["card"][k], v) for k, v in states["cpu"].items()),
                  f"envs {name}: a state leaf differs between the card and the CPU at step {t}")
            check(same(o_c, o_h) and same(d_c, d_h) and set(i_c) == set(i_h)
                  and all(same(i_c[k], v) for k, v in i_h.items()),
                  f"envs {name}: obs, done or info differ between the card and the CPU at step {t}")
            rew_err = max(rew_err, (r_c.cpu() - r_h).abs().max().item())
            dones += int(d_h.sum())
        check(rew_err <= ENV_REWARD_TOL, f"envs {name}: rewards off by {rew_err}")
        step_ms = {}
        for d, env in envs.items():
            for n in ENV_SLOTS:
                gen = torch.Generator(device=env.device).manual_seed(2)
                st = [env.reset(gen, n)[0]]
                a = torch.from_numpy(acts[0, :n]).to(env.device)

                def one(env=env, st=st, a=a, gen=gen):
                    st[0] = env.step(st[0], a, gen)[0]
                ms = [sync_wall(one)[0] for _ in range(ENV_TIMED_STEPS + 3)][3:]
                step_ms[f"{d}_{n}"] = statistics.median(ms)
        gen = torch.Generator(device=dev).manual_seed(3)
        st = [envs["card"].reset(gen, S)[0]]
        a = torch.from_numpy(acts[0]).to(dev)
        prof = profiled(lambda: st.__setitem__(0, envs["card"].step(st[0], a, gen)[0]), 10)
        out[name] = {"step_ms": step_ms, "profiled": prof}
        emit("envs", card=smi, env=name, slots=S, steps=ENV_CHECK_STEPS, bitwise=True,
             reward_max_abs_err=rew_err, reward_tol=ENV_REWARD_TOL, episodes_ended=dones,
             median_step_ms=step_ms, profiled=prof)
    return out


def check_traj(traj, what):
    """`traj` against repro's segment contract: (rows, T, ...) leaves for the
    2 * ACT_E learner rows of ACT_T steps, with repro's dtypes."""
    rows, T = 2 * ACT_E, ACT_T
    want = {"obs": ((rows, T, OBS_LEN), np.int32), "actions": ((rows, T), np.int32),
            "behavior_logp": ((rows, T), np.float32), "behavior_values": ((rows, T), np.float32),
            "rewards": ((rows, T), np.float32), "done": ((rows, T), np.bool_),
            "bootstrap_value": ((rows,), np.float32)}
    got = {k: (tuple(v.shape), np.dtype(v.dtype)) for k, v in traj.items()}
    want = {k: (s, np.dtype(d)) for k, (s, d) in want.items()}
    check(got == want, f"{what}: segment {got} is not repro's {want}")
    check(all(np.isfinite(traj[k]).all() for k in ("behavior_logp", "behavior_values",
                                                    "rewards", "bootstrap_value")),
          f"{what}: non-finite segment values")


def seed_league(theta0):
    from repro_torch.core import LeagueMgr, SelfPlayPFSPGameMgr
    league = LeagueMgr(seed=0)
    league.add_learning_agent("main", theta0, game_mgr=SelfPlayPFSPGameMgr(payoff=None))
    return league


def actors_phase(dev, cfg, counters, smi, per_forward):
    """An Actor on pommerman_lite, 16 envs x unroll 16, policy-s (bf16
    compute), local then served. Local: ACT_SEGMENTS segments through
    `run_segment`, then one more segment's T steps through the collector's
    `collect_on_device` under `torch.cuda.set_sync_debug_mode("error")`
    (any host sync raises); launches must equal 2T + 1 forwards' per
    segment, and the recorded actions' logp and values must match the
    CPU's plain forward on the same params. Served: the same Actor over an
    InfServer on the card; T + 1 flushes per segment, each step's θ and φ
    coalesced into one grouped forward, launches exactly the flushes'.
    Returns (launches, numbers, theta0)."""
    import threading

    import torch

    from repro_torch.actors import Actor
    from repro_torch.actors.policy import make_obs_policy
    from repro_torch.envs import make_env
    from repro_torch.infserver import InfServer
    from repro_torch.models import init_params
    from repro_torch.rl import categorical_logp
    from repro_torch.utils import tree_map
    from repro_torch.utils.host import to_host

    env = make_env("pommerman_lite", device=dev)
    theta0 = init_params(torch.Generator(device=dev).manual_seed(21), cfg)
    frames = ACT_E * ACT_T
    out = {}

    # -- local --------------------------------------------------------------
    league = seed_league(theta0)
    actor = local_actor = Actor(env, cfg, league, num_envs=ACT_E, unroll_len=ACT_T, seed=0,
                                device=dev)
    zero(counters)
    walls = []
    for _ in range(ACT_SEGMENTS):
        ms, (traj, task) = sync_wall(actor.run_segment)
        walls.append(ms)
        check_traj(traj, "actors local")
    theta = league.model_pool.pull(task.learner_key)
    phi = league.model_pool.pull(task.opponent_keys[0])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        actor.carry, traj_dev, _ = actor.collector.collect_on_device(theta, phi, actor.carry,
                                                                     actor.gen)
        enqueue_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check_traj(to_host(traj_dev), "actors local, on device")
    local = read(counters)
    check_on_card("actors local")
    segments = ACT_SEGMENTS + 1
    want = {n: segments * (2 * ACT_T + 1) * per_forward.get(n, 0) for n in local}
    check(local == want, f"actors local: launches {local}, want {want} ({segments} segments "
                         f"of {2 * ACT_T + 1} forwards)")
    # the last segment's logp and values against the CPU's plain forward
    pol = make_obs_policy(cfg, env.spec.num_actions)
    with torch.no_grad():
        lg, v = pol.logits_values(tree_map(lambda t: t.cpu(), theta),
                                  torch.from_numpy(traj["obs"].reshape(-1, OBS_LEN)).long())
        logp = categorical_logp(lg, torch.from_numpy(traj["actions"].reshape(-1)).long())
    errs = {}
    for k, want_v in (("behavior_logp", logp), ("behavior_values", v)):
        got = traj[k].reshape(-1)
        want_v = want_v.float().numpy()
        errs[k] = float(np.abs(got - want_v).max() / max(1.0, float(np.abs(want_v).max())))
    check(max(errs.values()) <= BWD_TOL["bfloat16"],
          f"actors local: logp/values off the CPU's plain forward by {errs}")
    out["local"] = {"segment_ms": statistics.median(walls[1:]), "segment_ms_each": walls,
                    "frames_per_s": frames / statistics.median(walls[1:]) * 1e3,
                    "sync_checked_enqueue_ms": enqueue_ms, "vs_cpu_rel_err": errs}

    # -- served -------------------------------------------------------------
    # one learning period ended, so θ (main:0001) and the frozen φ
    # (main:0000) are two routes whenever the matchmaker does not pick
    # self-play
    league = seed_league(theta0)
    league.end_learning_period("main", theta0)
    server = InfServer(cfg, env.spec.num_actions, device=dev, max_batch=ROWS)
    models_per_flush = []
    flush = server.flush

    def counted_flush():
        n = server.batches_run
        flush()
        if server.batches_run > n:
            models_per_flush.append(server.last_batch_models)
    server.flush = counted_flush
    actor = Actor(env, cfg, league, num_envs=ACT_E, unroll_len=ACT_T, seed=1,
                  inf_server=server, device=dev)
    zero(counters)
    walls, grouped = [], 0
    for _ in range(ACT_SEGMENTS):
        n = len(models_per_flush)
        ms, (traj, task) = sync_wall(actor.run_segment)
        walls.append(ms)
        check_traj(traj, "actors served")
        routes = len({task.learner_key, task.opponent_keys[0]})
        check(models_per_flush[n:] == [routes] * ACT_T + [1],
              f"actors served: flushes of a segment hosted {models_per_flush[n:]} models, "
              f"want θ and φ ({routes} routes) in one flush per step and θ alone for "
              f"the bootstrap")
        grouped += routes == 2
        man = league.model_pool.manifest(task.learner_key)
        check(server.has_model(task.learner_key, man.tree_hash),
              "actors served: the hosted content hash is not the pool's")
    served = read(counters)
    check_on_card("actors served")
    check(grouped > 0, "actors served: no segment played θ against another route")
    want = {n: len(models_per_flush) * per_forward.get(n, 0) for n in served}
    check(served == want, f"actors served: launches {served}, want {want}")
    out["served"] = {"segment_ms": statistics.median(walls[1:]), "segment_ms_each": walls,
                     "frames_per_s": frames / statistics.median(walls[1:]) * 1e3,
                     "flushes_per_segment": ACT_T + 1, "segments_grouped": grouped,
                     "median_flush_ms": 1e3 * server._latency_sum / server.batches_run}
    launches = {n: local[n] + served[n] for n in local}

    # where a segment's time goes (after the counts were read)
    out["local"]["profiled"] = profiled(local_actor.run_segment, 3)
    out["served"]["profiled"] = profiled(actor.run_segment, 3)
    # two local actors, each in a thread of its own, as the runtime runs
    # them: the segment's wall against one actor alone
    pair = [Actor(env, cfg, seed_league(theta0), num_envs=ACT_E, unroll_len=ACT_T, seed=3 + i,
                  device=dev) for i in range(2)]
    for a in pair:
        a.run_segment()
    pair_ms = [[], []]

    def run_three(i):
        for _ in range(3):
            t0 = time.perf_counter()
            pair[i].run_segment()
            pair_ms[i].append(1e3 * (time.perf_counter() - t0))
    threads = [threading.Thread(target=run_three, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    check(not any(t.is_alive() for t in threads) and all(len(m) == 3 for m in pair_ms),
          "actors: the two actor threads did not finish their segments")
    out["local"]["two_threads_segment_ms"] = statistics.median(pair_ms[0] + pair_ms[1])
    emit("actors", card=smi, env="pommerman_lite", arch=cfg.name,
         compute_dtype=cfg.compute_dtype, envs=ACT_E, unroll=ACT_T, rows=2 * ACT_E,
         segments=ACT_SEGMENTS, launches_local=local, launches_served=served,
         forwards_per_local_segment=2 * ACT_T + 1, **out)
    return launches, out, theta0


def league_loop_phase(dev, cfg, counters, smi, per_forward, per_step, theta0):
    """`examples/torch_quickstart.py`'s loop (its `train`) on the card: an
    Actor (local, pommerman_lite, 16 envs x 16) -> `data_server.put` ->
    `learner.learn()`, LOOP_ITERS iterations per learning period, then
    `end_learning_period`; LOOP_PERIODS periods. The league state after it
    has `repro`'s structure: the seed and the first period's key frozen,
    the lineage on the third key, and a payoff entry for every reported
    match. Launches: exactly one local segment's and one env step's per
    iteration. Returns (launches, numbers, learner)."""
    import torch

    from repro_torch.actors import Actor
    from repro_torch.envs import make_env
    from repro_torch.learners import Learner, build_env_train_step
    from repro_torch.optim import adamw

    env = make_env("pommerman_lite", device=dev)
    league = seed_league(theta0)
    results = []
    report = league.report_result
    league.report_result = lambda r: (results.append(r), report(r))[1]
    actor = Actor(env, cfg, league, num_envs=ACT_E, unroll_len=ACT_T, seed=2, device=dev)
    opt = adamw(3e-4, clip_norm=1.0)
    learner = Learner(league, build_env_train_step(cfg, env.spec.num_actions, opt), opt, theta0,
                      device=dev)
    # an iteration from its segment's start to its learn's end
    iter_ms, learn_ms, t_it = [], [], [0.0]
    segment, learn = actor.run_segment, learner.learn

    def timed_segment():
        t_it[0] = time.perf_counter()
        return segment()

    def timed_learn():
        t_l = time.perf_counter()
        metrics = learn()
        learn_ms.append(1e3 * (time.perf_counter() - t_l))
        metrics["loss"].item()             # the sync of the loop's own .item()
        iter_ms.append(1e3 * (time.perf_counter() - t_it[0]))
        return metrics

    actor.run_segment, learner.learn = timed_segment, timed_learn
    zero(counters)
    t0 = time.perf_counter()
    losses, _ = load_example("quickstart").train(actor, learner, LOOP_PERIODS, LOOP_ITERS)
    torch.cuda.synchronize()
    del actor.run_segment, learner.learn           # the classes' methods again
    seconds = time.perf_counter() - t0
    launches = read(counters)
    check_on_card("league_loop")
    iters = LOOP_PERIODS * LOOP_ITERS
    check(learner.step_count == iters, f"league_loop: {learner.step_count} learner steps")
    want = {n: iters * ((2 * ACT_T + 1) * per_forward.get(n, 0) + per_step["env"][n])
            for n in launches}
    check(launches == want, f"league_loop: launches {launches}, want {want}")
    check(all(np.isfinite(losses)), f"league_loop: non-finite losses {losses}")
    state = league.league_state()
    check(state["frozen_pool"] == ["main:0000", "main:0001"]
          and state["agents"] == {"main": "main:0002"} and state["num_freezes"] == LOOP_PERIODS,
          f"league_loop: league state {state}")
    check(state["num_results"] == len(results) > 0,
          f"league_loop: {state['num_results']} results recorded, {len(results)} reported")
    pairs = {(r.learner_key, r.opponent_keys[0]) for r in results}
    check(all(league.payoff.games(a, b) > 0 for a, b in pairs),
          "league_loop: a reported match has no payoff entry")
    out = {"iterations": iters, "seconds": seconds, "iteration_ms": statistics.median(iter_ms),
           "learn_ms": statistics.median(learn_ms), "losses": [round(x, 4) for x in losses],
           "results": len(results), "frozen_pool": state["frozen_pool"]}
    emit("league_loop", card=smi, env="pommerman_lite", arch=cfg.name, periods=LOOP_PERIODS,
         iters_per_period=LOOP_ITERS, launches=launches, league=state,
         throughput=learner.data_server.throughput(), **out)
    return launches, out, learner


def runtime_phase(dev, cfg, counters, smi, per_forward, per_step):
    """`build_runtime` on pommerman_lite, policy-s, 16 envs x 16, with the
    two roles of `examples/league_specs/main_minimax.json` (main, and a
    minimax exploiter that targets it; one actor each), each gated by
    FreezeGate(step_gate=RUNTIME_STEP_GATE), stopped at RUNTIME_FREEZES
    freezes per role. Three runs: local actors with the DataServer's
    prefetch on, then off, then served actors. Each run shuts down
    cleanly with exactly RUNTIME_FREEZES step-gate freezes per role; its
    launches are exactly its learner steps' and its segments' (local) or
    flushes' (served). Every `learn()` call of the learner threads is timed
    on the host clock (the call ends with the push's manifest, which waits
    for the step). A fourth, shorter run under the profiler gives the
    device's busy and idle share. Returns (launches, numbers)."""
    import dataclasses as dc

    from repro_torch.league import FreezeGate, LeagueSpec, build_runtime

    spec = LeagueSpec.from_json(str(ROOT / "examples" / "league_specs" / "main_minimax.json"))
    spec = LeagueSpec(roles=tuple(dc.replace(r, gate=FreezeGate(step_gate=RUNTIME_STEP_GATE))
                                  for r in spec))
    L = cfg.num_layers

    def build(**kw):
        rt = build_runtime(spec, env_name="pommerman_lite", arch=cfg.name, num_envs=ACT_E,
                           unroll_len=ACT_T, seed=0, device=dev, **kw)
        timed = {}
        for r in rt.roles:
            lr, sink = r.learner.learner, timed.setdefault(r.spec.name, [])

            def learn(num_steps=1, lr=lr, orig=lr.learn, sink=sink):
                t0 = time.perf_counter()
                m = orig(num_steps)
                if m:
                    sink.append(1e3 * (time.perf_counter() - t0))
                return m
            lr.learn = learn
        return rt, timed

    runs, launches = {}, {}
    for mode, kw in (("prefetch", {"prefetch": True}), ("on_demand", {"prefetch": False}),
                     ("served", {"served": True})):
        rt, timed = build(**kw)
        zero(counters)
        report = rt.run(max_freezes_per_role=RUNTIME_FREEZES, max_seconds=RUNTIME_MAX_S)
        got = read(counters)
        check_on_card(f"runtime {mode}")
        check(report["clean_shutdown"], f"runtime {mode}: unclean shutdown")
        for name, role in report["roles"].items():
            reasons = [f["reason"] for f in role["freezes"]]
            check(len(reasons) == RUNTIME_FREEZES
                  and all(x.startswith("step_gate@") for x in reasons),
                  f"runtime {mode}: role {name} froze {reasons}")
            check(all(role[k] > 0 for k in ("rfps", "cfps")), f"runtime {mode}: {name} rates")
        check(report["frames_per_s"] > 0, f"runtime {mode}: frames_per_s")
        steps = sum(r.learner.learner.step_count for r in rt.roles)
        segments = sum(a.actor.frames_produced // (ACT_E * ACT_T) for r in rt.roles for a in r.actors)
        forwards = rt.inf_server.batches_run if mode == "served" else segments * (2 * ACT_T + 1)
        want = {n: steps * per_step["env"][n] + forwards * per_forward.get(n, 0) for n in got}
        check(got == want, f"runtime {mode}: launches {got}, want {want} ({steps} learner "
                           f"steps, {segments} segments, {forwards} forwards)")
        check(got["reverse_discounted_scan_p"] == steps
              and got["flash_attention_bwd_dkv"] == L * steps,
              f"runtime {mode}: scan and dk/dv launches {got} for {steps} learner steps")
        launches[mode] = got
        learn_ms = [x for v in timed.values() for x in v]
        runs[mode] = {
            "wall_s": report["wall_s"], "frames_per_s": report["frames_per_s"],
            "learner_steps": steps, "segments": segments, "forwards": forwards,
            "learn_ms_median": statistics.median(learn_ms),
            "learn_ms_each": {k: [round(x, 3) for x in v] for k, v in timed.items()},
            # the learners' share of the run spent inside learn(): an
            # actor-bound runtime leaves its learners waiting
            "learner_busy_share": {k: sum(v) / 1e3 / report["wall_s"] for k, v in timed.items()},
            "segment_ms": 1e3 * report["wall_s"] / max(1, segments / sum(
                len(r.actors) for r in rt.roles)),
            "prefetch": {r.spec.name: [r.data_server.prefetch_hits, r.data_server.prefetch_misses]
                         for r in rt.roles},
            "roles": {k: {x: v[x] for x in ("segments", "frames_produced", "learner_steps",
                                            "rfps", "cfps")} for k, v in report["roles"].items()},
            "freezes": {k: [f["reason"] for f in v["freezes"]] for k, v in report["roles"].items()},
            "freeze_latency_s_max": report["freeze_latency_s_max"],
            "launches_per_learner_step": {n: x / steps for n, x in got.items()}}
        emit("runtime", card=smi, mode=mode, env="pommerman_lite", arch=cfg.name,
             envs=ACT_E, unroll=ACT_T, step_gate=RUNTIME_STEP_GATE, launches=got,
             league=report["league"], **runs[mode])
    rt, _ = build(prefetch=True)
    prof = profiled(lambda: rt.run(max_freezes_per_role=1, max_seconds=RUNTIME_MAX_S), 1)
    emit("runtime_profiled", card=smi, mode="prefetch", freezes_per_role=1, **prof)
    total = {n: sum(v[n] for v in launches.values()) for n in launches["prefetch"]}
    return total, {"runs": runs, "profiled": prof}


def checkpoint_phase(dev, learner, smi):
    """The Learner's θ on the card saved with `save_pytree` and loaded onto
    the CPU with `load_pytree`: every leaf bitwise equal, dtype and all."""
    import torch

    from repro_torch.checkpoint import load_pytree, save_pytree
    from repro_torch.utils import tree_flatten_with_path, tree_map

    path = ROOT / "build" / "chip_smoke" / "theta.npz"
    theta = learner.params
    check(all(x.is_cuda for _, x in tree_flatten_with_path(theta)[0]),
          "checkpoint: θ is not on the card")
    t0 = time.perf_counter()
    save_pytree(str(path), theta)
    save_ms = 1e3 * (time.perf_counter() - t0)
    loaded = load_pytree(str(path), tree_map(lambda t: torch.empty_like(t, device="cpu"), theta))
    pairs = list(zip(tree_flatten_with_path(theta)[0], tree_flatten_with_path(loaded)[0]))
    check(all(pa == pb and a.dtype == b.dtype and b.device.type == "cpu"
              and torch.equal(a.cpu(), b) for (pa, a), (pb, b) in pairs),
          "checkpoint: a leaf loaded on the CPU differs from the card's")
    emit("checkpoint", card=smi, leaves=len(pairs), bytes=path.stat().st_size,
         save_ms=save_ms, bitwise=True)


def transport_phase(dev, cfg, counters, smi, per_forward):
    """The RPC transport in one process, on the card. An `RpcServer` hosts
    an on-card policy-s InfServer (through `InfServerBackend`), a
    DataServer and a ModelPool. Over an `RpcClient`, a 256-row flush of
    pommerman_lite obs gives the in-process flush's outputs (two servers
    of one seed, as `tests/test_transport.py` holds them). θ (CUDA fp32)
    is pushed through `ModelPoolClient` and pulled back bitwise, and the
    remote manifest's hashes equal an in-process pool's over the same θ.
    Timed: the no-op round trip, a full, a NotModified and a delta pull
    (ms and wire bytes), and a `put_when_room` of one actor segment.
    Launches exactly the flushes'. Returns (launches, numbers)."""
    import torch

    from repro_torch.core import ModelKey, ModelPool
    from repro_torch.distributed import transport as tp
    from repro_torch.distributed.heartbeat import Heartbeat
    from repro_torch.infserver import InfServer
    from repro_torch.learners import DataServer
    from repro_torch.models import init_params
    from repro_torch.utils import tree_flatten_with_path, tree_map

    theta = init_params(torch.Generator(device=dev).manual_seed(31), cfg)
    obs = np.random.default_rng(31).integers(0, cfg.vocab_size, (ROWS, OBS_LEN)).astype(np.int32)
    rng = np.random.default_rng(32)
    traj = {"obs": rng.integers(0, 8, (TRANSPORT_SEGMENT_ROWS, ACT_T, OBS_LEN)).astype(np.int32),
            "actions": rng.integers(0, NUM_ACTIONS, (TRANSPORT_SEGMENT_ROWS, ACT_T)).astype(np.int32),
            "behavior_logp": rng.normal(size=(TRANSPORT_SEGMENT_ROWS, ACT_T)).astype(np.float32),
            "behavior_values": rng.normal(size=(TRANSPORT_SEGMENT_ROWS, ACT_T)).astype(np.float32),
            "rewards": rng.normal(size=(TRANSPORT_SEGMENT_ROWS, ACT_T)).astype(np.float32),
            "done": rng.random((TRANSPORT_SEGMENT_ROWS, ACT_T)) < 0.05,
            "bootstrap_value": rng.normal(size=(TRANSPORT_SEGMENT_ROWS,)).astype(np.float32)}
    key = ModelKey("main", 0)
    zero(counters)
    local = InfServer(cfg, NUM_ACTIONS, theta, device=dev, max_batch=ROWS, seed=13)
    remote_server = InfServer(cfg, NUM_ACTIONS, theta, device=dev, max_batch=ROWS, seed=13)
    pool = ModelPool()
    ds = DataServer(capacity_frames=4 * TRANSPORT_SEGMENT_ROWS * ACT_T, blocking=True, device=dev)
    srv = tp.RpcServer({"inf": tp.InfServerBackend(remote_server), "data": ds, "pool": pool,
                        "ctrl": Heartbeat()}).start()
    client = tp.RpcClient(srv.address)
    inf = tp.InfServerClient(client)
    pool_c, data_c = tp.ModelPoolClient(client), tp.DataServerClient(client)
    out = {"codec": tp.CODEC}
    try:
        want = local.get(local.submit(obs))
        got = inf.get(inf.submit(obs))
        check(np.array_equal(got[0], want[0]), "transport: remote actions differ from in-process")
        flush_err = max(float(np.abs(a - b).max()) for a, b in zip(got[1:], want[1:]))
        check(flush_err == 0.0, f"transport: remote logp/values off in-process by {flush_err}")
        flush_ms = []
        for _ in range(TRANSPORT_FLUSHES):
            t0 = time.perf_counter()
            inf.get(inf.submit(obs))
            flush_ms.append(1e3 * (time.perf_counter() - t0))
        local_ms = []
        for _ in range(TRANSPORT_FLUSHES):
            t0 = time.perf_counter()
            local.get(local.submit(obs))
            local_ms.append(1e3 * (time.perf_counter() - t0))
        launches = read(counters)
        check_on_card("transport")
        flushes = local.batches_run + remote_server.batches_run
        want_l = {n: flushes * per_forward.get(n, 0) for n in launches}
        check(launches == want_l, f"transport: launches {launches}, want {want_l}")
        out["flush_256"] = {"rpc_ms_median": statistics.median(flush_ms),
                            "inproc_ms_median": statistics.median(local_ms), "max_abs_err": flush_err}
        out["shm"] = client.transport_stats()["shm"]
        rtt = []
        for _ in range(TRANSPORT_RTT_CALLS):
            t0 = time.perf_counter()
            client.call("ctrl.ping")
            rtt.append(1e3 * (time.perf_counter() - t0))
        out["noop_rtt_ms_median"] = statistics.median(rtt)

        # θ over the wire: CUDA fp32 tensors in, numpy out, bitwise; under
        # this machine's codec and under pickle (the fallback without msgpack)
        host = tree_map(lambda t: t.cpu().numpy(), theta)
        theta2 = {**theta, "embed": tree_map(lambda t: t + 1.0, theta["embed"])}
        changed = sorted(p for p, _ in tree_flatten_with_path(theta)[0] if p.startswith("['embed']"))
        ref_pool = ModelPool()
        ref_pool.push(key, theta)
        saved = tp.CODEC
        out["pulls"] = {}
        for codec in dict.fromkeys([tp.CODEC, "pickle"]):
            tp.CODEC = codec
            try:
                ckey = ModelKey(f"main_{codec}", 0)
                t0 = time.perf_counter()
                pool_c.push(ckey, theta)
                timed = {"push_ms": 1e3 * (time.perf_counter() - t0)}

                def pulls(have, ckey=ckey):
                    ms = []
                    for _ in range(TRANSPORT_PULLS):
                        t0 = time.perf_counter()
                        ans = pool_c.pull_if_changed(ckey, have)
                        ms.append(1e3 * (time.perf_counter() - t0))
                    return ans, {"ms_median": statistics.median(ms),
                                 "wire_bytes": len(tp.packb(ans))}
                ans, timed["full"] = pulls(None)
                pairs = zip(tree_flatten_with_path(ans.params)[0], tree_flatten_with_path(host)[0])
                check(all(pa == pb and isinstance(a, np.ndarray) and a.dtype == b.dtype
                          and np.array_equal(a, b) for (pa, a), (pb, b) in pairs),
                      f"transport {codec}: pulled θ is not θ bitwise")
                check(ans.manifest.leaf_hashes == ref_pool.manifest(key).leaf_hashes
                      and ans.manifest.tree_hash == ref_pool.manifest(key).tree_hash,
                      f"transport {codec}: the remote manifest's hashes are not the "
                      f"in-process pool's")
                out["param_bytes"] = ans.manifest.nbytes
                ans, timed["not_modified"] = pulls(0)
                check(isinstance(ans, tp.NotModified), f"transport {codec}: {type(ans).__name__}")
                pool_c.push(ckey, theta2)                # a delta: only the embedding changes
                ans, timed["delta_embed"] = pulls(0)
                check(not ans.full and sorted(ans.leaves) == changed,
                      f"transport {codec}: the delta carries {sorted(ans.leaves or [])}, "
                      f"want {changed}")
                timed["delta_embed"]["leaf_bytes"] = int(sum(a.nbytes
                                                             for a in ans.leaves.values()))
                out["pulls"][codec] = timed
            finally:
                tp.CODEC = saved

        # one actor segment through put_when_room, consumed between puts
        put_ms = []
        for _ in range(TRANSPORT_PUTS):
            t0 = time.perf_counter()
            check(data_c.put_when_room(traj, timeout=10.0), "transport: put_when_room timed out")
            put_ms.append(1e3 * (time.perf_counter() - t0))
            ds.sample()
        out["put_when_room_ms_median"] = statistics.median(put_ms)
        out["segment_bytes"] = int(sum(a.nbytes for a in traj.values()))
    finally:
        client.close()
        srv.close()
    emit("transport", card=smi, launches=launches, **out)
    return launches, out


def steady_ms(rec):
    """Mean ms per call after the first, from a `[seconds, calls, first
    call's seconds]` record of a worker's result line."""
    total, calls, first = rec
    return 1e3 * (total - first) / max(1, calls - 1)


def league_procs(lines):
    """The JSON result lines of a multiprocess run, by process kind (a line
    that holds two processes' objects back to back yields both)."""
    from torch_smoke_lib import records

    procs = {}
    for rec in records(lines):
        procs.setdefault(rec["process"], []).append(rec)
    return procs


def run_commands(cmds, env=None):
    """Start every command of `cmds` (name -> (argv, timeout s)) at once from
    the checkout, each in a session of its own; wait for each under its
    timeout, then kill its whole group, so that nothing it started outlives
    the call. Returns name -> {rc (None when it timed out), seconds, stdout,
    stderr}."""
    from torch_smoke_lib import kill_group

    started = {name: (time.perf_counter(), timeout, subprocess.Popen(
        cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)) for name, (cmd, timeout) in cmds.items()}
    out = {}
    try:
        for name, (t0, timeout, proc) in started.items():
            try:
                stdout, stderr = proc.communicate(
                    timeout=max(1.0, timeout - (time.perf_counter() - t0)))
                rc = proc.returncode
            except subprocess.TimeoutExpired:
                kill_group(proc.pid)
                stdout, stderr = proc.communicate()
                rc = None
            out[name] = {"rc": rc, "seconds": time.perf_counter() - t0,
                         "stdout": stdout, "stderr": stderr}
    finally:
        for _, _, proc in started.values():
            kill_group(proc.pid)
    return out


def multiprocess_phase(smi, per_forward, per_step):
    """The league as users start it: `python -m repro_torch.launch.train
    --workers W` on pommerman_lite (16 envs x unroll 16, policy-s) with
    main_minimax.json's two roles under FreezeGate(step_gate=8), to 16
    learner steps per role: W = 2 with local actors, then W = 2
    served by the coordinator's InfServer. Each run exits 0 with a clean
    shutdown; every learner reached 16 steps and froze; every process ran
    on the card (no plain version) and launched exactly: a learner its
    steps' env-step kernels, a local actor (2T + 1) forwards per segment,
    the served coordinator its flushes' forwards. Returns (launches,
    numbers)."""
    spec = json.loads((ROOT / "examples" / "league_specs" / "main_minimax.json").read_text())
    for role in spec["roles"]:
        role["gate"] = {"step_gate": MP_STEP_GATE}
    spec_path = ROOT / "build" / "chip_smoke" / "main_minimax_step_gate.json"
    spec_path.parent.mkdir(parents=True, exist_ok=True)
    spec_path.write_text(json.dumps(spec))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH") else [])))
    seg_frames = ACT_E * ACT_T
    total = {}
    runs = {}
    for workers, served in MP_RUNS:
        mode = f"w{workers}" + ("_served" if served else "")
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--workers", str(workers),
               "--env", "pommerman_lite", "--num-envs", str(ACT_E), "--unroll-len", str(ACT_T),
               "--max-steps", str(MP_STEPS), "--league-spec", str(spec_path),
               "--max-actor-restarts", "0"]
        if served:
            cmd += ["--served", "--sharded"]
        run = run_commands({mode: (cmd, MP_TIMEOUT_S)}, env=env)[mode]
        command_s = run["seconds"]
        check(run["rc"] == 0, f"multiprocess {mode}: exit {run['rc']} (None: timed out)\n"
                              f"{run['stderr'][-6000:]}")
        procs = league_procs(run["stdout"].splitlines())
        (coord,) = procs["coordinator"]
        learners, actors = procs.get("learner", []), procs.get("actor", [])
        check(coord["clean_shutdown"] and coord["worker_exit_codes"] == [0] * (2 + workers)
              and coord["actor_restarts"] == 0,
              f"multiprocess {mode}: exit codes {coord['worker_exit_codes']}, "
              f"{coord['actor_restarts']} actor restarts")
        check(len(learners) == 2 and len(actors) == workers,
              f"multiprocess {mode}: {len(learners)} learner and {len(actors)} actor lines")
        check(all(r["segments_dropped"] == 0 for r in actors),
              f"multiprocess {mode}: segments dropped {[r['segments_dropped'] for r in actors]}")
        for rec in learners + actors + [coord]:
            k = rec["kernels"]
            check(not any("|reference" in t for t in k["dispatch"]) and k["peak_cuda_bytes"],
                  f"multiprocess {mode}: a {rec['process']} ran off the card: {k}")
        got = {}
        for rec in learners:
            steps, n = rec["steps"], rec["kernels"]["launches"]
            check(steps >= MP_STEPS and rec["freezes"] >= 1,
                  f"multiprocess {mode}: learner {rec['role']} {steps} steps, "
                  f"{rec['freezes']} freezes")
            want = {x: steps * per_step["env"][x] for x in n}
            check(n == want, f"multiprocess {mode}: learner {rec['role']} launches {n}, "
                             f"want {want} for {steps} steps")
            check(n["reverse_discounted_scan_p"] == steps
                  and n["flash_attention_bwd_dkv"] == 2 * steps,
                  f"multiprocess {mode}: learner scan/dkv launches {n}")
        segments = 0
        for rec in actors:
            n, segs = rec["kernels"]["launches"], rec["frames_produced"] // seg_frames
            segments += segs
            forwards = 0 if served else segs * (2 * ACT_T + 1)
            want = {x: forwards * per_forward.get(x, 0) for x in n}
            check(n == want, f"multiprocess {mode}: actor {rec['actor']} launches {n}, "
                             f"want {want} for {segs} segments")
        if served:
            check(coord["serving"]["sharded"] is True
                  and coord["serving"]["mesh_shape"] == [1, 1],
                  f"multiprocess {mode}: InfServer sharded {coord['serving']['sharded']}, "
                  f"mesh {coord['serving']['mesh_shape']}")
        n = coord["kernels"]["launches"]
        flushes = coord["serving"]["batches_run"] if served else 0
        want = {x: flushes * per_forward.get(x, 0) for x in n}
        check(n == want, f"multiprocess {mode}: coordinator launches {n}, want {want} "
                         f"for {flushes} flushes")
        for rec in learners + actors + [coord]:
            for x, c in rec["kernels"]["launches"].items():
                got[x] = got.get(x, 0) + c
        for x, c in got.items():
            total[x] = total.get(x, 0) + c
        wall = coord["wall_s"]
        steps = sum(r["steps"] for r in learners)
        runs[mode] = {
            "workers": workers, "served": served, "sharded": served,
            "wall_s": wall, "command_s": command_s,
            "frames_reported": coord["progress"]["frames_total"],
            "frames_per_s": coord["progress"]["frames_total"] / wall,
            # the league once every learner has stepped: start-up and the
            # cold first step behind it, over the coordinator's clock
            "after_first_steps": coord["after_first_steps"],
            "frames_produced": sum(r["frames_produced"] for r in actors),
            "segments": segments, "learner_steps": steps, "learner_steps_per_s": steps / wall,
            "segment_ms_per_actor": 1e3 * wall / max(1, segments / workers),
            "freezes": {r["role"]: r["freezes"] for r in learners},
            "flushes": flushes, "cpu_count": os.cpu_count(),
            # each actor's own rate over its segment loop (start-up excluded),
            # summed: the actors play at once
            "actor_loop_frames_per_s": sum(r["frames_produced"] / r["loop_s"] for r in actors),
            "actor_loop_s": [r["loop_s"] for r in actors],
            # where each worker's loop went (its `seconds`: per part [s, calls,
            # first call's s]): a learner's learn / wait_ready / freeze, an
            # actor's segment / settle / ship; then the steady state, the
            # first call (which warms up the card's libraries) taken out
            "seconds": {**{f"learner/{r['role']}": r["seconds"] for r in learners},
                        **{f"actor/{r['actor']}": r["seconds"] for r in actors}},
            "first_learn_s": [r["seconds"]["learn"][2] for r in learners],
            "first_segment_s": [r["seconds"]["segment"][2] for r in actors],
            "steady_learn_ms": [steady_ms(r["seconds"]["learn"]) for r in learners],
            "steady_segment_ms": [steady_ms(r["seconds"]["segment"]) for r in actors],
            # `run_segment` alone (no settle, no ship), first call out: what
            # the actors could give if nothing else held them
            "actor_segment_only_frames_per_s": sum(
                seg_frames / steady_ms(r["seconds"]["segment"]) * 1e3 for r in actors),
            "peak_cuda_bytes": {"coordinator": coord["kernels"]["peak_cuda_bytes"],
                                **{f"learner/{r['role']}": r["kernels"]["peak_cuda_bytes"]
                                   for r in learners},
                                **{f"actor/{r['actor']}": r["kernels"]["peak_cuda_bytes"]
                                   for r in actors}},
            "segments_unsettled_at_stop": sum(r["segments_unsettled_at_stop"] for r in actors),
            "leases": coord["leases"], "launches": got}
        emit("multiprocess", card=smi, mode=mode, env="pommerman_lite", envs=ACT_E, unroll=ACT_T,
             step_gate=MP_STEP_GATE, max_steps=MP_STEPS, **runs[mode])
    return total, runs


def fleet_phase(dev, cfg, smi, per_forward):
    """`serve_fleet(2)` on the card: two replica processes behind a
    ServingGateway, pommerman_lite obs, 50 rounds of 2 x 64 rows. Both
    replicas served rows and launched exactly their flushes' forwards on
    the card; the rollout shipped θ to both; a probe through the gateway
    agrees with the CPU's plain forward on the same params and obs within
    BWD_TOL of max(1, max |plain|). Rows/s: after the probes have warmed
    both replicas, FLEET_WINDOWS windows of FLEET_WINDOW_ROUNDS rounds at
    the demo's request shape go through the gateway, each followed by the
    same traffic through one in-process InfServer on the card. Returns
    (launches, numbers)."""
    import torch

    from repro_torch.actors.policy import make_obs_policy
    from repro_torch.infserver import InfServer
    from repro_torch.launch.serve import serve_fleet
    from repro_torch.rl import categorical_logp
    from repro_torch.utils import tree_map

    probe, windows = {}, {}

    def on_rollout(gw, params, keys):
        """One probe per lineage (each lineage has its home replica, so
        both replicas serve one and are warm before the timed traffic)."""
        obs = np.random.default_rng(41).integers(0, 8, (FLEET_ROWS, OBS_LEN)).astype(np.int32)
        pol = make_obs_policy(cfg, NUM_ACTIONS)
        for key in keys:
            a, logp, v = gw.get(gw.submit(obs, model=key))
            with torch.no_grad():
                lg, v_ref = pol.logits_values(tree_map(lambda t: t.cpu(), params),
                                              torch.from_numpy(obs).long())
                logp_ref = categorical_logp(lg, torch.from_numpy(a).long())
            for k, got, want in (("logp", logp, logp_ref), ("values", v, v_ref)):
                want = want.float().numpy()
                err = float(np.abs(got - want).max() / max(1.0, float(np.abs(want).max())))
                probe[k] = max(probe.get(k, 0.0), err)
        probe["warm_routed"] = [r["routed_requests"] for r in gw.stats()["replicas"]]
        server = InfServer(cfg, NUM_ACTIONS, params, device=dev, max_batch=256)
        rng = np.random.default_rng(0)
        for _ in range(FLEET_WINDOWS):
            for name, submit, get in (
                    ("gateway", lambda o: gw.submit(o, model=keys[rng.integers(len(keys))],
                                                    deadline_s=FLEET_DEADLINE_MS / 1e3), gw.get),
                    ("inproc", server.submit, server.get)):
                t0 = time.perf_counter()
                for _ in range(FLEET_WINDOW_ROUNDS):
                    tickets = [submit(rng.integers(0, 8, (FLEET_ROWS, OBS_LEN)).astype(np.int32))
                               for _ in range(FLEET_REPLICAS)]
                    for t in tickets:
                        get(t)
                windows.setdefault(name, []).append(
                    FLEET_WINDOW_ROUNDS * FLEET_REPLICAS * FLEET_ROWS
                    / (time.perf_counter() - t0))

    st = serve_fleet(FLEET_REPLICAS, arch=cfg.name, env_name="pommerman_lite",
                     demo_rounds=FLEET_ROUNDS, demo_rows=FLEET_ROWS,
                     deadline_ms=FLEET_DEADLINE_MS, verbose=False, on_rollout=on_rollout)
    check(max(probe["logp"], probe["values"]) <= BWD_TOL["bfloat16"],
          f"fleet: probe off the CPU's plain forward by {probe}")
    check(probe["warm_routed"] == [1] * FLEET_REPLICAS,
          f"fleet: the probes reached the replicas {probe['warm_routed']} times, want once each")
    check(all(r["shipped_to"] == FLEET_REPLICAS for r in st["rollouts"].values()),
          f"fleet: rollout shipped to {[r['shipped_to'] for r in st['rollouts'].values()]}")
    reps = st["replica_reports"]
    check(len(reps) == FLEET_REPLICAS and all(r["rows_served"] > 0 for r in reps),
          f"fleet: replicas served {[r.get('rows_served') for r in reps]} rows")
    launches = {}
    for r in reps:
        k = r["kernels"]
        check(not any("|reference" in t for t in k["dispatch"]) and k["peak_cuda_bytes"],
              f"fleet: a replica ran off the card: {k}")
        want = {x: r["batches_run"] * per_forward.get(x, 0) for x in k["launches"]}
        check(k["launches"] == want, f"fleet: replica launches {k['launches']}, want {want}")
        for x, c in k["launches"].items():
            launches[x] = launches.get(x, 0) + c
    out = {"replicas": FLEET_REPLICAS, "rounds": FLEET_ROUNDS, "rows_per_request": FLEET_ROWS,
           "window_rounds": FLEET_WINDOW_ROUNDS,
           "gateway_rows_per_s": statistics.median(windows["gateway"]),
           "inproc_rows_per_s": statistics.median(windows["inproc"]),
           "gateway_windows_rows_per_s": windows["gateway"],
           "inproc_windows_rows_per_s": windows["inproc"],
           "demo_rows_per_s": st["demo"]["rows_per_s"], "demo_s": st["demo"]["seconds"],
           "probe_rel_err": {k: probe[k] for k in ("logp", "values")},
           "rollout_bytes": {k: r["bytes_shipped"] for k, r in st["rollouts"].items()},
           "rollout_ms": {k: r["propagation_ms"] for k, r in st["rollouts"].items()},
           "replica_rows": [r["rows_served"] for r in reps],
           "replica_batches": [r["batches_run"] for r in reps],
           "replica_mean_batch_ms": [r["mean_batch_latency_ms"] for r in reps],
           "deadlines": st["deadlines"], "failovers": st["failovers"],
           "peak_cuda_bytes": [r["kernels"]["peak_cuda_bytes"] for r in reps]}
    emit("fleet", card=smi, launches=launches, **out)
    return launches, out


# the fault path: the port's four fault smokes (tests/smoke_torch_*.py) as
# subprocesses on the card, each in a session of its own under its own
# timeout; shm and kill-coordinator side by side, chaos and serving alone
# (their thresholds are timings)
FAULT_GROUPS = (("shm", "kill_coordinator"), ("chaos",), ("serving",))
FAULT_TIMEOUT_S = {"shm": 90, "kill_coordinator": 150, "chaos": 240, "serving": 180}
# the examples (examples/torch_*.py), called in this process
EXAMPLE_ARGS = {"quickstart": [], "rps_nash": ["--iters", "8"],
                "pommerman_league": ["--periods", "1", "--steps", "8",
                                     "--eval-episodes", "4"],
                "pommerman_league_async": ["--periods", "1", "--steps", "8",
                                           "--eval-episodes", "4", "--async-seconds", "15"],
                "serve_policy": []}


def run_smokes(names):
    """Run the smokes in `names` at once (`run_commands`), each on the card
    under its own timeout. Returns name -> {rc, result (its last JSON line),
    seconds, stdout and stderr tails}."""
    runs = run_commands({name: ([sys.executable, str(ROOT / "tests" / f"smoke_torch_{name}.py"),
                                 "--device", "cuda"], FAULT_TIMEOUT_S[name]) for name in names})
    out = {}
    for name, run in runs.items():
        last = next((ln for ln in reversed(run["stdout"].splitlines()) if ln.startswith("{")),
                    None)
        out[name] = {"rc": run["rc"], "seconds": run["seconds"],
                     "result": json.loads(last) if last else None,
                     "stdout": run["stdout"][-4000:], "stderr": run["stderr"][-4000:]}
    return out


def faults_phase(smi, names):
    """The league under real faults on the card: the port's four fault
    smokes (`tests/smoke_torch_{shm,kill_coordinator,chaos,serving}.py`
    with `--device cuda`), each passing its twin's criteria. Every child
    that lived to print its `{"process": ...}` line ran on the card (card
    memory in use, no plain version); the others (killed by the scenario)
    were started with `--device cuda`, and the shm producer drew its
    frames on the card. Each learner launched RMSNorm, the forward, dq,
    dk/dv and the scan. Returns (launches summed over every child's line,
    numbers)."""
    import torch

    torch.cuda.empty_cache()               # the smokes' processes share the card
    t_phase = time.perf_counter()
    runs = {}
    for group in FAULT_GROUPS:
        runs.update(run_smokes(group))
    total, out = dict.fromkeys(names, 0), {}
    for name, run in runs.items():
        res = run["result"]
        check(run["rc"] == 0 and res is not None and res["ok"],
              f"faults: smoke {name} failed (exit {run['rc']})\n{run['stdout']}\n{run['stderr']}")
        check(res["device"].startswith("cuda"), f"faults: smoke {name} ran on {res['device']}")
        for child, rec in res["processes"].items():
            k = rec["kernels"]
            if k is None:
                continue                   # killed by the scenario before it printed
            check(k["peak_cuda_bytes"] and not any("|reference" in t for t in k["dispatch"]),
                  f"faults: {name}'s {child} ran off the card or on a plain version: {k}")
            for x, c in k["launches"].items():
                total[x] = total.get(x, 0) + c
            if child == "learner":
                check(all(k["launches"][x] > 0 for x in k["launches"]),
                      f"faults: {name}'s learner did not launch every kernel: {k['launches']}")
        out[name] = {"command_s": run["seconds"], **res}
    check(out["shm"]["child_device"].startswith("cuda"),
          f"faults: the shm producer's frames lay on {out['shm']['child_device']}")
    seconds = time.perf_counter() - t_phase
    emit("faults", card=smi, seconds=seconds, launches=total, smokes=out)
    return total, {"seconds": seconds, "smokes": out}


def load_example(name):
    """`examples/torch_<name>.py` as a module (`examples/` is no package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"torch_{name}",
                                                  ROOT / "examples" / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def examples_phase(counters, smi, per_forward, per_step):
    """The port's four examples on the card, each through its `main(argv)`
    with `--device cuda`, no plain version on the card:
    - quickstart (rps, 16 envs x 8, 2 periods x 8 iterations): finite
      losses, 2 freezes, throughput above 0, and launches of exactly its 16
      learner steps and its segments' 2T + 1 forwards each, as
      `league_loop` counts them;
    - rps_nash `--iters 8`, independent and FSP: every distribution sums
      to 1 within 1e-5; max |p - 1/3| and the mean peak are recorded, not
      gated (the twin asserts nothing there);
    - pommerman_league `--periods 1 --steps 8`, lockstep, then with
      `--async-seconds`: each win rate in [0, 1]; lockstep freezes both
      roles once, the runtime at least one role;
    - serve_policy: finite logits, the decode ms per token, 32 requests in
      the one batch `max_batch=32` allows.
    Returns (launches summed over the examples, numbers)."""
    out, total = {}, {}
    for name, args in EXAMPLE_ARGS.items():
        mod = load_example(name.removesuffix("_async"))
        zero(counters)
        t0 = time.perf_counter()
        res = mod.main(["--device", "cuda"] + args)
        seconds = time.perf_counter() - t0
        got = read(counters)
        check_on_card(f"examples {name}")
        for x, c in got.items():
            total[x] = total.get(x, 0) + c
        rec = {"seconds": seconds, "launches": got}
        if name == "quickstart":
            steps, T = res["learner_steps"], res["unroll_len"]
            check(steps == 16 and np.isfinite(res["losses"]).all(),
                  f"examples quickstart: {steps} steps, losses {res['losses']}")
            check(res["league"]["num_freezes"] == 2, f"examples quickstart: {res['league']}")
            check(res["throughput"]["rfps"] > 0 and res["throughput"]["cfps"] > 0,
                  f"examples quickstart: throughput {res['throughput']}")
            want = {x: steps * ((2 * T + 1) * per_forward.get(x, 0) + per_step["env"][x])
                    for x in got}
            check(got == want, f"examples quickstart: launches {got}, want {want}")
            rec.update(losses=[round(x, 4) for x in res["losses"]], league=res["league"],
                       throughput=res["throughput"])
        elif name == "rps_nash":
            for mode, r in res.items():
                check(r["dists"].shape == (8, 3)
                      and np.abs(r["dists"].sum(1) - 1).max() <= 1e-5,
                      f"examples rps_nash {mode}: distributions {r['dists']}")
            rec.update({mode: {"final": r["final"].round(4).tolist(), "max_dev": r["max_dev"],
                               "avg_peak": r["avg_peak"]} for mode, r in res.items()},
                       fsp_closer_to_uniform=res["fsp"]["max_dev"] < res["independent"]["max_dev"])
        elif name.startswith("pommerman_league"):
            state = res["league_states"][0]
            check(all(0.0 <= w <= 1.0 for w in res["curve"]),
                  f"examples {name}: win rates {res['curve']}")
            check(state["num_freezes"] == 2 if name == "pommerman_league"
                  else state["num_freezes"] >= 1, f"examples {name}: league {state}")
            rec.update(curve=res["curve"], league=state)
        else:
            check(np.isfinite(res["logits"]).all(), "examples serve_policy: non-finite logits")
            check(res["requests_served"] == 32 and res["batches_run"] == 1,
                  f"examples serve_policy: {res['requests_served']} requests in "
                  f"{res['batches_run']} batches")
            rec.update(decode_ms_per_token=res["decode_ms_per_token"],
                       cache_length=res["cache_length"], tokens0=res["tokens"][0].tolist())
        out[name] = rec
    for x in ("rmsnorm", "flash_attention_fwd", "flash_attention_bwd_dq",
              "flash_attention_bwd_dkv", "reverse_discounted_scan_p"):
        check(total[x] > 0, f"examples: {x} never launched")
    emit("examples", card=smi, launches=total, examples=out)
    return total, out


def norms_per_pass(cfg):
    """RMSNorm launches per prefill or decode step: the attention and MLP
    norms of every layer, the post-block norms (gemma2) and the q/k norms
    (qwen3) where the config has them, and the final norm; none for a
    LayerNorm config (command-r's norms are plain PyTorch, as in `repro`)."""
    if cfg.norm != "rmsnorm":
        return 0
    return (2 + 2 * cfg.post_block_norms + 2 * cfg.qk_norm) * cfg.num_layers + 1


def counted_run(counters, total, fn, want, what):
    """fn() with the launch counts set to 0 just before and read just
    after: they must equal `want` exactly; they are added to `total`."""
    zero(counters)
    res = fn()
    got = read(counters)
    for k in got:
        total[k] += got[k]
    check(got == {k: want.get(k, 0) for k in got}, f"{what}: launches {got}, want {want}")
    check_on_card(what)
    return res


def finite(*ts):
    return all(bool(t.float().isfinite().all()) for t in ts)


def ring(state):
    """(min, max) position held in the first layer's cache."""
    pos = state["blocks"]["kv0"]["pos"]
    return int(pos.min()), int(pos.max())


def held(state):
    """The distinct counts of valid slots (pos >= 0) over every layer's
    cache and every row."""
    return sorted({n for c in state["blocks"].values() if isinstance(c, dict)
                   for n in (c["pos"] >= 0).sum(-1).flatten().tolist()})


def decode_phase(dev, counters, smi):
    """The dense family's serving path (prefill, the ring-buffer KV cache,
    decode_step) at full width in the configs' dtypes: gemma2-2b and
    qwen3-8b at full depth (bf16 compute over fp32 params), command-r-35b
    and mistral-large-123b (bf16) at DECODE_ARCHS' depth. Per arch:

    - gemma2-2b and qwen3-8b: `launch.serve.serve` (the decode demo) on
      DECODE_B x DECODE_T prompts, greedy, with exactly its prefill's and
      its steps' launches;
    - DECODE_PREFILLS timed prefills and DECODE_ARCHS' greedy uniform steps,
      then a uniform=False step and one step under
      `set_sync_debug_mode("error")`, each with exactly its launches
      (RMSNorm `norms_per_pass`; the flash forward once per layer per
      prefill, never in a step); a prefill and 3 steps profiled;
    - decode(T | prefill(0..T-1)) against forward_train(0..T) at position
      T: at fp32 compute within CONSISTENCY_TOL of max(1, max |logits|);
      the same at bf16 compute recorded;
    - gemma2-2b only: a SLIDING_T prompt over the 4096-slot ring, the
      long_500k shape (`init_decode_state(cfg, 1, 524288, sliding=True)`),
      and the InfServer over its backbone (examples/serve_policy.py step
      3): INF_REQUESTS requests in one flush;
    - gemma2-2b and qwen3-8b: card vs CPU, one repeat unit at full width,
      fp32 compute, a prefill of DECODE_CPU_T (> reserve) tokens and
      DECODE_CPU_STEPS steps: logits, values and every cache leaf within
      CARD_VS_CPU_TOL of max(1, max |cpu|), positions and lengths equal."""
    import torch

    from repro_torch.configs import INPUT_SHAPES, get_arch
    from repro_torch.infserver import InfServer
    from repro_torch.launch.serve import serve
    from repro_torch.models import (decode_step, forward_train, init_decode_state, init_params,
                                    prefill)
    from repro_torch.utils import tree_flatten_with_path, tree_map

    t_phase = time.perf_counter()
    rng = np.random.default_rng(9)
    names = [c.__name__ for c in counters]
    total = dict.fromkeys(names, 0)
    out = {}

    counted = lambda fn, want, what: counted_run(counters, total, fn, want, what)

    for arch, (steps, depth) in DECODE_ARCHS.items():
        t_arch = time.perf_counter()
        cfg = get_arch(arch)
        if depth:
            cfg = dataclasses.replace(cfg, num_layers=depth)
        L = cfg.num_layers
        per_prefill = {"rmsnorm": norms_per_pass(cfg), "flash_attention_fwd": L}
        per_step = {"rmsnorm": norms_per_pass(cfg)}
        rec = {"layers": L, "published_layers": get_arch(arch).num_layers,
               "launches_per_prefill": per_prefill, "launches_per_step": per_step}
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        parts, t_part = {}, [time.perf_counter()]

        def part(name):
            """The seconds since the last part, recorded under `name`."""
            now = time.perf_counter()
            parts[name], t_part[0] = now - t_part[0], now

        if arch in DECODE_EXTRAS:                 # the user's entry point at full width
            demo = counted(lambda: serve(arch, smoke=False, batch=DECODE_B,
                                         prompt_len=DECODE_T, new_tokens=steps,
                                         temperature=0.0, device=dev),
                           {k: per_prefill.get(k, 0) + steps * per_step.get(k, 0)
                            for k in names}, f"{arch} serve demo")
            check(len(demo) == steps and all(t.shape == (DECODE_B, 1) for t in demo),
                  f"{arch} serve demo: tokens")
            del demo
        part("demo")

        with torch.inference_mode():
            params = init_params(torch.Generator(device=dev).manual_seed(11), cfg)
            rec["params"] = sum(a.numel() for _, a in tree_flatten_with_path(params)[0])
            toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (DECODE_B, DECODE_T))).to(dev)
            batch = {"tokens": toks}

            prefill_ms = []                   # one warm-up, then DECODE_PREFILLS timed
            for i in range(1 + DECODE_PREFILLS):
                ms, (logits, values, state) = counted(
                    lambda: sync_wall(lambda: prefill(params, cfg, batch)), per_prefill,
                    f"{arch} prefill")
                check(logits.shape == (DECODE_B, DECODE_T, cfg.vocab_size)
                      and finite(logits[:, -1], values), f"{arch} prefill: outputs")
                prefill_ms += [ms] if i else []
            tok = first_tok = logits[:, -1:].argmax(-1)
            del logits, values
            check(tuple(state["blocks"]["kv0"]["k"].shape[:3])
                  == (L // len(cfg.layer_pattern), DECODE_B, DECODE_T + 64)
                  and ring(state) == (-1, DECODE_T - 1) and held(state) == [DECODE_T],
                  f"{arch} prefill: the whole prompt in the cache, {ring(state)}, {held(state)}")

            def step(uniform=True, window=0):
                nonlocal tok, state
                lg, v, state = decode_step(params, cfg, tok, state, window=window,
                                           uniform=uniform)
                tok = lg[:, -1:].argmax(-1)
                return lg, v

            step_ms, first = [], None
            for i in range(steps):
                ms, (lg, v) = counted(lambda: sync_wall(step), per_step, f"{arch} decode step")
                check(lg.shape == (DECODE_B, 1, cfg.vocab_size) and finite(lg, v),
                      f"{arch} decode step {i}: outputs")
                first = lg[:, 0].float() if first is None else first
                step_ms.append(ms)
            lg, v = counted(lambda: step(uniform=False), per_step, f"{arch} uniform=False step")
            check(finite(lg, v), f"{arch} uniform=False step: outputs")
            # no host sync inside a step: the write slot stays on the card
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                counted(step, per_step, f"{arch} decode step under sync debug")
            finally:
                torch.cuda.set_sync_debug_mode(0)
            check(int(state["length"][0]) == DECODE_T + steps + 2
                  and ring(state) == (-1, DECODE_T + steps + 1)
                  and held(state) == [DECODE_T + steps + 2],
                  f"{arch}: state after {steps + 2} steps, {ring(state)}, {held(state)}")
            zero(counters)
            rec["profile_decode_step"] = profiled(step, 3)
            rec["profile_prefill"] = profiled(lambda: prefill(params, cfg, batch), 1)
            for k, n in read(counters).items():
                total[k] += n
            check_on_card(f"{arch} profiled")
            del state
            part("prefill_steps_profiles")

            # consistency: the first decoded token's logits against
            # forward_train over the prompt and that token, at position T
            full = {"tokens": torch.cat([toks, first_tok], 1)}
            cons = {"bfloat16": rel_err(first, forward_train(params, cfg, full)[0][:, DECODE_T])}
            cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
            _, _, st32 = prefill(params, cfg32, batch)
            d32, dv32, _ = decode_step(params, cfg32, first_tok, st32)
            del st32
            f32, fv32, _ = forward_train(params, cfg32, full)
            cons["float32"] = max(rel_err(d32[:, 0], f32[:, DECODE_T]),
                                  rel_err(dv32[:, 0], fv32[:, DECODE_T]))
            del f32, fv32
            check(cons["float32"] <= CONSISTENCY_TOL,
                  f"{arch}: decode vs forward_train at fp32 {cons['float32']} > {CONSISTENCY_TOL}")
            # bf16 is recorded, not held: decode scores attention in bf16
            # (`_attend`, as `repro`'s decode does) and the prefill kernel in
            # fp32 from bf16 inputs, and 26-36 bf16 layers carry the two
            # roundings apart; the fp32 comparison above holds the algorithm
            rec["consistency"] = {**cons, "tol": {"float32": CONSISTENCY_TOL}}
            part("consistency")

            if arch == "gemma2-2b":
                W = cfg.long_context_window
                # sliding: the last W prompt keys in a ring of W, the local
                # layers windowed in prefill, every layer at window W in decode
                stoks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, SLIDING_T))).to(dev)
                ms_p, (lg, v, state) = counted(
                    lambda: sync_wall(lambda: prefill(params, cfg, {"tokens": stoks},
                                                      sliding=True)),
                    per_prefill, f"{arch} sliding prefill")
                check(finite(lg[:, -1], v) and state["blocks"]["kv0"]["k"].shape[2] == W
                      and ring(state) == (SLIDING_T - W, SLIDING_T - 1) and held(state) == [W],
                      f"{arch} sliding prefill: ring {ring(state)}, {held(state)}")
                tok = lg[:, -1:].argmax(-1)
                del lg, v
                sms = []
                for _ in range(SLIDING_STEPS):
                    ms, (lg, v) = counted(lambda: sync_wall(lambda: step(window=W)), per_step,
                                          f"{arch} sliding step")
                    check(finite(lg, v), f"{arch} sliding step: outputs")
                    sms.append(ms)
                n = SLIDING_T + SLIDING_STEPS
                check(ring(state) == (n - W, n - 1) and held(state) == [W],
                      f"{arch} sliding: ring after {SLIDING_STEPS} steps {ring(state)}")
                rec["sliding"] = {"prompt": SLIDING_T, "ring": W, "prefill_ms": ms_p,
                                  "decode_ms_median": statistics.median(sms)}

                # long_500k: the assigned shape over the same O(window) ring
                shape = INPUT_SHAPES["long_500k"]
                state = init_decode_state(cfg, shape.global_batch, shape.seq_len, sliding=True,
                                          device=dev)
                tok = torch.zeros((shape.global_batch, 1), dtype=torch.long, device=dev)
                lms = []
                for _ in range(LONG_STEPS):
                    ms, (lg, v) = counted(lambda: sync_wall(lambda: step(window=W)), per_step,
                                          f"{arch} long_500k step")
                    check(finite(lg, v), f"{arch} long_500k step: outputs")
                    lms.append(ms)
                check(int(state["length"][0]) == shape.seq_len + LONG_STEPS
                      and state["blocks"]["kv0"]["k"].shape[2] == W,
                      f"{arch} long_500k: length {int(state['length'][0])}")
                rec["long_500k"] = {
                    "seq_len": shape.seq_len, "ring": W,
                    "decode_ms_median": statistics.median(lms),
                    "state_mb": sum(a.numel() * a.element_size()
                                    for _, a in tree_flatten_with_path(state)[0]) / 2 ** 20}
                del state

                # the InfServer over the gemma2-2b backbone: one flush
                server = InfServer(cfg, 16, params, max_batch=INF_REQUESTS, device=dev)

                def flush():
                    tickets = [server.submit(np.zeros((1, INF_OBS_LEN), np.int32))
                               for _ in range(INF_REQUESTS)]
                    return [server.get(t) for t in tickets]
                res = counted(flush, per_prefill, f"{arch} InfServer flush")
                check(server.batches_run == 1 and server.requests_served == INF_REQUESTS
                      and all(np.isfinite(r[1]).all() and np.isfinite(r[2]).all() for r in res),
                      f"{arch} InfServer: {server.batches_run} flushes")
                rec["infserver"] = {"requests": INF_REQUESTS, "flushes": server.batches_run,
                                    "flush_ms": 1e3 * server.last_batch_latency_s}
                del server
            del params
        part("sliding_long_infserver")
        rec.update(prefill_ms_median=statistics.median(prefill_ms),
                   prefill_ms_each=[round(x, 3) for x in prefill_ms],
                   decode_ms_median=statistics.median(step_ms),
                   decode_ms_each=[round(x, 3) for x in step_ms],
                   peak_cuda_mb=torch.cuda.max_memory_allocated() / 2 ** 20)
        torch.cuda.empty_cache()

        # card vs CPU: one repeat unit at full width, fp32 compute
        if arch in DECODE_EXTRAS:
            cfg1 = dataclasses.replace(cfg, num_layers=len(cfg.layer_pattern),
                                       compute_dtype="float32")
            ctoks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                  (DECODE_CPU_B, DECODE_CPU_T + DECODE_CPU_STEPS)))

            def run(p, d):
                lg, v, st = prefill(p, cfg1, {"tokens": ctoks[:, :DECODE_CPU_T].to(d)})
                outs = [lg, v]
                for i in range(DECODE_CPU_T, DECODE_CPU_T + DECODE_CPU_STEPS):
                    lg, v, st = decode_step(p, cfg1, ctoks[:, i:i + 1].to(d), st, uniform=i % 2 == 0)
                    outs += [lg, v]
                return outs, st

            with torch.inference_mode():
                p_dev = init_params(torch.Generator(device=dev).manual_seed(12), cfg1)
                o_cpu, s_cpu = run(tree_map(lambda a: a.cpu(), p_dev), torch.device("cpu"))
                zero(counters)
                o_dev, s_dev = run(p_dev, dev)
                for k, n in read(counters).items():
                    total[k] += n
                check_on_card(f"{arch} card vs CPU")
                errs = {"logits_values": max(rel_err(a.cpu(), b) for a, b in zip(o_dev, o_cpu))}
                leaves = list(zip(tree_flatten_with_path(s_dev)[0], tree_flatten_with_path(s_cpu)[0]))
                errs["cache"] = max(rel_err(a.cpu(), b) for (_, a), (_, b) in leaves
                                    if a.is_floating_point())
                check(all(torch.equal(a.cpu(), b) for (_, a), (_, b) in leaves
                          if not a.is_floating_point()), f"{arch} card vs CPU: positions differ")
                for what, e in errs.items():
                    check(e <= CARD_VS_CPU_TOL,
                          f"{arch} decode card vs CPU ({what}): {e} > {CARD_VS_CPU_TOL}")
                rec["card_vs_cpu"] = {"layers": cfg1.num_layers, "batch": DECODE_CPU_B,
                                      "prompt": DECODE_CPU_T, "steps": DECODE_CPU_STEPS,
                                      "max_err": errs, "tol": CARD_VS_CPU_TOL}
                del p_dev, s_dev, o_dev
            torch.cuda.empty_cache()
        part("card_vs_cpu")
        rec["seconds_by_part"] = parts
        rec["seconds"] = time.perf_counter() - t_arch
        out[arch] = rec
        emit("decode", card=smi, arch=arch, compute_dtype=cfg.compute_dtype,
             param_dtype=cfg.param_dtype, batch=DECODE_B, prompt=DECODE_T, steps=steps, **rec)
    emit("decode_phase", card=smi, seconds=time.perf_counter() - t_phase, launches=total)
    return total, out


@contextlib.contextmanager
def moe_routes():
    """Every `route_topk` call of the port's MoE inside the block, recorded
    as (slot, keep) device tensors: no host sync, no device op."""
    from repro_torch.models import moe
    orig, calls = moe.route_topk, []

    def route(gates, k, capacity):
        res = orig(gates, k, capacity)
        calls.append((res[0], res[2]))
        return res
    moe.route_topk = route
    try:
        yield calls
    finally:
        moe.route_topk = orig


def dropped(calls):
    """Expert choices sent to the drop bucket over the recorded routes."""
    return sum(int((~keep).sum()) for _, keep in calls)


def family_norms(cfg):
    """RMSNorm launches per prefill or decode step: `norms_per_pass` plus
    the hybrid's two output norms per layer; none for rwkv6, whose norms
    are all LayerNorms (plain PyTorch, as in `repro`)."""
    if cfg.norm != "rmsnorm":
        return 0
    return norms_per_pass(cfg) + 2 * cfg.num_layers * (cfg.family == "hybrid")


def families_phase(dev, counters, smi):
    """The moe, ssm, hybrid and vlm families' serving path at full width,
    one arch at a time (FAMILY_DEPTH cuts the MoE archs' depth to fit the
    card, and rwkv6's and hymba's for time), memory freed between archs.
    Per arch:

    - pixtral, rwkv6 and hymba: the decode demo (`launch.serve.serve`,
      token prompts as `repro`'s demo) at full depth (rwkv6's and hymba's
      at FAMILY_PROMPT tokens), with exactly its launches;
    - DECODE_PREFILLS timed prefills of DECODE_B x DECODE_T tokens
      (pixtral after PATCHES seeded patch embeddings; rwkv6 and hymba at
      FAMILY_PROMPT tokens) and FAMILY_STEPS
      greedy uniform steps, a uniform=False step and one step under
      `set_sync_debug_mode("error")` (MoE routing and the recurrent
      states included), each with exactly its launches (RMSNorm
      `family_norms`, the flash forward once per attention layer per
      prefill and never in a step); the MoE choices dropped at prefill; a
      step and a prefill profiled; the cache's valid slots per layer and
      row;
    - hymba: the long_500k shape over its 1024-slot ring; rwkv6: steps at
      length 524,288 (its state is O(1));
    - decode(T | prefill) against forward_train at position T at fp32
      compute within CONSISTENCY_TOL of max(1, max |logits|); for the MoE
      archs on a MOE_CONS_B x MOE_CONS_T prompt at which both runs drop no
      choice (asserted), kimi-k2's at bf16 compute within
      BF16_CONSISTENCY_TOL; for the recurrent archs (rwkv6, hymba) the
      states after position T, by prefill + step and by one prefill over
      T + 1 tokens, compared layer by layer (the first layer within
      STATE_TOL: both routes feed it the same embeddings);
    - rwkv6: the same seeded prefill + step against forward_train at fp64
      compute (its fp32 params), recorded with the states by layer;
    - card vs CPU at fp32 compute: one unit (kimi-k2's: its dense prefix
      (`_group_sizes`' first group) and one MoE layer with its shared
      expert, the experts cut to KIMI_CPU_EXPERTS, since its full MoE unit
      would need a 67.6 GB fp32 copy of its experts), a
      prefill of DECODE_CPU_T tokens (pixtral after 16 patches) and
      DECODE_CPU_STEPS steps: the routing slots equal, logits and values
      within CARD_VS_CPU_TOL and every state leaf within STATE_TOL of
      max(1, max |cpu|), positions and lengths equal."""
    import torch

    from repro_torch.configs import INPUT_SHAPES, get_arch
    from repro_torch.launch.serve import serve
    from repro_torch.models import (decode_step, forward_train, init_decode_state, init_params,
                                    prefill)
    from repro_torch.utils import tree_flatten_with_path, tree_map

    t_phase = time.perf_counter()
    rng = np.random.default_rng(13)
    names = [c.__name__ for c in counters]
    total = dict.fromkeys(names, 0)
    counted = lambda fn, want, what: counted_run(counters, total, fn, want, what)
    out = {}
    for arch, depth in FAMILY_DEPTH.items():
        t_arch = time.perf_counter()
        cfg = get_arch(arch)
        if depth:
            cfg = dataclasses.replace(cfg, num_layers=depth)
        L, attn = cfg.num_layers, cfg.family != "ssm"
        prompt = FAMILY_PROMPT.get(arch, DECODE_T)
        per_prefill = {"rmsnorm": family_norms(cfg), "flash_attention_fwd": L * attn}
        per_step = {"rmsnorm": family_norms(cfg)}
        rec = {"layers": L, "published_layers": get_arch(arch).num_layers,
               "launches_per_prefill": per_prefill, "launches_per_step": per_step}
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

        if depth is None or arch in FAMILY_DEMO:  # the user's entry point, at full depth
            full = get_arch(arch)
            demo_want = {"rmsnorm": (FAMILY_STEPS + 1) * family_norms(full),
                         "flash_attention_fwd": full.num_layers * attn}
            demo = counted(lambda: serve(arch, smoke=False, batch=DECODE_B, prompt_len=prompt,
                                         new_tokens=FAMILY_STEPS, temperature=0.0, device=dev),
                           {k: demo_want.get(k, 0) for k in names}, f"{arch} serve demo")
            check(len(demo) == FAMILY_STEPS and all(t.shape == (DECODE_B, 1) for t in demo),
                  f"{arch} serve demo: tokens")
            del demo

        with torch.inference_mode():
            params = init_params(torch.Generator(device=dev).manual_seed(11), cfg)
            toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (DECODE_B, prompt))).to(dev)
            batch = {"tokens": toks}
            if cfg.family == "vlm":
                batch["patch_embeds"] = torch.randn(
                    DECODE_B, PATCHES, cfg.d_model, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(14))
            T = prompt + (PATCHES if cfg.family == "vlm" else 0)

            prefill_ms = []                   # one warm-up, then DECODE_PREFILLS timed
            for i in range(1 + DECODE_PREFILLS):
                with moe_routes() as routes:
                    ms, (logits, values, state) = counted(
                        lambda: sync_wall(lambda: prefill(params, cfg, batch)), per_prefill,
                        f"{arch} prefill")
                check(logits.shape == (DECODE_B, T, cfg.vocab_size)
                      and finite(logits[:, -1], values), f"{arch} prefill: outputs")
                prefill_ms += [ms] if i else []
            if cfg.moe:
                rec["moe_dropped_at_prefill"] = dropped(routes)
                rec["moe_choices_at_prefill"] = (DECODE_B * T * cfg.moe.experts_per_token
                                                 * len(routes))
            tok = first_tok = logits[:, -1:].argmax(-1)
            del logits, values, routes
            if attn:
                check(tuple(state["blocks"]["kv0"]["k"].shape[1:3]) == (DECODE_B, T + 64)
                      and ring(state) == (-1, T - 1) and held(state) == [T],
                      f"{arch} prefill: the whole prompt in the cache, {ring(state)}, "
                      f"{held(state)}")
            check(int(state["length"][0]) == T and all(
                finite(a) for _, a in tree_flatten_with_path(state)[0] if a.is_floating_point()),
                f"{arch} prefill: state")

            def step(uniform=True, window=0):
                nonlocal tok, state
                lg, v, state = decode_step(params, cfg, tok, state, window=window,
                                           uniform=uniform)
                tok = lg[:, -1:].argmax(-1)
                return lg, v

            step_ms = []
            for i in range(FAMILY_STEPS):
                ms, (lg, v) = counted(lambda: sync_wall(step), per_step, f"{arch} decode step")
                check(lg.shape == (DECODE_B, 1, cfg.vocab_size) and finite(lg, v),
                      f"{arch} decode step {i}: outputs")
                step_ms.append(ms)
            lg, v = counted(lambda: step(uniform=False), per_step, f"{arch} uniform=False step")
            check(finite(lg, v), f"{arch} uniform=False step: outputs")
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                counted(step, per_step, f"{arch} decode step under sync debug")
            finally:
                torch.cuda.set_sync_debug_mode(0)
            n = T + FAMILY_STEPS + 2
            check(int(state["length"][0]) == n
                  and (not attn or (ring(state) == (-1, n - 1) and held(state) == [n])),
                  f"{arch}: state after {FAMILY_STEPS + 2} steps")
            zero(counters)
            rec["profile_decode_step"] = profiled(step, 3)
            rec["profile_prefill"] = profiled(lambda: prefill(params, cfg, batch), 1)
            for k, c in read(counters).items():
                total[k] += c
            check_on_card(f"{arch} profiled")
            del state

            if arch in ("hymba-1.5b", "rwkv6-3b"):
                # long_500k: hymba over its ring of long_context_window
                # slots, rwkv6 over its O(1) state
                shape = INPUT_SHAPES["long_500k"]
                W = cfg.long_context_window if attn else 0
                state = init_decode_state(cfg, shape.global_batch, shape.seq_len,
                                          sliding=attn, device=dev)
                tok = torch.zeros((shape.global_batch, 1), dtype=torch.long, device=dev)
                lms = []
                for _ in range(LONG_STEPS):
                    ms, (lg, v) = counted(lambda: sync_wall(lambda: step(window=W)), per_step,
                                          f"{arch} long_500k step")
                    check(finite(lg, v), f"{arch} long_500k step: outputs")
                    lms.append(ms)
                n = shape.seq_len + LONG_STEPS
                check(int(state["length"][0]) == n
                      and (not attn or (state["blocks"]["kv0"]["k"].shape[2] == W
                                        and ring(state)[1] == n - 1 and held(state) == [W])),
                      f"{arch} long_500k: state after {LONG_STEPS} steps")
                rec["long_500k"] = {
                    "seq_len": shape.seq_len, "ring": W or None,
                    "decode_ms_median": statistics.median(lms),
                    "state_mb": sum(a.numel() * a.element_size()
                                    for _, a in tree_flatten_with_path(state)[0]) / 2 ** 20}
                del state
            rec.update(prefill_ms_median=statistics.median(prefill_ms),
                       prefill_ms_each=[round(x, 3) for x in prefill_ms],
                       decode_ms_median=statistics.median(step_ms),
                       decode_ms_each=[round(x, 3) for x in step_ms],
                       peak_cuda_mb=torch.cuda.max_memory_allocated() / 2 ** 20)

            # decode against forward_train at position T
            kimi = arch == "kimi-k2-1t-a32b"
            ccfg = cfg if kimi else dataclasses.replace(cfg, compute_dtype="float32")
            if cfg.moe:
                ctoks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                      (MOE_CONS_B, MOE_CONS_T + 1))).to(dev)
                short, full, last, pos = ({"tokens": ctoks[:, :-1]}, {"tokens": ctoks},
                                          ctoks[:, -1:], MOE_CONS_T)
            else:
                short, full, last, pos = (batch, {**batch, "tokens": torch.cat([toks, first_tok], 1)},
                                          first_tok, T)
            with moe_routes() as routes:
                pl, _, st = prefill(params, ccfg, short)
                del pl
                d, dv, st = decode_step(params, ccfg, last, st)
                f, fv, _ = forward_train(params, ccfg, full)
            drops = dropped(routes)
            check(drops == 0, f"{arch}: decode vs forward_train dropped {drops} choices")
            err = max(rel_err(d[:, 0], f[:, pos]), rel_err(dv[:, 0], fv[:, pos]))
            del f, fv, routes
            tol = BF16_CONSISTENCY_TOL if kimi else CONSISTENCY_TOL
            check(err <= tol, f"{arch}: decode vs forward_train at {ccfg.compute_dtype} "
                              f"{err} > {tol}")
            rec["consistency"] = {"compute_dtype": ccfg.compute_dtype, "err": err, "tol": tol,
                                  "prompt": [d.shape[0], pos], "moe_dropped": drops}
            if cfg.family in ("ssm", "hybrid"):
                _, _, sf = prefill(params, ccfg, full)
                keys = [k for k, c in st["blocks"].items() if not isinstance(c, dict)]
                by_layer = [max(rel_err(st["blocks"][k][r], sf["blocks"][k][r]) for k in keys)
                            for r in range(st["blocks"][keys[0]].shape[0])]
                check(by_layer[0] <= STATE_TOL,
                      f"{arch}: first layer's states, prefill + step vs prefill over T + 1: "
                      f"{by_layer[0]} > {STATE_TOL}")
                rec["consistency"]["state_err_by_layer"] = by_layer
                del sf
            if arch == "rwkv6-3b":
                # the rounding witness: the same seeded prefill + step
                # against forward_train at fp64 compute over the same fp32
                # params; rounding falls to fp64's, a hand-off fault would not
                cfg64 = dataclasses.replace(cfg, compute_dtype="float64")
                _, _, st64 = prefill(params, cfg64, short)
                d64, dv64, st64 = decode_step(params, cfg64, last, st64)
                f64, fv64, _ = forward_train(params, cfg64, full)
                _, _, sf64 = prefill(params, cfg64, full)
                keys = [k for k, c in st64["blocks"].items() if not isinstance(c, dict)]
                rec["consistency"]["float64"] = {
                    "err": max(rel_err(d64[:, 0], f64[:, pos]), rel_err(dv64[:, 0], fv64[:, pos])),
                    "logits_dtype": str(d64.dtype).replace("torch.", ""),
                    "state_dtype": str(st64["blocks"]["tm_S"].dtype).replace("torch.", ""),
                    "state_err_by_layer": [
                        max(rel_err(st64["blocks"][k][r], sf64["blocks"][k][r]) for k in keys)
                        for r in range(st64["blocks"][keys[0]].shape[0])]}
                del st64, sf64, d64, dv64, f64, fv64
            del st, params
        torch.cuda.empty_cache()

        # card vs CPU: one unit at full width, fp32 compute; kimi-k2's
        # dense prefix and one MoE layer with KIMI_CPU_EXPERTS experts
        cfg1 = dataclasses.replace(cfg, num_layers=1, compute_dtype="float32")
        if kimi:
            cfg1 = dataclasses.replace(cfg1, num_layers=cfg.moe.first_k_dense + 1,
                                       moe=dataclasses.replace(cfg.moe,
                                                               num_experts=KIMI_CPU_EXPERTS))
        ctoks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                              (DECODE_CPU_B, DECODE_CPU_T + DECODE_CPU_STEPS)))
        cpatch = torch.from_numpy(rng.normal(size=(DECODE_CPU_B, 16, cfg.d_model))
                                  .astype(np.float32))

        def run(p, d):
            b = {"tokens": ctoks[:, :DECODE_CPU_T].to(d)}
            if cfg.family == "vlm":
                b["patch_embeds"] = cpatch.to(d)
            with moe_routes() as routes:
                lg, v, st = prefill(p, cfg1, b)
                outs = [lg, v]
                for i in range(DECODE_CPU_T, DECODE_CPU_T + DECODE_CPU_STEPS):
                    lg, v, st = decode_step(p, cfg1, ctoks[:, i:i + 1].to(d), st,
                                            uniform=i % 2 == 0)
                    outs += [lg, v]
            return outs, st, [s.cpu() for s, _ in routes]

        with torch.inference_mode():
            p_dev = init_params(torch.Generator(device=dev).manual_seed(12), cfg1)
            o_cpu, s_cpu, r_cpu = run(tree_map(lambda a: a.cpu(), p_dev), torch.device("cpu"))
            zero(counters)
            o_dev, s_dev, r_dev = run(p_dev, dev)
            for k, c in read(counters).items():
                total[k] += c
            check_on_card(f"{arch} card vs CPU")
            errs = {"logits_values": max(rel_err(a.cpu(), b) for a, b in zip(o_dev, o_cpu))}
            leaves = list(zip(tree_flatten_with_path(s_dev)[0], tree_flatten_with_path(s_cpu)[0]))
            errs["state"] = max(rel_err(a.cpu(), b) for (_, a), (_, b) in leaves
                                if a.is_floating_point())
            check(all(torch.equal(a.cpu(), b) for (_, a), (_, b) in leaves
                      if not a.is_floating_point()), f"{arch} card vs CPU: positions differ")
            check(len(r_dev) == len(r_cpu) and all(torch.equal(a, b) for a, b in zip(r_dev, r_cpu)),
                  f"{arch} card vs CPU: routing slots differ")
            for what, e, t in (("logits_values", errs["logits_values"], CARD_VS_CPU_TOL),
                               ("state", errs["state"], STATE_TOL)):
                check(e <= t, f"{arch} card vs CPU ({what}): {e} > {t}")
            rec["card_vs_cpu"] = {"unit": (f"the dense prefix and one MoE layer, "
                                           f"{KIMI_CPU_EXPERTS} of {cfg.moe.num_experts} experts"
                                           if kimi else "one layer"),
                                  "batch": DECODE_CPU_B, "prompt": DECODE_CPU_T,
                                  "steps": DECODE_CPU_STEPS, "routes_equal": len(r_dev),
                                  "max_err": errs,
                                  "tol": {"logits_values": CARD_VS_CPU_TOL, "state": STATE_TOL}}
            del p_dev, s_dev, o_dev
        torch.cuda.empty_cache()
        rec["seconds"] = time.perf_counter() - t_arch
        out[arch] = rec
        emit("families", card=smi, arch=arch, family=cfg.family,
             compute_dtype=cfg.compute_dtype, param_dtype=cfg.param_dtype, batch=DECODE_B,
             prompt=T, steps=FAMILY_STEPS, **rec)
    emit("families_phase", card=smi, seconds=time.perf_counter() - t_phase, launches=total)
    return total, out



def grads_vs_cpu(step, params_dev, batch_cpu, dev, counters, total, what):
    """One train step of `step` (built on `grads_only()`) on the CPU and on
    the card from the same params and batch: the card's launches are added
    to `total`, and the loss, the other scalar metrics and every grad leaf
    are compared within CARD_VS_CPU_TOL (grads of max(1, max |cpu|)); the
    MoE routing slots must be equal."""
    import torch

    from repro_torch.utils import tree_flatten_with_path, tree_map

    to = lambda t, d: tree_map(lambda a: a.to(d), t)
    with moe_routes() as routes:
        _, _, m_cpu = step(to(params_dev, "cpu"), {}, batch_cpu)
        r_cpu = [s.cpu() for s, _ in routes]
        routes.clear()
        zero(counters)
        _, _, m_dev = step(params_dev, {}, to(batch_cpu, dev))
        for k, n in read(counters).items():
            total[k] += n
        check_on_card(what)
        r_dev = [s.cpu() for s, _ in routes]
    check(len(r_dev) == len(r_cpu) and all(torch.equal(a, b) for a, b in zip(r_dev, r_cpu)),
          f"{what}: routing slots differ")
    g_dev, g_cpu = m_dev.pop("grads"), m_cpu.pop("grads")
    errs = {k: abs(m_dev[k].item() - m_cpu[k].item()) for k in m_cpu}
    errs["grads"] = max(rel_err(a.cpu(), b) for (_, a), (_, b) in
                        zip(tree_flatten_with_path(g_dev)[0], tree_flatten_with_path(g_cpu)[0]))
    for k, e in errs.items():
        check(e <= CARD_VS_CPU_TOL, f"{what} ({k}): {e} > {CARD_VS_CPU_TOL}")
    return {"max_err": errs, "routes_equal": len(r_dev), "tol": CARD_VS_CPU_TOL}


def audio_phase(dev, counters, smi):
    """The audio family (hubert-xlarge: an encoder-only stack over frame
    embeddings, head dim 80, bidirectional attention) at full width and
    depth, seeded, fp32 params and bf16 compute:

    - the encoder's serving pass (`prefill_32k`): `prefill` over
      AUDIO_PREFILL_B x AUDIO_PREFILL_T frame embeddings, one warm-up and
      AUDIO_PREFILLS timed, each with exactly its flash forwards (one per
      layer; hubert's norms are LayerNorms, plain PyTorch as in `repro`),
      and one profiled;
    - `train_4k`: `build_mlm_train_step` (remat, adamw(3e-4,
      clip_norm=1.0), updated in place) on AUDIO_B x AUDIO_T frames under a
      seeded HuBERT mask, one warm-up and AUDIO_STEPS timed, each with
      exactly its launches (per layer two flash forwards, dq and dk/dv),
      and one profiled;
    - card vs CPU at fp32 compute, one full-width layer: prefill logits and
      values, and one masked-unit step's loss, masked_acc and every grad
      leaf within CARD_VS_CPU_TOL."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.learners import build_mlm_train_step
    from repro_torch.models import init_params, prefill
    from repro_torch.optim import adamw
    from repro_torch.utils import tree_leaves, tree_map

    t_phase = time.perf_counter()
    rng = np.random.default_rng(17)
    names = [c.__name__ for c in counters]
    total = dict.fromkeys(names, 0)
    counted = lambda fn, want, what: counted_run(counters, total, fn, want, what)
    cfg = get_arch("hubert-xlarge")
    L = cfg.num_layers
    per_prefill = {"flash_attention_fwd": L}
    per_step = {"flash_attention_fwd": 2 * L, "flash_attention_bwd_dq": L,
                "flash_attention_bwd_dkv": L}
    rec = {"layers": L, "d_model": cfg.d_model, "heads": [cfg.num_heads, cfg.num_kv_heads],
           "head_dim": cfg.head_dim, "compute_dtype": cfg.compute_dtype,
           "param_dtype": cfg.param_dtype, "launches_per_prefill": per_prefill,
           "launches_per_step": per_step,
           "cuts": {"prefill_32k": f"batch 32 -> {AUDIO_PREFILL_B}",
                    "train_4k": f"batch 256 -> {AUDIO_B}"}}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(torch.Generator(device=dev).manual_seed(18), cfg)
    rec["params"] = sum(t.numel() for t in tree_leaves(params))
    per_step.update(optimizer_launches(params))

    with torch.inference_mode():
        frames = torch.randn(AUDIO_PREFILL_B, AUDIO_PREFILL_T, cfg.d_model, device=dev,
                             generator=torch.Generator(device=dev).manual_seed(19))
        batch = {"frame_embeds": frames}
        prefill_ms = []
        for i in range(1 + AUDIO_PREFILLS):
            ms, (logits, values, state) = counted(
                lambda: sync_wall(lambda: prefill(params, cfg, batch)), per_prefill,
                "hubert prefill")
            prefill_ms += [ms] if i else []
        check(logits.shape == (AUDIO_PREFILL_B, AUDIO_PREFILL_T, cfg.vocab_size)
              and finite(logits, values), "hubert prefill: outputs")
        check(int(state["length"][0]) == AUDIO_PREFILL_T and ring(state)
              == (-1, AUDIO_PREFILL_T - 1), f"hubert prefill: cache {ring(state)}")
        del logits, values, state
        zero(counters)
        rec["profile_prefill"] = profiled(lambda: prefill(params, cfg, batch), 1)
        for k, n in read(counters).items():
            total[k] += n
        rec["dispatch_prefill"] = check_on_card("hubert prefill profiled")
        del frames, batch
    rec.update(prefill_ms_each=prefill_ms, prefill_ms_median=statistics.median(prefill_ms),
               prefill_peak_cuda_mb=torch.cuda.max_memory_allocated() / 2 ** 20)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # train_4k: masked-unit prediction
    mask = hubert_mask(rng, AUDIO_B, AUDIO_T)
    mb = {"frame_embeds": torch.randn(AUDIO_B, AUDIO_T, cfg.d_model, device=dev,
                                      generator=torch.Generator(device=dev).manual_seed(20)),
          "units": torch.from_numpy(rng.integers(0, cfg.vocab_size, (AUDIO_B, AUDIO_T))).to(dev),
          "mask": torch.from_numpy(mask).to(dev)}
    opt = adamw(3e-4, clip_norm=1.0, master_fp32=cfg.param_dtype == "bfloat16", inplace=True)
    step = build_mlm_train_step(cfg, opt)
    state = opt.init(params)
    step_ms, losses, accs = [], [], []
    for i in range(1 + AUDIO_STEPS):
        ms, (params, state, m) = counted(lambda: sync_wall(lambda: step(params, state, mb)),
                                         per_step, "hubert mlm step")
        losses.append(m["loss"].item())
        accs.append(m["masked_acc"].item())
        step_ms += [ms] if i else []
    check(all(np.isfinite(losses)) and all(bool(t.isfinite().all()) for t in tree_leaves(params)),
          f"hubert mlm step: non-finite loss {losses} or params")
    zero(counters)
    rec["profile_step"] = profiled(lambda: step(params, state, mb), 1)
    for k, n in read(counters).items():
        total[k] += n
    rec["dispatch_step"] = check_on_card("hubert mlm step profiled")
    rec.update(mask_share=float(mask.mean()), step_ms_each=step_ms,
               step_ms_median=statistics.median(step_ms), losses=losses, masked_acc=accs,
               step_peak_cuda_mb=torch.cuda.max_memory_allocated() / 2 ** 20)
    del params, state, mb, opt, step
    torch.cuda.empty_cache()

    # card vs CPU: one full-width layer at fp32 compute
    cfg1 = dataclasses.replace(cfg, num_layers=1, compute_dtype="float32")
    p_dev = init_params(torch.Generator(device=dev).manual_seed(21), cfg1)
    fr = torch.from_numpy(rng.normal(size=(AUDIO_CPU_B, AUDIO_CPU_T, cfg.d_model))
                          .astype(np.float32))
    with torch.inference_mode():
        lg_c, v_c, _ = prefill(tree_map(lambda a: a.cpu(), p_dev), cfg1, {"frame_embeds": fr})
        zero(counters)
        lg_d, v_d, _ = prefill(p_dev, cfg1, {"frame_embeds": fr.to(dev)})
        for k, n in read(counters).items():
            total[k] += n
        check_on_card("hubert card vs CPU prefill")
    errs = {"prefill": max(rel_err(lg_d.cpu(), lg_c), rel_err(v_d.cpu(), v_c))}
    check(errs["prefill"] <= CARD_VS_CPU_TOL,
          f"hubert card vs CPU prefill: {errs['prefill']} > {CARD_VS_CPU_TOL}")
    cb = {"frame_embeds": fr,
          "units": torch.from_numpy(rng.integers(0, cfg.vocab_size, (AUDIO_CPU_B, AUDIO_CPU_T))),
          "mask": torch.from_numpy(hubert_mask(rng, AUDIO_CPU_B, AUDIO_CPU_T))}
    res = grads_vs_cpu(build_mlm_train_step(cfg1, grads_only()), p_dev, cb, dev, counters,
                       total, "hubert mlm step card vs CPU")
    rec["card_vs_cpu"] = {"unit": "one layer", "batch": [AUDIO_CPU_B, AUDIO_CPU_T],
                          "max_err": {**errs, **res["max_err"]}, "tol": CARD_VS_CPU_TOL}
    del p_dev
    torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t_phase
    emit("audio", card=smi, arch=cfg.name, prefill_batch=[AUDIO_PREFILL_B, AUDIO_PREFILL_T],
         train_batch=[AUDIO_B, AUDIO_T], launches=total, **rec)
    return total, rec


def train_families_phase(dev, counters, smi):
    """A train step on the card for each family (build_seq_train_step: PPO
    + GAE over tokens, remat; adamw(3e-4, clip_norm=1.0, master_fp32 for
    bf16 params) as `repro`'s launch/steps.py builds it, updated in place),
    full width, one arch at a time (TRAIN_FAMILIES: depth, batch, tokens,
    patch embeddings first). Per arch:

    - one step and TRAIN_STEPS timed steps on one fixed seeded batch (its
      behavior log-probs and values the initial policy's own, as on-policy
      PPO data is), each with exactly its launches (per attention layer two
      flash forwards, dq and dk/dv; the RMSNorms of two forward passes and
      the final norm; one scan) and every grad leaf finite, and one step
      profiled; then the same steps from the same params under a linear
      warmup to 3e-4 over TRAIN_WARMUP steps, after which the loss must be
      lower than before them;
    - card vs CPU at fp32 compute and fp32 params on one unit (the
      `families` phase's), TRAIN_CPU_B x TRAIN_CPU_T tokens (pixtral's
      after TRAIN_CPU_PATCHES patches): the loss and every grad leaf within
      CARD_VS_CPU_TOL, the MoE routing slots equal.

    kimi-k2's step waits for the mesh: one MoE layer is ~17 B params, which
    with master params, moments and grads is ~270 GB."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.learners import build_seq_train_step
    from repro_torch.models import forward_train, init_params
    from repro_torch.optim import adamw, linear
    from repro_torch.utils import tree_leaves

    t_phase = time.perf_counter()
    rng = np.random.default_rng(23)
    names = [c.__name__ for c in counters]
    total = dict.fromkeys(names, 0)
    counted = lambda fn, want, what: counted_run(counters, total, fn, want, what)
    out = {}
    for arch, (depth, B, T, P) in TRAIN_FAMILIES.items():
        t_arch = time.perf_counter()
        cfg = get_arch(arch)
        if depth:
            cfg = dataclasses.replace(cfg, num_layers=depth)
        La = cfg.num_layers * (cfg.family != "ssm")
        norms = family_norms(cfg)
        per_step = {"rmsnorm": 2 * norms - 1 if norms else 0, "flash_attention_fwd": 2 * La,
                    "flash_attention_bwd_dq": La, "flash_attention_bwd_dkv": La,
                    "reverse_discounted_scan_p": 1}
        rec = {"layers": cfg.num_layers, "published_layers": get_arch(arch).num_layers,
               "batch": [B, T], "patches": P, "launches_per_step": per_step}
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = init_params(torch.Generator(device=dev).manual_seed(24), cfg)
        rec["params"] = sum(t.numel() for t in tree_leaves(params))
        per_step.update(optimizer_launches(params))
        batch = seq_batch(rng, T, cfg.vocab_size, dev, B=B)
        if P:
            batch["patch_embeds"] = torch.randn(
                B, P, cfg.d_model, device=dev, generator=torch.Generator(device=dev).manual_seed(25))
        with torch.inference_mode():
            # on-policy data: the behavior log-probs and values are the
            # initial policy's own, as the actor that was served them recorded
            lg, v, _ = forward_train(params, cfg, {k: batch[k] for k in ("tokens", "patch_embeds")
                                                   if k in batch})
            batch["behavior_logp"] = torch.log_softmax(lg[:, -T:], -1).gather(
                -1, batch["actions"][..., None])[..., 0]
            batch["behavior_values"] = v[:, -T:]
            del lg, v

        def train(params, lr, what):
            """1 + TRAIN_STEPS steps on the fixed batch from `params`, each
            with exactly its launches and finite grads: (ms, losses, PPO
            ratio means, each per step; the last params and state)."""
            opt = adamw(lr, clip_norm=1.0, master_fp32=cfg.param_dtype == "bfloat16",
                        inplace=True)
            step = build_seq_train_step(cfg, with_grads(opt))
            state = opt.init(params)
            ms_each, losses, ratios = [], [], []
            for i in range(1 + TRAIN_STEPS):
                ms, (params, state, m) = counted(
                    lambda: sync_wall(lambda: step(params, state, batch)), per_step, what)
                check(all(bool(g.isfinite().all()) for g in tree_leaves(m.pop("grads"))),
                      f"{what} {i}: non-finite grads")
                ms_each.append(ms)
                losses.append(m["loss"].item())
                ratios.append(m["ratio_mean"].item())
                del m
            check(all(np.isfinite(losses)), f"{what}: non-finite loss {losses}")
            return ms_each, losses, ratios, params, state, step

        # the launch optimizer (repro's launch/steps.py), timed
        step_ms, losses, ratios, params, state, step = train(params, 3e-4, f"{arch} train step")
        zero(counters)
        rec["profile_step"] = profiled(lambda: step(params, state, batch), 1)
        for k, n in read(counters).items():
            total[k] += n
        check_on_card(f"{arch} train step profiled")
        rec.update(step_ms_each=step_ms[1:], step_ms_median=statistics.median(step_ms[1:]),
                   losses=losses, ratio_mean=ratios)
        del params, state, step
        # descent: the same steps from the same params under a linear warmup
        # to 3e-4 over TRAIN_WARMUP steps; the loss must fall
        params = init_params(torch.Generator(device=dev).manual_seed(24), cfg)
        _, wl, wr, params, state, _ = train(params, linear(0.0, 3e-4, TRAIN_WARMUP),
                                            f"{arch} warmup train step")
        check(wl[-1] < wl[0], f"{arch}: the loss did not fall over {TRAIN_STEPS} warmup steps, {wl}")
        rec.update(warmup={"steps": TRAIN_WARMUP, "losses": wl, "ratio_mean": wr},
                   peak_cuda_mb=torch.cuda.max_memory_allocated() / 2 ** 20)
        del params, state, batch
        torch.cuda.empty_cache()

        # card vs CPU: one unit at full width, fp32 compute and params
        cfg1 = dataclasses.replace(cfg, num_layers=len(cfg.layer_pattern),
                                   compute_dtype="float32", param_dtype="float32")
        p_dev = init_params(torch.Generator(device=dev).manual_seed(26), cfg1)
        cb = seq_batch(rng, TRAIN_CPU_T, cfg.vocab_size, "cpu", B=TRAIN_CPU_B)
        if P:
            cb["patch_embeds"] = torch.from_numpy(
                rng.normal(size=(TRAIN_CPU_B, TRAIN_CPU_PATCHES, cfg.d_model)).astype(np.float32))
        res = grads_vs_cpu(build_seq_train_step(cfg1, grads_only()), p_dev, cb, dev, counters,
                           total, f"{arch} train step card vs CPU")
        rec["card_vs_cpu"] = {"unit": f"{cfg1.num_layers} layer(s)",
                              "batch": [TRAIN_CPU_B, TRAIN_CPU_T],
                              "patches": TRAIN_CPU_PATCHES if P else 0, **res}
        del p_dev
        torch.cuda.empty_cache()
        rec["seconds"] = time.perf_counter() - t_arch
        out[arch] = rec
        emit("train_families", card=smi, arch=arch, family=cfg.family,
             compute_dtype=cfg.compute_dtype, param_dtype=cfg.param_dtype, **rec)
    emit("train_families_phase", card=smi, seconds=time.perf_counter() - t_phase, launches=total)
    return total, out


# the mesh phase: one card is a (1, 1) mesh over ('data', 'model') (one
# NCCL rank). qwen3-8b's train step at full width with 2 of 36 layers on
# train_4k's length with its batch cut from 256 to 1; qwen3-moe's MoE layer
# (128 experts, top-8) at full width on 4 x 1,024 tokens
MESH_TRAIN_ARCH, MESH_TRAIN_LAYERS, MESH_TRAIN_B = "qwen3-8b", 2, 1
MESH_TRAIN_STEPS = 3                           # timed bf16 steps, after one warm-up
# the counted step's holds against the dry-run's count (`launch.dryrun`)
COUNT_FLOPS_RTOL = 1e-9
COUNT_PEAK_RTOL = 0.01                         # predicted arguments + temporaries
DRYRUN_HOLDS_TIMEOUT_S = 600
MESH_MOE_ARCH, MESH_MOE_B, MESH_MOE_T = "qwen3-moe-235b-a22b", 4, 1024
MESH_FLUSH_ROUNDS = 20
# command-r-35b's prefill (DECODE_B x DECODE_T) and greedy decode steps
# through the dry-run factory's fns, at full width and 2 of 40 layers
MESH_DECODE_ARCH, MESH_DECODE_LAYERS, MESH_DECODE_STEPS = "command-r-35b", 2, 4


def mesh_train_cfg(compute_dtype):
    """The mesh phase's qwen3-8b: full width, MESH_TRAIN_LAYERS layers,
    fp32 params."""
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch(MESH_TRAIN_ARCH), num_layers=MESH_TRAIN_LAYERS,
                               compute_dtype=compute_dtype, param_dtype="float32")


def mesh_train_shape():
    """Register the mesh phase's train shape (1 x SEQ_T); its name."""
    from repro_torch.configs import INPUT_SHAPES, InputShape
    INPUT_SHAPES["train_4k_b1"] = InputShape("train_4k_b1", SEQ_T, MESH_TRAIN_B, "train")
    return "train_4k_b1"


def dryrun_holds(path):
    """The dry-run records (`launch.dryrun.run_one`, with `measured`) that
    the mesh phases hold a real rank's counts against, written to `path` as
    JSON: `mesh_train`, the mesh phase's bf16 qwen3-8b step on (1, 1);
    `mesh_split_prefill`, the prefill that `tools/mesh_two_ranks.py
    --split` counts on each of its two ranks, on (1, 2); with the seconds
    they took. Meta tensors and a fake process group: no card."""
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    sys.path.insert(0, str(ROOT / "tools"))
    import mesh_two_ranks as two
    two.serve_shapes()
    recs = {"mesh_train": dryrun.run_one(MESH_TRAIN_ARCH, mesh_train_shape(),
                                         cfg=mesh_train_cfg("bfloat16"), mesh_shape=(1, 1),
                                         verbose=False),
            "mesh_split_prefill": dryrun.run_one(two.COUNTED_ARCH, "two_ranks_prefill",
                                                 cfg=two.serve_cfg(two.COUNTED_ARCH),
                                                 mesh_shape=(1, 2), verbose=False)}
    for name, rec in recs.items():
        if rec["status"] != "ok":
            raise RuntimeError(f"dry-run {name}: {rec.get('error')}\n{rec.get('traceback')}")
    Path(path).write_text(json.dumps({"seconds": time.perf_counter() - t0,
                                      "records": recs}))


class DryrunHolds:
    """`dryrun_holds` in a subprocess started with the script, on the host's
    CPU beside the card's work, so its cost is off the wall; `get` waits for
    it once. The subprocess is killed if the script ends first."""

    def __init__(self):
        import atexit
        self.path = ROOT / "build" / "dryrun_holds.json"
        self.path.parent.mkdir(exist_ok=True)
        self.path.unlink(missing_ok=True)
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", "import sys, chip_smoke; chip_smoke.dryrun_holds(sys.argv[1])",
             str(self.path)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, start_new_session=True)
        self.records, self.seconds, self.waited = None, None, None
        atexit.register(self.close)

    def get(self, name):
        if self.records is None:
            t0 = time.perf_counter()
            try:
                _, err = self.proc.communicate(timeout=DRYRUN_HOLDS_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                self.close()
                check(False, f"dry-run holds: no records in {DRYRUN_HOLDS_TIMEOUT_S} s")
            check(self.proc.returncode == 0,
                  f"dry-run holds: exit {self.proc.returncode}: {err[-3000:]}")
            made = json.loads(self.path.read_text())
            self.records, self.seconds = made["records"], made["seconds"]
            self.waited = time.perf_counter() - t0
        return self.records[name]

    def close(self):
        from torch_smoke_lib import kill_group
        if self.proc.poll() is None:
            kill_group(self.proc.pid)
            self.proc.wait()


def collectives_of(measured) -> dict:
    """A dry-run record's collectives under `launch.counters.collective_bytes`'
    keys."""
    return {"total": measured["collective_bytes"], **measured["coll_breakdown"],
            **measured["coll_counts"]}


def mesh_phase(dev, counters, smi, per_forward, holds):
    """The mesh on the card, one process, a (1, 1) NCCL DeviceMesh from
    `launch.mesh.make_local_mesh()`:

    (a) the sharded InfServer at policy-s: `repro`'s local-mesh sequence (θ
        alone, then θ and φ grouped) at fp32 within 1e-4 of the unsharded
        server; flush ms (median of 20, 256 rows) sharded and unsharded,
        single and grouped, each flush with exactly a forward's launches;
    (b) `launch.steps.make_dryrun_step`'s train step for qwen3-8b at full
        width, MESH_TRAIN_LAYERS layers, 1 x 4,096 tokens, DTensor params
        and batch: loss and every grad leaf at fp32 compute within
        CARD_VS_CPU_TOL of max(1, max |.|) of the unsharded
        `build_seq_train_step` on the card; then the whole step (adamw on
        the DTensor params and state) at bf16 compute, median of
        MESH_TRAIN_STEPS, peak MB; then one more step under the per-rank
        counter (`launch.counters.Counter`), held against the dry-run's
        count for the same config, shape and mesh (`holds`, a
        `DryrunHolds`): its FLOPs within COUNT_FLOPS_RTOL, its collectives
        by kind equal, the predicted peak (arguments + temporaries) within
        COUNT_PEAK_RTOL of `max_memory_allocated()` over the step less what
        was allocated before it that is not the step's arguments, and its
        launches those of the uncounted steps;
    (c) `moe_apply_ep` on qwen3-moe's MoE
        layer at full width, 4 x 1,024 tokens, fp32: y, aux and every grad
        within CARD_VS_CPU_TOL of `moe_apply`'s, the routing slots equal;
    (d) `make_dryrun_step`'s prefill and decode fns (tensor-parallel
        serving) for command-r-35b at full width, MESH_DECODE_LAYERS
        layers, bf16: a DECODE_B x DECODE_T prefill and MESH_DECODE_STEPS
        greedy uniform steps, bitwise equal to the unsharded `prefill` and
        `decode_step` (last-position logits and values, each step's logits
        and values, every state leaf), with exactly their launches.
    Every run launches its kernels and no plain version. Returns
    (launches, numbers)."""
    import torch

    from repro_torch.configs import INPUT_SHAPES, InputShape, get_arch
    from repro_torch.distributed import sharding as SH
    from repro_torch.infserver import InfServer
    from repro_torch.kernels import dispatch
    from repro_torch.launch.counters import Counter
    from repro_torch.launch.mesh import close_local_mesh, make_local_mesh
    from repro_torch.launch.steps import make_dryrun_step, make_optimizer
    from repro_torch.learners import build_seq_train_step
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.models import moe
    from repro_torch.utils import tree_leaves, tree_map

    t_phase = time.perf_counter()
    names = [c.__name__ for c in counters]
    total = dict.fromkeys(names, 0)

    def add(what):
        """The launches since the last `zero`, added to the phase's total;
        no plain version ran."""
        got = read(counters)
        for k, n in got.items():
            total[k] += n
        check_on_card(what)
        return got

    out = {}
    mesh = make_local_mesh()
    try:
        check(tuple(mesh.shape) == (1, 1) and mesh.device_type == "cuda",
              f"local mesh {tuple(mesh.shape)} on {mesh.device_type}")

        # -- (a) the sharded InfServer ---------------------------------------
        rng = np.random.default_rng(21)
        cfg32 = dataclasses.replace(get_arch("tleague-policy-s"), compute_dtype="float32")
        pgen = torch.Generator(device=dev).manual_seed(3)
        theta, phi = init_params(pgen, cfg32), init_params(pgen, cfg32)
        obs_a = rng.integers(0, cfg32.vocab_size, (5, OBS_LEN)).astype(np.int32)
        obs_b = rng.integers(0, cfg32.vocab_size, (3, OBS_LEN)).astype(np.int32)

        def sequence(m):
            s = InfServer(cfg32, NUM_ACTIONS, max_batch=64, seed=3, mesh=m, device=dev)
            s.register_model("theta", theta)
            res = [s.get(s.submit(obs_a, model="theta"))]
            s.register_model("phi", phi)
            t1, t2 = s.submit(obs_a, model="theta"), s.submit(obs_b, model="phi")
            s.flush()
            return res + [s.get(t1), s.get(t2)], s.stats()

        zero(counters)
        single, _ = sequence(None)
        add("mesh: unsharded sequence")
        zero(counters)
        sharded, st = sequence(mesh)
        calls = dispatch.stats()
        add("mesh: sharded sequence")
        check(st["sharded"] is True and st["mesh_shape"] == [1, 1],
              f"sharded InfServer stats {st['sharded']}, {st['mesh_shape']}")
        check(calls.get("rmsnorm|kernel", 0) > 0 and calls.get("attention|kernel", 0) > 0,
              f"sharded InfServer: kernel calls {calls}")
        err = 0.0
        for (a, lp, v), (a0, lp0, v0) in zip(sharded, single):
            check(np.array_equal(a, a0), "sharded InfServer: actions differ")
            err = max(err, float(np.abs(lp - lp0).max()), float(np.abs(v - v0).max()))
        check(err <= CARD_VS_CPU_TOL, f"sharded InfServer vs unsharded: {err}")

        cfg = get_arch("tleague-policy-s")
        theta, phi = init_params(pgen, cfg), init_params(pgen, cfg)
        flush = {}
        for label, m in (("unsharded", None), ("sharded", mesh)):
            server = InfServer(cfg, NUM_ACTIONS, theta, max_batch=ROWS, mesh=m, device=dev)
            server.register_model("phi", phi)
            per_actor = ROWS // 8
            for kind, models in (("single", [None] * 8), ("grouped", [None] * 4 + ["phi"] * 4)):
                lat = []
                for i in range(1 + MESH_FLUSH_ROUNDS):      # one warm-up
                    obs = rng.integers(0, cfg.vocab_size, (8, per_actor, OBS_LEN)).astype(np.int32)
                    zero(counters)
                    tickets = [server.submit(obs[j], model=models[j]) for j in range(8)]
                    res = [server.get(t) for t in tickets]
                    got = add(f"mesh: {label} {kind} flush")
                    check(got == {k: per_forward.get(k, 0) for k in got},
                          f"mesh: {label} {kind} flush launches {got}")
                    check(all(np.isfinite(r[1]).all() and np.isfinite(r[2]).all() for r in res),
                          f"mesh: {label} {kind} flush: non-finite results")
                    if i:
                        lat.append(1e3 * server.last_batch_latency_s)
                flush[f"{label}_{kind}"] = statistics.median(lat)
            check(server.stats()["sharded"] is (m is not None), f"mesh: {label} stats")
        out["serve"] = {"max_abs_err": err, "flush_ms_median": flush, "rows": ROWS}
        emit("mesh_serve", card=smi, arch="tleague-policy-s", mesh=[1, 1],
             max_abs_err=err, tol=CARD_VS_CPU_TOL, rows_per_flush=ROWS,
             flush_ms_median=flush, launches_per_flush=per_forward, dispatch=calls)
        del server, theta, phi

        # -- (b) the dry-run factory's train step at full width -----------------
        train_shape = mesh_train_shape()
        want = ("rmsnorm", "flash_attention_fwd", "flash_attention_bwd_dq",
                "flash_attention_bwd_dkv", "reverse_discounted_scan_p")
        brng = np.random.default_rng(22)
        cfg = mesh_train_cfg("float32")
        batch = seq_batch(brng, SEQ_T, cfg.vocab_size, dev, B=MESH_TRAIN_B)
        torch.cuda.empty_cache()
        params = init_params(torch.Generator(device=dev).manual_seed(23), cfg)
        built = make_dryrun_step(cfg, train_shape, mesh)
        pshard, oshard, bshard = built["in_shardings"]
        pd, bd = SH.distribute(params, pshard, mesh), SH.distribute(batch, bshard, mesh)
        zero(counters)
        loss1, _, g1 = built["fn"].value_and_grad(pd, bd)
        n_sharded = add("mesh: sharded train step (fp32)")
        g1 = [g.full_tensor() for _, g in SH.leaves_with_path(g1)]
        zero(counters)
        loss0, _, g0 = build_seq_train_step(cfg, make_optimizer(cfg)).value_and_grad(params, batch)
        n_plain = add("mesh: unsharded train step (fp32)")
        g0 = [g for _, g in SH.leaves_with_path(g0)]
        for n, what in ((n_sharded, "sharded"), (n_plain, "unsharded")):
            check(all(n[k] > 0 for k in want), f"mesh: {what} train step launches {n}")
        # the sharded step checkpoints its heads (their gathered weights are
        # freed after the forward), so the final norm runs once more
        want_sharded = dict(n_plain, rmsnorm=n_plain["rmsnorm"] + 1)
        check(n_sharded == want_sharded, f"mesh: train launches {n_sharded} vs {want_sharded}")
        errs = {"loss": abs(loss1.item() - loss0.item()),
                "grads": max(rel_err(a, b) for a, b in zip(g1, g0))}
        for k, e in errs.items():
            check(e <= CARD_VS_CPU_TOL, f"mesh: sharded train step vs unsharded ({k}): {e}")
        del g0, g1, pd, params
        torch.cuda.empty_cache()

        cfg = mesh_train_cfg("bfloat16")
        params = init_params(torch.Generator(device=dev).manual_seed(23), cfg)
        built = make_dryrun_step(cfg, train_shape, mesh)
        pshard, oshard, bshard = built["in_shardings"]
        opt = make_optimizer(cfg)
        pd = SH.distribute(params, pshard, mesh)
        od = SH.distribute(opt.init(params), oshard, mesh)
        del params
        # the gradient's launches, then adamw's on the DTensors' local shards
        per_step = dict(n_sharded, **optimizer_launches(pd))
        torch.cuda.reset_peak_memory_stats()
        step_ms, losses = [], []
        for i in range(1 + MESH_TRAIN_STEPS):             # one warm-up
            zero(counters)
            ms, (pd, od, m) = sync_wall(lambda: built["fn"](pd, od, bd))
            n = add("mesh: sharded train step (bf16)")
            check(n == per_step, f"mesh: bf16 step launches {n}, want {per_step}")
            losses.append(float(m["loss"].full_tensor() if SH.is_dtensor(m["loss"])
                                else m["loss"]))
            if i:
                step_ms.append(ms)
        check(all(np.isfinite(losses)), f"mesh: bf16 step losses {losses}")
        peak_mb = torch.cuda.max_memory_allocated() / 2**20

        # the counted step, held against the dry-run's count
        rec = holds.get("mesh_train")
        meas = rec["measured"]
        args_bytes = sum(t.to_local().numel() * t.element_size()
                         for t in tree_leaves((pd, od, bd)))
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        zero(counters)
        with Counter() as counter:
            pd, od, m = built["fn"](pd, od, bd)
            torch.cuda.synchronize()
        n = add("mesh: counted bf16 step")
        step_peak = torch.cuda.max_memory_allocated() - (before - args_bytes)
        got = counter.result()
        check(n == per_step, f"mesh: counted step launches {n}, uncounted {per_step}")
        flops_rel = abs(got["flops"] - meas["flops"]) / meas["flops"]
        check(flops_rel <= COUNT_FLOPS_RTOL,
              f"mesh: counted step FLOPs {got['flops']} vs the dry-run's {meas['flops']}")
        check(got["collectives"] == collectives_of(meas),
              f"mesh: counted step collectives {got['collectives']} vs the dry-run's "
              f"{collectives_of(meas)}")
        predicted = rec["memory"]["argument_size_in_bytes"] + meas["temp_size_in_bytes"]
        peak_gap = (step_peak - predicted) / step_peak
        check(abs(peak_gap) <= COUNT_PEAK_RTOL,
              f"mesh: counted step peak {step_peak} B vs predicted {predicted} B "
              f"({100 * peak_gap:.2f} %)")
        out["counted"] = {
            "flops": got["flops"], "dryrun_flops": meas["flops"], "flops_rel_err": flops_rel,
            "flops_by_op": got["flops_by_op"], "bytes": got["bytes"],
            "dryrun_bytes": meas["bytes"], "collectives": got["collectives"],
            "kernels": got["kernels"], "launches": n, "args_bytes": args_bytes,
            "dryrun_args_bytes": rec["memory"]["argument_size_in_bytes"],
            "allocated_before": before, "step_peak_bytes": step_peak,
            "dryrun_temp_bytes": meas["temp_size_in_bytes"], "predicted_peak_bytes": predicted,
            "peak_gap": peak_gap, "counter_temp_bytes": got["temp_size_in_bytes"],
            "dryrun_holds_s": holds.seconds, "dryrun_holds_waited_s": holds.waited}
        emit("mesh_counted_step", card=smi, mesh=[1, 1], flops_rtol=COUNT_FLOPS_RTOL,
             peak_rtol=COUNT_PEAK_RTOL, **out["counted"])
        out["train"] = {"arch": MESH_TRAIN_ARCH, "layers": MESH_TRAIN_LAYERS,
                        "batch": MESH_TRAIN_B, "tokens": SEQ_T, "max_abs_err": errs,
                        "step_ms_median": statistics.median(step_ms), "step_ms": step_ms,
                        "losses": losses, "peak_mb": peak_mb,
                        "launches_per_step": per_step}
        emit("mesh_train", card=smi, mesh=[1, 1], tol=CARD_VS_CPU_TOL,
             published_layers=get_arch(MESH_TRAIN_ARCH).num_layers,
             params=sum(t.numel() for t in tree_leaves(pd)), **out["train"])
        del pd, od, built
        torch.cuda.empty_cache()

        # -- (c) expert-parallel MoE at full width ------------------------------
        mcfg = dataclasses.replace(get_arch(MESH_MOE_ARCH), compute_dtype="float32",
                                   param_dtype="float32")
        p = moe.init_moe(torch.Generator(device=dev).manual_seed(24), mcfg, torch.float32)
        p = tree_map(lambda t: t.requires_grad_(True), p)
        x = torch.randn(MESH_MOE_B, MESH_MOE_T, mcfg.d_model, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(25))
        e = mcfg.moe
        N = MESH_MOE_B * MESH_MOE_T
        cap = max(int(N * e.experts_per_token * e.capacity_factor / e.num_experts),
                  e.experts_per_token)
        with torch.no_grad():
            gates = torch.softmax(x.reshape(N, -1) @ p["router"]["w"], dim=-1)
            slots0 = moe.route_topk(gates, e.experts_per_token, cap)
            slots1 = moe.route_local(gates, e.experts_per_token, cap, 0, e.num_experts)
        routes_equal = bool(torch.equal(slots0[0], slots1[0])
                            and torch.equal(slots0[2], slots1[2]))
        check(routes_equal, "mesh: moe_apply_ep routing slots differ from moe_apply's")
        zero(counters)
        t0 = time.perf_counter()
        y0, a0 = moe.moe_apply(p, mcfg, x)
        g0 = torch.autograd.grad(y0.sum(), tree_leaves(p))
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        with SH.data_parallel(mesh, ("data",)):
            y1, a1 = moe.moe_apply_ep(p, mcfg, x, mesh)
            loss = SH.batch_sum(y1.sum())
        g1 = torch.autograd.grad(loss / mesh.size(), tree_leaves(p))
        torch.cuda.synchronize()
        ep_ms = 1e3 * (time.perf_counter() - t0)
        add("mesh: moe_apply_ep")
        errs = {"y": rel_err(y1, y0), "aux": abs(a1.item() - a0.item()),
                "grads": max(rel_err(a, b) for a, b in zip(g1, g0))}
        for k, v in errs.items():
            check(v <= CARD_VS_CPU_TOL, f"mesh: moe_apply_ep vs moe_apply ({k}): {v}")
        out["moe"] = {"arch": MESH_MOE_ARCH, "batch": MESH_MOE_B, "tokens": MESH_MOE_T,
                      "experts": e.num_experts, "top_k": e.experts_per_token,
                      "max_abs_err": errs, "routes_equal": routes_equal,
                      "dropped": int((~slots0[2]).sum()),
                      "fwd_bwd_ms": {"moe_apply": plain_ms, "moe_apply_ep": ep_ms}}
        emit("mesh_moe", card=smi, mesh=[1, 1], tol=CARD_VS_CPU_TOL, **out["moe"])
        del p, x, y0, y1, g0, g1, gates
        torch.cuda.empty_cache()

        # -- (d) tensor-parallel prefill and decode: command-r ------------------
        ccfg = dataclasses.replace(get_arch(MESH_DECODE_ARCH), num_layers=MESH_DECODE_LAYERS)
        INPUT_SHAPES["mesh_prefill"] = InputShape("mesh_prefill", DECODE_T, DECODE_B, "prefill")
        # the decode state's specs are those of the prefill's cache (64 slots more)
        INPUT_SHAPES["mesh_decode"] = InputShape("mesh_decode", DECODE_T + 64, DECODE_B,
                                                 "decode")
        toks = torch.from_numpy(np.random.default_rng(27).integers(
            0, ccfg.vocab_size, (DECODE_B, DECODE_T + MESH_DECODE_STEPS))).to(dev)
        want = {k: 0 for k in names}
        want.update(rmsnorm=norms_per_pass(ccfg) * (1 + MESH_DECODE_STEPS),
                    flash_attention_fwd=ccfg.num_layers)

        def serve_run(prefill_fn, step_fn):
            """Last-position logits and values (`prefill_fn` returns those
            and the state, as the factory's fn does), each step's, the final
            state's leaves (plain tensors), and the prefill and step ms."""
            ms_p, (lg, v, st) = sync_wall(lambda: prefill_fn(toks[:, :DECODE_T]))
            res, step_ms = [lg, v], []
            for i in range(DECODE_T, DECODE_T + MESH_DECODE_STEPS):
                ms, (dl, dv, st) = sync_wall(lambda: step_fn(toks[:, i:i + 1], st))
                res += [dl, dv]
                step_ms.append(ms)
            local = lambda t: t.to_local() if SH.is_dtensor(t) else t
            return [local(t) for t in res] + [local(t) for _, t in SH.leaves_with_path(st)], \
                ms_p, statistics.median(step_ms)

        with torch.no_grad():
            params = init_params(torch.Generator(device=dev).manual_seed(26), ccfg)
            zero(counters)
            def last(lg, v, st):
                return lg[:, -1], v[:, -1], st
            ref, p_ms0, s_ms0 = serve_run(
                lambda t: last(*prefill(params, ccfg, {"tokens": t})),
                lambda t, st: decode_step(params, ccfg, t, st, uniform=True))
            n_plain = add("mesh: unsharded command-r prefill and decode")
            pre = make_dryrun_step(ccfg, "mesh_prefill", mesh)
            dec = make_dryrun_step(ccfg, "mesh_decode", mesh)
            pd = SH.distribute(params, pre["in_shardings"][0], mesh)
            del params
            zero(counters)
            got, p_ms1, s_ms1 = serve_run(
                lambda t: pre["fn"](pd, SH.distribute({"tokens": t}, pre["in_shardings"][1],
                                                      mesh)),
                lambda t, st: dec["fn"](pd, SH.distribute(t, dec["in_shardings"][1], mesh), st))
            n_sharded = add("mesh: sharded command-r prefill and decode")
        check(n_plain == want and n_sharded == want,
              f"mesh: command-r launches {n_sharded} / {n_plain}, want {want}")
        bitwise = len(got) == len(ref) and all(torch.equal(a, b) for a, b in zip(got, ref))
        check(bitwise, "mesh: sharded command-r prefill and decode differ from the unsharded")
        out["decode"] = {"arch": MESH_DECODE_ARCH, "layers": ccfg.num_layers,
                         "batch": DECODE_B, "prompt": DECODE_T, "steps": MESH_DECODE_STEPS,
                         "bitwise_equal": bitwise, "launches_per_prefill": {
                             "rmsnorm": norms_per_pass(ccfg),
                             "flash_attention_fwd": ccfg.num_layers},
                         "prefill_ms": {"unsharded": p_ms0, "sharded": p_ms1},
                         "decode_ms_median": {"unsharded": s_ms0, "sharded": s_ms1}}
        emit("mesh_decode", card=smi, mesh=[1, 1], **out["decode"])
        del pd, got, ref
        torch.cuda.empty_cache()
    finally:
        for name in ("mesh_prefill", "mesh_decode"):
            INPUT_SHAPES.pop(name, None)
        INPUT_SHAPES.pop("train_4k_b1", None)
        moe.set_expert_parallel(False)
        close_local_mesh()
    emit("mesh_phase", card=smi, seconds=time.perf_counter() - t_phase, launches=total)
    return total, out


# the mesh_split phase: `tools/mesh_two_ranks.py --split` in a subprocess,
# two gloo ranks on this card; its cases (one line each) and its own limit
MESH_SPLIT_CASES = ("split_prefill_and_decode:rwkv6-3b",
                    "split_prefill_and_decode:hymba-1.5b",
                    "split_moe_unit:qwen3-moe-235b-a22b")
MESH_SPLIT_TIMEOUT_S = 180


def mesh_split_phase(smi, names, holds):
    """RWKV6, Mamba and the experts split over 'model' on two gloo ranks of
    this card: `tools/mesh_two_ranks.py --split` as a subprocess (its own
    session, killed whole past MESH_SPLIT_TIMEOUT_S). It probes the
    collectives the sharded paths call in its ranks, then runs rwkv6-3b's
    and hymba-1.5b's prefill (4 x 256) and 4 decode steps at full width, 2
    layers, fp32, through the factory's fns on a (1, 2) mesh, and one
    qwen3-moe unit (attention, then the MoE without `moe_ep`, 64 of 128
    experts a rank) forward and backward on 4 x 1,024 tokens, each against
    the single rank's run within 1e-4 of max(1, max |.|), no plain version
    on the card. rwkv6-3b's held prefill runs under the per-rank counter
    in each rank: each rank's FLOPs and collectives by kind (count and
    operand bytes) must equal the dry-run's for the same config, shape and
    mesh (`holds`), and its launches those of the uncounted warm-up. The
    phase fails when the subprocess exits non-zero or times out, a
    collective was refused, or a case's line is missing or did not hold.
    Returns (launches summed over the ranks, each rank's
    launches, numbers)."""
    import torch

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()               # the ranks need the card's memory
    cmd = [sys.executable, str(ROOT / "tools" / "mesh_two_ranks.py"), "--split"]
    run = run_commands({"mesh_split": (cmd, MESH_SPLIT_TIMEOUT_S)})["mesh_split"]
    out, err = run["stdout"], run["stderr"]
    check(run["rc"] is not None, f"mesh_split: no result in {MESH_SPLIT_TIMEOUT_S} s")
    lines = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    seconds = time.perf_counter() - t_phase
    check(run["rc"] == 0,
          f"mesh_split: exit {run['rc']}; stdout tail {out[-2000:]!r}; "
          f"stderr tail {err[-2000:]!r}")
    probe = next((ln for ln in lines if "probe" in ln), None)
    check(probe is not None and not probe["refused"],
          f"mesh_split: gloo refused a collective: {probe}")
    cases = {f"{ln['two_ranks']}:{ln['arch']}": ln for ln in lines
             if "arch" in ln and ln.get("two_ranks", "").startswith("split_")}
    for name in MESH_SPLIT_CASES:
        check(name in cases, f"mesh_split: no result line for {name}")
        check(cases[name]["ok"], f"mesh_split: {name} did not hold: {cases[name]}")
    done = next((ln for ln in lines if ln.get("two_ranks") == "split_done"), None)
    check(done is not None and done["ok"], f"mesh_split: {done}")
    rec = holds.get("mesh_split_prefill")
    arch, meas = rec["arch"], rec["measured"]
    want = {"flops": meas["flops"], "collectives": collectives_of(meas)}
    counted = cases[f"split_prefill_and_decode:{arch}"]
    check(counted["launches_as_uncounted"], f"mesh_split: the counter changed {arch}'s launches")
    each = (counted.get("counted_prefill") or {}).get("each_rank", [])
    check(len(each) == 2 and all(r == want for r in each),
          f"mesh_split: {arch}'s counted prefill {each} vs the dry-run's {want}")
    ranks = [dict.fromkeys(names, 0) for _ in range(2)]
    for case in cases.values():
        for r, got in enumerate(case["launches"]["each_rank"]):
            for k, n in got.items():
                ranks[r][k] += n
    for name in ("split_prefill_and_decode:hymba-1.5b", "split_moe_unit:qwen3-moe-235b-a22b"):
        for r, got in enumerate(cases[name]["launches"]["each_rank"]):
            for k in ("rmsnorm", "flash_attention_fwd"):
                check(got[k] > 0, f"mesh_split: {name}: rank {r} never launched {k}")
    total = {k: sum(r[k] for r in ranks) for k in names}
    emit("mesh_split_phase", card=smi, seconds=seconds, launches=total,
         launches_each_rank=ranks, cases=[cases[n] for n in MESH_SPLIT_CASES], probe=probe,
         counted_prefill={"arch": arch, "each_rank": each, "dryrun": want})
    return total, ranks, {"seconds": seconds, "cases": {n: cases[n] for n in MESH_SPLIT_CASES}}


def mla_phase(dev, counters, smi, device_ms, bound):
    """Latent attention on the card: its three (192, 128) kernels at the
    benchmark cell's shape, and the train step that launches them.

    - the forward, dq and dk/dv kernels at (1, 64/64, MLA_T) in bf16,
      causal, q and k 192 wide, v 128 as the model lays them out (v a slice
      of the (B, T, H, 256) k_nope | v projection), at the model's softmax
      scale: held against the plain versions run one head at a time (one
      head's fp32 (T, T) scores take 268 MB, all 64 heads' 17 GB) at the
      D = 128 bf16 tolerances (TOL, BWD_TOL: errors of max(1, max |plain|)
      over all heads), finite, in their layouts and bitwise deterministic; timed (`device_ms`) against that per-head plain loop,
      their bound and SDPA (which takes v narrower than q: its forward,
      and its whole backward for both backward rows);
    - the dk/dv at MLA_SHORT, below one key tile, on its mma.sync design:
      one counted launch, held against the plain version at BWD_TOL, finite,
      bitwise deterministic, timed against the plain version, its bound
      and SDPA's whole backward (GQA);
    - kimi-k2-instruct's train step at the cell's stage
      (build_seq_train_step: V-trace, remat; adamw(3e-4, clip_norm=1.0,
      master_fp32), in place) on one seeded 1 x MLA_T unroll: from zeroed
      counters, one warm-up and MLA_STEPS timed steps each launch exactly
      per layer two flash forwards (the forward and its remat recompute),
      one dq and one dk/dv, all at (192, 128), the dk/dv on its
      warpgroup-MMA design, 8 RMSNorms a layer (the
      block's two and the two latent norms, twice) and the final one, one
      scan, and the optimizer's launches; a finite loss and finite grads.

    Returns (launch totals, {kernel row: its record}, the step's record,
    the phase's dk/dv launches by design)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_arch
    from repro_torch.kernels import cost
    from repro_torch.kernels.flash_attention.ops import (
        dkv_design,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
        flash_attention_fwd,
    )
    from repro_torch.kernels.flash_attention.ref import (
        attention_bwd_grads_ref,
        attention_bwd_ref,
        attention_fwd_ref,
    )
    from repro_torch.learners import build_seq_train_step
    from repro_torch.models import init_params
    from repro_torch.models.attention import mla_scale
    from repro_torch.optim import adamw
    from repro_torch.rl.vtrace_loss import VTraceConfig
    from repro_torch.utils import tree_leaves

    t_phase = time.perf_counter()
    base = get_arch("kimi-k2-instruct")
    cfg = dataclasses.replace(base, num_layers=MLA_LAYERS, vocab_size=MLA_VOCAB,
                              moe=dataclasses.replace(base.moe, num_experts=MLA_HELD))
    m, H, T = cfg.mla, cfg.num_heads, MLA_T
    dqk, dv = m.qk_head_dim, m.v_head_dim
    gen = torch.Generator(device=dev).manual_seed(31)

    def make(width):
        return torch.randn(1, T, H, width, generator=gen, device=dev).to(torch.bfloat16)

    q, k, kv, do = make(dqk), make(dqk), make(m.qk_nope_head_dim + dv), make(dv)
    v = kv[..., m.qk_nope_head_dim:]
    q, k, v, do = (t.transpose(1, 2) for t in (q, k, v, do))
    kw = dict(scale=mla_scale(cfg), causal=True)
    heads = [slice(h, h + 1) for h in range(H)]

    def per_head(fn, *ts):
        """fn on each head's slice of the (B, H, T, .) tensors ts, in turn."""
        return [fn(*(t[:, h] for t in ts)) for h in heads]

    def gap(got, wants):
        """max |got - want| over every head, got (B, H, ...) and wants its
        heads' plain results in turn."""
        return max((got[:, h].float() - w.float()).abs().max().item()
                   for h, w in zip(heads, wants))

    def rel(got, wants):
        """`gap` over max(1, max |want|) of every head."""
        return gap(got, wants) / max(1.0, max(w.float().abs().max().item() for w in wants))

    o, lse = flash_attention_fwd(q, k, v, **kw)
    ref = per_head(lambda *a: attention_fwd_ref(*a, **kw), q, k, v)
    fwd_err = max(gap(o, [r[0] for r in ref]), gap(lse, [r[1] for r in ref]))
    del ref

    def backward():
        dq, delta = flash_attention_bwd_dq(q, k, v, o, do, lse, **kw)
        return (delta, dq) + flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)

    got = backward()
    plain = per_head(lambda *a: attention_bwd_ref(*a, **kw), q, k, v, o, lse, do)
    errs = {n: rel(g, [p[i] for p in plain])
            for i, (n, g) in enumerate(zip(("delta", "dq", "dk", "dv"), got))}
    del plain
    tol = {"flash_fwd_bf16_dv<192, 128>": TOL["bfloat16"],
           "bwd_dq_bf16_dv<192, 128>": BWD_TOL["bfloat16"],
           "bwd_dkv_wgmma<192, 128>": BWD_TOL["bfloat16"]}
    err = {"flash_fwd_bf16_dv<192, 128>": fwd_err, "bwd_dq_bf16_dv<192, 128>": errs["dq"],
           "bwd_dkv_wgmma<192, 128>": max(errs["dk"], errs["dv"])}
    for name, e in err.items():
        check(e <= tol[name], f"mla {name}: err {e} > {tol[name]}")
    check(errs["delta"] <= BWD_TOL["float32"],
          f"mla delta: err {errs['delta']} > {BWD_TOL['float32']}")
    check(finite(o, lse, *got), "mla kernels: non-finite outputs")
    # o, dq and dk in q's and k's layouts; dv dense in v's order of axes
    # (B, T, H, dv), since v is a slice of the k_nope | v projection
    check(o.shape == (1, H, T, dv) and o.transpose(1, 2).is_contiguous()
          and got[1].stride() == q.stride() and got[2].stride() == k.stride()
          and got[3].shape == v.shape and got[3].transpose(1, 2).is_contiguous(),
          "mla kernels: outputs not in their layouts")
    check(all(torch.equal(a, b) for a, b in zip(got, backward())),
          "mla kernels: two identical backward calls differ")
    delta = got[0]
    del got

    qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
    ol = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, scale=kw["scale"])
    sdpa_bwd_ms = device_ms(lambda: torch.autograd.grad(ol, (qs, ks, vs), do,
                                                        retain_graph=True))
    calls = {  # row -> (kernel, plain loop, library, work)
        "flash_fwd_bf16_dv<192, 128>": (
            lambda: flash_attention_fwd(q, k, v, **kw),
            lambda: per_head(lambda *a: attention_fwd_ref(*a, **kw), q, k, v),
            device_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                              scale=kw["scale"])),
            cost.attention_fwd(q, k, v, causal=True)),
        "bwd_dq_bf16_dv<192, 128>": (
            lambda: flash_attention_bwd_dq(q, k, v, o, do, lse, **kw),
            lambda: per_head(lambda *a: attention_bwd_ref(*a, **kw)[:2], q, k, v, o, lse, do),
            sdpa_bwd_ms, cost.attention_bwd_dq(q, k, v, o, do, lse, causal=True)),
        "bwd_dkv_wgmma<192, 128>": (
            lambda: flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw),
            lambda: per_head(lambda *a: attention_bwd_grads_ref(*a, **kw), q, k, v, do,
                             lse, delta),
            sdpa_bwd_ms, cost.attention_bwd_dkv(q, k, v, do, lse, delta, causal=True))}
    rows = {}
    for name, (kernel, plain_fn, library_ms, work) in calls.items():
        b_ms, b_by = bound(work, "bfloat16")
        rows[name] = dict(shape=[1, H, H, T, T, dqk, dv], strided=True, dtype="bfloat16",
                          causal=True, scale=kw["scale"], label="kimi-k2-instruct train, MLA",
                          max_abs_err=err[name], tol=tol[name], ms=device_ms(kernel),
                          plain_ms=device_ms(plain_fn, plain=True), library_ms=library_ms,
                          bound_ms=b_ms, bound_by=b_by)
        if name == "bwd_dq_bf16_dv<192, 128>":
            rows[name]["note"] = "writes delta in its prologue; delta err " + str(errs["delta"])
        if name == "bwd_dkv_wgmma<192, 128>":
            rows[name]["design"] = dkv_design(q, k, v)
            check(rows[name]["design"] == "wgmma", f"mla dk/dv: design {rows[name]['design']}")
        emit("kernel", name=name, **rows[name])
    del q, k, kv, v, do, o, lse, delta, qs, ks, vs, ol
    torch.cuda.empty_cache()

    names = [c.__name__ for c in counters]
    total = dict.fromkeys(names, 0)
    designs = dict.fromkeys(dkv_designs(), 0)

    B2, H2, KV2, T2 = MLA_SHORT
    name = "bwd_dkv_bf16_dv<192, 128>"

    def make2(heads, width):
        return torch.randn(B2, heads, T2, width, generator=gen, device=dev).to(torch.bfloat16)

    q, k, v, do = make2(H2, dqk), make2(KV2, dqk), make2(KV2, dv), make2(H2, dv)
    o, lse = flash_attention_fwd(q, k, v, **kw)
    _, delta = flash_attention_bwd_dq(q, k, v, o, do, lse, **kw)
    design = dkv_design(q, k, v)
    check(design == "mma_sync", f"mla dk/dv at {MLA_SHORT}: design {design}")

    def short():
        return flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)

    dk, dvg = counted_run(counters, total, short, {"flash_attention_bwd_dkv": 1},
                          f"mla dk/dv at {MLA_SHORT}")
    check(dkv_designs() == {"mma_sync": 1, "wgmma": 0},
          f"mla dk/dv at {MLA_SHORT}: launches by design {dkv_designs()}")
    designs["mma_sync"] += 1
    want = attention_bwd_grads_ref(q, k, v, do, lse, delta, **kw)
    err[name], tol[name] = max(rel_err(dk, want[1]), rel_err(dvg, want[2])), BWD_TOL["bfloat16"]
    del want
    check(err[name] <= tol[name], f"mla {name}: err {err[name]} > {tol[name]}")
    check(finite(dk, dvg), f"mla {name}: non-finite grads")
    check(dk.stride() == k.stride() and dvg.stride() == v.stride(),
          f"mla {name}: grads not in k's and v's layouts")
    check(all(torch.equal(a, b) for a, b in zip((dk, dvg), short())),
          f"mla {name}: two identical calls differ")
    qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
    ol = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, scale=kw["scale"],
                                        enable_gqa=True)
    b_ms, b_by = bound(cost.attention_bwd_dkv(q, k, v, do, lse, delta, causal=True), "bfloat16")
    rows[name] = dict(shape=[B2, H2, KV2, T2, T2, dqk, dv], strided=False, dtype="bfloat16",
                      causal=True, scale=kw["scale"], design=design,
                      label="latent widths below a key tile", max_abs_err=err[name],
                      tol=tol[name], ms=device_ms(short),
                      plain_ms=device_ms(lambda: attention_bwd_grads_ref(
                          q, k, v, do, lse, delta, **kw), plain=True),
                      library_ms=device_ms(lambda: torch.autograd.grad(
                          ol, (qs, ks, vs), do, retain_graph=True)),
                      bound_ms=b_ms, bound_by=b_by,
                      note="library_ms: SDPA's whole backward (dq, dk and dv)")
    emit("kernel", name=name, **rows[name])
    del q, k, v, do, o, lse, delta, dk, dvg, qs, ks, vs, ol
    torch.cuda.reset_peak_memory_stats()
    params = init_params(torch.Generator(device=dev).manual_seed(32), cfg)
    L = cfg.num_layers
    per_step = {"rmsnorm": 8 * L + 1, "flash_attention_fwd": 2 * L,
                "flash_attention_bwd_dq": L, "flash_attention_bwd_dkv": L,
                "reverse_discounted_scan_p": 1, **optimizer_launches(params)}
    batch = seq_batch(np.random.default_rng(31), T, cfg.vocab_size, dev)
    opt = adamw(3e-4, clip_norm=1.0, master_fp32=True, inplace=True)
    step = build_seq_train_step(cfg, with_grads(opt), hp=VTraceConfig(), loss="vtrace",
                                remat=True)
    state = opt.init(params)
    ms_each, losses = [], []
    for i in range(1 + MLA_STEPS):
        ms, (params, state, met) = counted_run(
            counters, total, lambda: sync_wall(lambda: step(params, state, batch)), per_step,
            f"mla train step {i}")
        check(all(bool(g.isfinite().all()) for g in tree_leaves(met.pop("grads"))),
              f"mla train step {i}: non-finite grads")
        check(dkv_designs() == {"mma_sync": 0, "wgmma": L},
              f"mla train step {i}: dk/dv launches by design {dkv_designs()}, want {L} wgmma")
        designs["wgmma"] += L
        losses.append(float(met["loss"]))
        check(bool(np.isfinite(losses[-1])), f"mla train step {i}: loss {losses[-1]}")
        ms_each.append(ms)
    train = {"arch": cfg.name, "layers": L, "experts_held": MLA_HELD,
             "router_experts": cfg.router_experts, "vocab": cfg.vocab_size, "batch": [1, T],
             "params": sum(t.numel() for t in tree_leaves(params)),
             "launches_per_step": per_step,
             "dkv_launches_per_step_by_design": {"mma_sync": 0, "wgmma": L},
             "step_ms": ms_each[1:],
             "step_ms_median": statistics.median(ms_each[1:]), "losses": losses,
             "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    del params, state, batch, step, met
    torch.cuda.empty_cache()
    emit("mla_phase", card=smi, seconds=time.perf_counter() - t_phase, launches=total,
         kernels=rows, train=train, dkv_launches_by_design=designs)
    return total, rows, train, designs


def dkv_phase(dev, counters, smi, device_ms, bound):
    """The dk/dv kernel at the dense learn cells' attention (DKV_CELLS:
    mistral-large's 96 query heads on 8 KV heads of 128, causal, bf16, in
    the model's (B, T, H, d) layout), where `dkv_design` picks the
    warpgroup-MMA kernel: one launch a call, counted by design; held
    against the plain version run one KV head (12 query heads) at a time
    (one head's fp32 (T, T) scores take 268 MB at T = 8192) at BWD_TOL, over
    max(1, max |plain|); finite and bitwise deterministic; timed
    (`device_ms`) against that loop, its bound and SDPA's whole backward
    (dq, dk and dv, GQA), which the port never calls.

    Returns (launch totals, {label: record})."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import cost
    from repro_torch.kernels.flash_attention.ops import (
        dkv_design,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
        flash_attention_fwd,
    )
    from repro_torch.kernels.flash_attention.ref import attention_bwd_grads_ref

    t_phase = time.perf_counter()
    H, KV, d = DKV_H, DKV_KV, DKV_D
    G = H // KV
    gen = torch.Generator(device=dev).manual_seed(32)
    total = dict.fromkeys((c.__name__ for c in counters), 0)
    rows = {}
    for label, (B, T) in DKV_CELLS.items():
        def make(heads):
            return (torch.randn(B, T, heads, d, generator=gen, device=dev).to(torch.bfloat16)
                    .transpose(1, 2))

        q, k, v, do = make(H), make(KV), make(KV), make(H)
        kw = dict(scale=d ** -0.5, causal=True)
        o, lse = flash_attention_fwd(q, k, v, **kw)
        _, delta = flash_attention_bwd_dq(q, k, v, o, do, lse, **kw)
        design = dkv_design(q, k, v)
        check(design == "wgmma", f"dk/dv {label}: design {design}")
        dk, dv = counted_run(counters, total,
                             lambda: flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw),
                             {"flash_attention_bwd_dkv": 1}, f"dk/dv {label}")
        check(dkv_designs() == {"mma_sync": 0, "wgmma": 1},
              f"dk/dv {label}: launches by design {dkv_designs()}")

        def plain():
            """attention_bwd_grads_ref one KV head and its G query heads at a time."""
            out = [torch.empty_like(k), torch.empty_like(v)]
            for g in range(KV):
                qh, kh = slice(g * G, (g + 1) * G), slice(g, g + 1)
                _, out[0][:, kh], out[1][:, kh] = attention_bwd_grads_ref(
                    q[:, qh], k[:, kh], v[:, kh], do[:, qh], lse[:, qh], delta[:, qh], **kw)
            return out

        want = plain()
        err = max(rel_err(dk, want[0]), rel_err(dv, want[1]))
        del want
        check(err <= BWD_TOL["bfloat16"], f"dk/dv {label}: err {err} > {BWD_TOL['bfloat16']}")
        check(finite(dk, dv), f"dk/dv {label}: non-finite grads")
        check(dk.stride() == k.stride() and dv.stride() == v.stride(),
              f"dk/dv {label}: grads not in k's and v's layouts")
        check(all(torch.equal(a, b) for a, b in
                  zip((dk, dv), flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw))),
              f"dk/dv {label}: two identical calls differ")
        qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
        ol = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, scale=kw["scale"],
                                            enable_gqa=True)
        library_ms = device_ms(lambda: torch.autograd.grad(ol, (qs, ks, vs), do,
                                                           retain_graph=True))
        b_ms, b_by = bound(cost.attention_bwd_dkv(q, k, v, do, lse, delta, causal=True),
                           "bfloat16")
        rows[label] = dict(shape=[B, H, KV, T, T, d], strided=True, dtype="bfloat16",
                           causal=True, design=design, label=label, max_abs_err=err,
                           tol=BWD_TOL["bfloat16"],
                           ms=device_ms(lambda: flash_attention_bwd_dkv(q, k, v, do, lse,
                                                                        delta, **kw)),
                           plain_ms=device_ms(plain, plain=True), library_ms=library_ms,
                           bound_ms=b_ms, bound_by=b_by,
                           note="library_ms: SDPA's whole backward (dq, dk and dv)")
        emit("kernel", name="flash_attention_bwd_dkv", **rows[label])
        del q, k, v, do, o, lse, delta, dk, dv, qs, ks, vs, ol
        torch.cuda.empty_cache()
    emit("dkv_phase", card=smi, seconds=time.perf_counter() - t_phase, launches=total,
         kernels=rows)
    return total, rows


def main() -> int:
    import torch

    t_start = time.perf_counter()
    # torch.compile's caches (the flex_attention yardstick) stay in the checkout
    for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(ROOT / "build" / sub))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card",
              file=sys.stderr)
        return 2

    import torch.nn.functional as F

    from repro_torch.actors.policy import make_obs_policy
    from repro_torch.configs import get_arch
    from repro_torch.infserver import InfServer
    from repro_torch.kernels import _build, cost, dispatch
    from repro_torch.kernels.adamw import adamw_update, global_norm
    from repro_torch.kernels.flash_attention.ops import flash_attention_fwd
    from repro_torch.kernels.flash_attention.ref import attention_fwd_ref
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.models import init_params
    from repro_torch.kernels.flash_attention.ops import (
        dkv_design,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
    )
    from repro_torch.kernels.flash_attention.ref import (
        attention_bwd_grads_ref,
        attention_bwd_preprocess_ref,
        attention_bwd_ref,
    )
    from repro_torch.kernels.vtrace_scan.ops import (
        reverse_discounted_scan,
        reverse_discounted_scan_p,
    )
    from repro_torch.kernels.vtrace_scan.ref import reverse_discounted_scan_ref
    from repro_torch.launch.specs import param_shapes
    from repro_torch.learners import build_env_train_step, build_seq_train_step
    from repro_torch.optim import adamw
    from repro_torch.utils import tree_leaves, tree_map, tree_stack

    # -- 1. device ----------------------------------------------------------
    laps, t_lap = {}, [t_start]

    def lap(name):
        """Record the seconds since the last lap under `name`."""
        now = time.perf_counter()
        laps[name], t_lap[0] = now - t_lap[0], now

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    # the dry-run's counts that the mesh phases hold, made beside the card's work
    holds = DryrunHolds()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    emit("device", nvidia_smi=smi, kind=kind, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)

    lap("device")

    # -- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    emit("build", seconds=build_s, nvcc_seconds=_build.build_seconds,
         sources=[str(p.relative_to(ROOT)) for p in _build.sources()],
         ptxas=ptxas_summary(_build.build_log))

    lap("build")

    # -- 3. kernels against their plain versions ------------------------------
    def device_ms(fn, n=20, plain=False):
        """Median device time of one call, from CUDA events around each of n
        back-to-back calls (SLOW_CALLS for a `plain` version whose warm call
        takes SLOW_CALL_S or more, for the script's time). A sleep kernel keeps the card busy
        while the host enqueues them, so host launch overhead does not show
        as device time."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if plain and time.perf_counter() - t0 >= SLOW_CALL_S:
            n = min(n, SLOW_CALLS)
        ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(n)]
        torch.cuda._sleep(100_000_000)
        for a, b in ev:
            a.record()
            fn()
            b.record()
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in ev)

    def bound(work, dtype_name):
        """The least ms the card could take for `work` (`kernels/cost.py`):
        its bytes at HBM_BYTES_PER_S or its operations at the dtype's peak,
        whichever is larger."""
        t_bytes = work.bytes / HBM_BYTES_PER_S
        t_ops = work.flops / PEAK_FLOPS[dtype_name]
        return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"

    def flex_ms(q, k, v, do, scale, window, cap):
        """The library yardstick where no single SDPA call computes the same
        function (a causal window with a softcap): torch.compile'd
        flex_attention, the softcap as score_mod and the window as a block
        mask. Returns {fwd_ms, bwd_ms (dq, dk and dv in one call; only when
        `do` is given), max_abs_err of its o against the plain forward} or
        {error} where it does not compile; the port never calls it."""
        try:
            from torch.nn.attention.flex_attention import create_block_mask, flex_attention

            def mask_mod(b, h, qi, ki):
                return (ki <= qi) & (qi - ki < window)

            def score_mod(score, b, h, qi, ki):
                return cap * torch.tanh(score / cap)
            cap_mod = {"score_mod": score_mod} if cap else {}

            T = q.shape[2]
            block_mask = create_block_mask(mask_mod, None, None, T, T, device=q.device)
            # static shapes: a second shape would otherwise recompile with
            # dynamic ones, which fails to lower
            flex = torch.compile(flex_attention, dynamic=False)
            run = lambda *a: flex(*a, **cap_mod, block_mask=block_mask, scale=scale,
                                  enable_gqa=True)
            leaves = [t.detach().requires_grad_(do is not None) for t in (q, k, v)]
            out = run(*leaves)
            ro, _ = attention_fwd_ref(q, k, v, scale=scale, causal=True, window=window, cap=cap)
            res = {"fwd_ms": device_ms(lambda: run(q, k, v)),
                   "max_abs_err": (out.detach() - ro).abs().max().item()}
            if do is not None:
                res["bwd_ms"] = device_ms(lambda: torch.autograd.grad(out, leaves, do,
                                                                      retain_graph=True))
            return res
        except Exception as e:                # a yardstick only: record why it is missing
            return {"error": f"{type(e).__name__}: {e}"[:400]}

    # the launch floor: an empty kernel timed as device_ms times the kernels,
    # the least any kernel's time can be under this timer
    emit("launch_floor", ms=device_ms(lambda: torch.cuda._sleep(0)))
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
                 ((ENV_B * ENV_T * OBS_LEN, 128), 1, torch.bfloat16, "learner env shape"),
                 ((ENV_B * OBS_LEN, 128), 1, torch.bfloat16, "actor forward"),
                 ((2, ENV_B, OBS_LEN, 128), 2, torch.bfloat16, "served actor, grouped"),
                 ((SEQ_T, 128), 1, torch.float32, "learner seq shape"),
                 ((37, 96), 1, torch.float32, "odd"),
                 # the decode path (prefill of DECODE_B x DECODE_T tokens, a
                 # decode step of DECODE_B rows): hidden widths and qwen3's
                 # q/k norms over (rows, heads, 128)
                 ((DECODE_B * DECODE_T, 2304), 1, torch.bfloat16, "gemma2 prefill"),
                 ((DECODE_B * DECODE_T, 4096), 1, torch.bfloat16, "qwen3 prefill"),
                 ((DECODE_B * DECODE_T, 32, 128), 1, torch.bfloat16, "qwen3 prefill q-norm"),
                 ((DECODE_B * DECODE_T, 8, 128), 1, torch.bfloat16, "qwen3 prefill k-norm"),
                 ((DECODE_B, 2304), 1, torch.bfloat16, "gemma2 decode step"),
                 ((DECODE_B, 4096), 1, torch.bfloat16, "qwen3 decode step"),
                 # the families phase: qwen3-moe's q/k norms (its hidden
                 # width, 4096, is the qwen3 rows'), kimi-k2's, hymba's and
                 # pixtral's hidden widths at prefill (pixtral's rows count
                 # its patch prefix) and at a decode step
                 ((DECODE_B * DECODE_T, 64, 128), 1, torch.bfloat16, "qwen3-moe prefill q-norm"),
                 ((DECODE_B * DECODE_T, 4, 128), 1, torch.bfloat16, "qwen3-moe prefill k-norm"),
                 ((DECODE_B * DECODE_T, 7168), 1, torch.bfloat16, "kimi-k2 prefill"),
                 ((DECODE_B * FAMILY_PROMPT["hymba-1.5b"], 1600), 1, torch.bfloat16,
                  "hymba prefill"),
                 ((DECODE_B * (PATCHES + DECODE_T), 5120), 1, torch.bfloat16, "pixtral prefill"),
                 ((DECODE_B, 7168), 1, torch.bfloat16, "kimi-k2 decode step"),
                 ((DECODE_B, 1600), 1, torch.bfloat16, "hymba decode step"),
                 ((DECODE_B, 5120), 1, torch.bfloat16, "pixtral decode step"),
                 # mistral-large-123b's hidden width (the kernel's warp
                 # path) at prefill and at a decode step
                 ((DECODE_B * DECODE_T, 12288), 1, torch.bfloat16, "mistral prefill"),
                 ((DECODE_B, 12288), 1, torch.bfloat16, "mistral decode step")]
    for (shape, models, dtype, label) in rms_cases:
        d = shape[-1]
        x = torch.randn(*shape, generator=gen, device=dev).to(dtype)
        w = 1.0 + 0.1 * torch.randn(*((models, d) if models > 1 else (d,)),
                                    generator=gen, device=dev)
        err = (rmsnorm(x, w).float() - rmsnorm_ref(x, w).float()).abs().max().item()
        tol = TOL["bfloat16"] if dtype == torch.bfloat16 else TOL["float32"]["rmsnorm"]
        check(err <= tol, f"rmsnorm {label} {shape} {dtype}: err {err} > {tol}")
        ms = device_ms(lambda: rmsnorm(x, w))
        plain_ms = device_ms(lambda: rmsnorm_ref(x, w), plain=True)
        library_ms = None                     # F.rms_norm takes one weight row
        if models == 1:
            wl = w.to(dtype)
            library_ms = device_ms(lambda: F.rms_norm(x, (d,), wl, 1e-6))
        b_ms, b_by = bound(cost.rmsnorm(x, w), "float32")
        r = dict(shape=list(shape), weight_rows=models, dtype=dname[dtype], label=label,
                 max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                 library_ms=library_ms, bound_ms=b_ms, bound_by=b_by)
        results["rmsnorm"].append(r)
        emit("kernel", name="rmsnorm", **r)

    def sdpa_computes(Tq, Tk, causal, window, cap, kv_len):
        """Whether one SDPA call computes this attention: no softcap, no
        tail, a window that masks nothing, causal only at Tq == Tk."""
        return (not cap and kv_len is None and (not window or window >= Tk)
                and (Tq == Tk or not causal))

    S, M = "strided", "contiguous"
    flex_seq = {}
    flash_cases = [
        # B, H, KV, Tq, Tk, d, dtype, mixed, causal, window, cap, kv_len, layout, label
        (ROWS, 4, 2, OBS_LEN, OBS_LEN, 32, torch.bfloat16, False, True, 0, 0.0, None, S,
         "policy-s serving"),
        (ROWS, 4, 2, OBS_LEN, OBS_LEN, 32, torch.bfloat16, True, True, 0, 0.0, None, S,
         "policy-s serving, mixed"),
        (ROWS, 8, 4, OBS_LEN, OBS_LEN, 32, torch.bfloat16, False, True, 0, 0.0, None, S,
         "policy-m serving"),
        (ROWS, 8, 4, OBS_LEN, OBS_LEN, 32, torch.bfloat16, True, True, 0, 0.0, None, S,
         "policy-m serving, mixed"),
        (ENV_B * ENV_T, 4, 2, OBS_LEN, OBS_LEN, 32, torch.bfloat16, False, True, 0, 0.0, None, S,
         "learner env shape"),
        (ENV_B, 4, 2, OBS_LEN, OBS_LEN, 32, torch.bfloat16, False, True, 0, 0.0, None, S,
         "actor forward"),
        (2 * ENV_B, 4, 2, OBS_LEN, OBS_LEN, 32, torch.bfloat16, False, True, 0, 0.0, None, S,
         "served actor, grouped"),
        (1, 4, 2, SEQ_T, SEQ_T, 32, torch.float32, False, True, 512, 30.0, None, S,
         "learner seq shape"),
        (3, 4, 2, 37, 37, 64, torch.float32, False, True, 0, 0.0, None, M, "odd T, GQA"),
        (2, 4, 2, 37, 37, 128, torch.float32, False, True, 0, 0.0, None, M, "odd T, GQA, d=128"),
        (2, 8, 2, 37, 37, 256, torch.float32, False, True, 0, 0.0, None, M, "odd T, GQA, d=256"),
        # the tensor-core regime beyond d = 32, odd T, G in {1, 2, 4}
        (2, 4, 4, 37, 37, 64, torch.bfloat16, False, True, 0, 0.0, None, S, "bf16, d=64, G=1"),
        (2, 4, 2, 50, 50, 128, torch.bfloat16, False, True, 16, 20.0, None, M,
         "bf16, d=128, G=2, window, cap"),
        (2, 8, 2, 65, 65, 256, torch.bfloat16, False, True, 0, 0.0, 60, S,
         "bf16, d=256, G=4, tail"),
        (2, 4, 1, 37, 65, 64, torch.bfloat16, True, False, 0, 0.0, None, S,
         "bf16 mixed, bidirectional, Tq != Tk"),
        (2, 4, 2, 65, 65, 32, torch.float32, False, True, 8, 30.0, 50, S,
         "fp32, window, cap, tail"),
        # the decode path's prefills: gemma2-2b (head dim 256, softcap 50; its
        # local layers' window of 4096 covers T = 1024, so both layer kinds
        # compute this), its sliding prefill (the window bites at T = 4608)
        # and qwen3-8b (head dim 128, no cap). The gemma2 rows draw q at
        # GEMMA2_Q_SCALE so that scores reach the cap and the cap changes
        # the result by more than the tolerance (checked below)
        (DECODE_B, 8, 4, DECODE_T, DECODE_T, 256, torch.bfloat16, False, True, 0, 50.0, None, S,
         "gemma2 prefill"),
        (1, 8, 4, SLIDING_T, SLIDING_T, 256, torch.bfloat16, False, True, 4096, 50.0, None, S,
         "gemma2 sliding prefill, local"),
        (DECODE_B, 32, 8, DECODE_T, DECODE_T, 128, torch.bfloat16, False, True, 0, 0.0, None, S,
         "qwen3 prefill"),
        # the families phase's prefills: G = 16 (qwen3-moe), 8 (kimi-k2), 5
        # (hymba, every layer windowed at 1024) and pixtral's patch prefix
        # + tokens
        (DECODE_B, 64, 4, DECODE_T, DECODE_T, 128, torch.bfloat16, False, True, 0, 0.0, None, S,
         "qwen3-moe prefill"),
        (DECODE_B, 64, 8, DECODE_T, DECODE_T, 128, torch.bfloat16, False, True, 0, 0.0, None, S,
         "kimi-k2 prefill"),
        (DECODE_B, 25, 5, FAMILY_PROMPT["hymba-1.5b"], FAMILY_PROMPT["hymba-1.5b"], 64,
         torch.bfloat16, False, True, 1024, 0.0, None, S, "hymba prefill"),
        (DECODE_B, 32, 8, PATCHES + DECODE_T, PATCHES + DECODE_T, 128, torch.bfloat16, False,
         True, 0, 0.0, None, S, "pixtral prefill"),
        # the decode phase's mistral-large-123b prefill: G = 96 / 8 = 12, so
        # a 64-row stacked block holds 5 1/3 positions (command-r's, 64/8,
        # is kimi-k2's row)
        (DECODE_B, 96, 8, DECODE_T, DECODE_T, 128, torch.bfloat16, False, True, 0, 0.0, None, S,
         "mistral prefill"),
        # hubert-xlarge: 16 heads of 80, bidirectional; its train shape
        # (AUDIO_B x AUDIO_T) in bf16, and the fp32 regime's column split
        # (two 32-column passes and one of 16) at T = 1024
        (AUDIO_B, 16, 16, AUDIO_T, AUDIO_T, 80, torch.bfloat16, False, False, 0, 0.0, None, S,
         "hubert train shape"),
        (1, 16, 16, 1024, 1024, 80, torch.float32, False, False, 0, 0.0, None, S,
         "hubert fp32, d=80"),
    ]
    for (B, H, KV, Tq, Tk, d, dtype, mixed, causal, window, cap, kv_len, layout,
         label) in flash_cases:
        qs = GEMMA2_Q_SCALE if label.startswith("gemma2") else 1.0
        if layout == S:
            # the model's layout: (B, T, H, d) activations viewed as (B, H, T, d)
            q = (qs * torch.randn(B, Tq, H, d, generator=gen, device=dev)).to(dtype) \
                .transpose(1, 2)
            k = torch.randn(B, Tk, KV, d, generator=gen, device=dev).to(dtype).transpose(1, 2)
            v = torch.randn(B, Tk, KV, d, generator=gen, device=dev).to(dtype).transpose(1, 2)
        else:
            q = (qs * torch.randn(B, H, Tq, d, generator=gen, device=dev)).to(dtype)
            k = torch.randn(B, KV, Tk, d, generator=gen, device=dev).to(dtype)
            v = torch.randn(B, KV, Tk, d, generator=gen, device=dev).to(dtype)
        kw = dict(scale=d ** -0.5, causal=causal, window=window, cap=cap, kv_len=kv_len,
                  mixed=mixed)
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
        check(o.stride() == q.stride(), f"flash {label}: o not in q's layout")
        err_without_cap = None
        if qs != 1.0:                         # the kernel without the cap must fail here
            o0, lse0 = flash_attention_fwd(q, k, v, **{**kw, "cap": 0.0})
            err_without_cap = max((o0.float() - ro.float()).abs().max().item(),
                                  (lse0 - rlse).abs().max().item())
            del o0, lse0
            check(err_without_cap > tol,
                  f"flash {label}: the cap moves the result only {err_without_cap} <= {tol}")
        ms = device_ms(lambda: flash_attention_fwd(q, k, v, **kw))
        plain_ms = device_ms(lambda: attention_fwd_ref(q, k, v, **kw), plain=True)
        library_ms = None
        if sdpa_computes(Tq, Tk, causal, window, cap, kv_len):
            library_ms = device_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, scale=d ** -0.5, enable_gqa=True))
        if label == "learner seq shape":
            flex_seq = flex_ms(q, k, v, torch.randn(q.shape, generator=gen, device=dev).to(dtype),
                               d ** -0.5, window, cap)
            emit("flex_attention", label=label, **flex_seq)
            library_ms = flex_seq.get("fwd_ms")
        elif label.startswith(("gemma2", "hymba")):  # a softcap or window SDPA cannot express
            flex = flex_ms(q, k, v, None, d ** -0.5, window or Tq, cap)
            emit("flex_attention", label=label, **flex)
            library_ms = flex.get("fwd_ms")
        b_ms, b_by = bound(cost.attention_fwd(q, k, v, causal=causal, window=window,
                                              kv_len=kv_len), dname[dtype])
        r = dict(shape=[B, H, KV, Tq, Tk, d], strided=not q.is_contiguous(),
                 dtype=dname[dtype], mixed=mixed, causal=causal, window=window,
                 cap=cap, kv_len=kv_len, label=label, max_abs_err=err, tol=tol,
                 q_scale=qs, err_without_cap=err_without_cap, ms=ms,
                 plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms, bound_by=b_by)
        results["flash_attention_fwd"].append(r)
        emit("kernel", name="flash_attention_fwd", **r)
    # hubert's serving pass (prefill_32k, the batch cut to AUDIO_PREFILL_B):
    # the kernel over all AUDIO_PREFILL_T frames, held against the plain
    # version on its first and last SLICE_Q queries against every key (the
    # attention is bidirectional, so a slice of the queries is exact; the
    # whole plain score matrix would take 64 GiB). The plain time is the
    # plain version run over every SLICE_Q-query slice in turn.
    B, H, T, d, SLICE_Q = AUDIO_PREFILL_B, 16, AUDIO_PREFILL_T, 80, 1024
    q, k, v = (torch.randn(B, T, H, d, generator=gen, device=dev).to(torch.bfloat16)
               .transpose(1, 2) for _ in range(3))
    kw = dict(scale=d ** -0.5, causal=False)
    o, lse = flash_attention_fwd(q, k, v, **kw)
    err = 0.0
    for s0 in (0, T - SLICE_Q):
        ro, rlse = attention_fwd_ref(q[:, :, s0:s0 + SLICE_Q], k, v, **kw)
        err = max(err, (o[:, :, s0:s0 + SLICE_Q].float() - ro.float()).abs().max().item(),
                  (lse[:, :, s0:s0 + SLICE_Q] - rlse).abs().max().item())
        del ro, rlse
    tol = TOL["bfloat16"]
    check(err <= tol, f"flash hubert prefill: err {err} > {tol}")
    check(bool(torch.isfinite(o.float()).all()), "flash hubert prefill: non-finite o")
    b_ms, b_by = bound(cost.attention_fwd(q, k, v, causal=False), "bfloat16")
    r = dict(shape=[B, H, H, T, T, d], strided=True, dtype="bfloat16", mixed=False,
             causal=False, window=0, cap=0.0, kv_len=None, label="hubert prefill",
             checked_queries=[[0, SLICE_Q], [T - SLICE_Q, T]], max_abs_err=err, tol=tol,
             ms=device_ms(lambda: flash_attention_fwd(q, k, v, **kw)),
             plain_ms=device_ms(lambda: [attention_fwd_ref(q[:, :, s0:s0 + SLICE_Q], k, v, **kw)
                                         for s0 in range(0, T, SLICE_Q)], n=3),
             library_ms=device_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=d ** -0.5)),
             bound_ms=b_ms, bound_by=b_by)
    results["flash_attention_fwd"].append(r)
    emit("kernel", name="flash_attention_fwd", **r)
    del q, k, v, o, lse
    torch.cuda.empty_cache()

    for lbl in ("policy-s serving", "policy-m serving"):
        r = next(x for x in results["flash_attention_fwd"] if x["label"] == lbl)
        check(r["ms"] <= r["library_ms"],
              f"flash {lbl}: {r['ms']} ms, slower than SDPA's {r['library_ms']} ms")

    # edge cases the serving shapes do not reach: the RMSNorm two-pass
    # kernel's scalar path (odd d, misaligned x), odd rows (the last
    # half-warp has no row), a warp whose rows straddle two models, two
    # vectors per lane (d = 256 fp32), the q/k-norm width (d = 32); and
    # flash attention on strided (B, T, H, d) views with a tail (kv_len), a
    # window that leaves rows with no live key (o = 0, lse = 0), and
    # bidirectional attention with Tq != Tk
    edge = {}
    rms_edges = [  # x shape, weight rows, dtype, element offset of x
        ((9, 33), 1, torch.float32, 0), ((9, 64), 1, torch.float32, 1),
        ((37, 128), 1, torch.bfloat16, 0), ((2, 3, 5, 128), 2, torch.bfloat16, 0),
        ((37, 256), 1, torch.float32, 0), ((5, OBS_LEN, 4, 32), 1, torch.bfloat16, 0)]
    for shape, models, dtype, off in rms_edges:
        n, d = int(np.prod(shape)), shape[-1]
        x = torch.randn(n + off, generator=gen, device=dev).to(dtype)[off:].view(shape)
        w = torch.randn(*((models, d) if models > 1 else (d,)), generator=gen, device=dev)
        tol = TOL["bfloat16"] if dtype == torch.bfloat16 else TOL["float32"]["rmsnorm"]
        edge[f"rmsnorm {shape} {dname[dtype]} weight rows={models} offset={off}"] = (
            (rmsnorm(x, w).float() - rmsnorm_ref(x, w).float()).abs().max().item(), tol)
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
    # the forward and dk/dv kernels copy 16-byte chunks: a misaligned view
    # raises in the wrapper, it never reaches a kernel or a scalar path
    qm = torch.randn(2 * 4 * 26 * 32 + 1, generator=gen, device=dev)[1:].view(2, 4, 26, 32)
    try:
        flash_attention_fwd(qm, qm[:, :2], qm[:, :2], scale=0.2)
        check(False, "flash: a misaligned view did not raise")
    except ValueError:
        pass
    emit("kernel_edges", max_abs_err={k: e for k, (e, _) in edge.items()})

    lap("kernels")

    # -- 3b. the learner's kernels against their plain versions ---------------
    # The delta preprocess runs in dq's prologue: its entry holds the fused
    # kernel's delta against the plain preprocess, with the fused kernel's
    # time and the preprocess's own bound, plain and library times.
    for name in ("flash_attention_bwd_preprocess", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv", "reverse_discounted_scan_p"):
        results[name] = []
    bwd_cases = [
        # B, H, KV, Tq, Tk, d, dtype, causal, window, cap, kv_len, layout, label
        (ENV_B * ENV_T, 4, 2, OBS_LEN, OBS_LEN, 32, torch.bfloat16, True, 0, 0.0, None,
         "bthd", "learner env shape"),
        (1, 4, 2, SEQ_T, SEQ_T, 32, torch.float32, True, 512, 30.0, None, "bthd",
         "learner seq shape"),
        (3, 2, 2, 37, 37, 64, torch.float32, True, 0, 0.0, None, "bthd", "odd T, G=1"),
        (2, 4, 2, 37, 37, 128, torch.float32, True, 5, 20.0, None, "bhtd",
         "odd T, G=2, window, cap"),
        (2, 8, 2, 37, 37, 256, torch.float32, True, 0, 0.0, None, "bthd", "odd T, G=4"),
        (2, 4, 1, 50, 50, 32, torch.bfloat16, True, 8, 0.0, None, "bhtd", "bf16, G=4, window"),
        (2, 4, 2, 48, 48, 32, torch.float32, True, 8, 30.0, 40, "bthd",
         "tail, rows with no live key"),
        (1, 4, 2, 100, 100, 32, torch.bfloat16, True, 8, 30.0, 40, "bthd",
         "bf16, a q tile with no live key"),
        (2, 4, 2, 5, 40, 32, torch.float32, False, 0, 0.0, None, "bthd", "bidirectional, Tq != Tk"),
        # the tensor-core regime beyond d = 32, odd T, G in {1, 2, 4}
        (2, 4, 4, 37, 37, 64, torch.bfloat16, True, 0, 0.0, None, "bthd", "bf16, d=64, G=1"),
        (2, 4, 2, 50, 50, 128, torch.bfloat16, True, 16, 20.0, None, "bhtd",
         "bf16, d=128, G=2, window, cap"),
        (2, 8, 2, 65, 65, 256, torch.bfloat16, True, 0, 0.0, 60, "bthd",
         "bf16, d=256, G=4, tail"),
        (2, 4, 1, 37, 65, 64, torch.bfloat16, False, 0, 0.0, None, "bthd",
         "bf16, bidirectional, Tq != Tk"),
        (2, 4, 2, 65, 65, 32, torch.float32, True, 8, 30.0, 50, "bthd",
         "fp32, window, cap, tail"),
        # the audio and the families' train steps: hubert's (d = 80,
        # bidirectional; bf16 at its train shape, fp32 for the column
        # split), and the backward at G = 16 (qwen3-moe), 8 (kimi-k2) and 5
        # (hymba, window 1024)
        (AUDIO_B, 16, 16, AUDIO_T, AUDIO_T, 80, torch.bfloat16, False, 0, 0.0, None, "bthd",
         "hubert train shape"),
        (1, 16, 16, 1024, 1024, 80, torch.float32, False, 0, 0.0, None, "bthd",
         "hubert fp32, d=80"),
        (4, 64, 4, 1024, 1024, 128, torch.bfloat16, True, 0, 0.0, None, "bthd",
         "qwen3-moe train, G=16"),
        (4, 64, 8, 1024, 1024, 128, torch.bfloat16, True, 0, 0.0, None, "bthd",
         "kimi-k2 train, G=8"),
        (4, 25, 5, 256, 256, 64, torch.bfloat16, True, 1024, 0.0, None, "bthd",
         "hymba train, G=5"),
        # the train_families phase's other attention shapes: pixtral's
        # (PATCHES patches + 1024 tokens, G = 4) and gemma2-2b's (softcap 50;
        # its local layers pass the 4096 window, which masks nothing here)
        (4, 32, 8, PATCHES + 1024, PATCHES + 1024, 128, torch.bfloat16, True, 0, 0.0, None,
         "bthd", "pixtral train, G=4"),
        (4, 8, 4, 1024, 1024, 256, torch.bfloat16, True, 0, 50.0, None, "bthd",
         "gemma2-2b train, global"),
        (4, 8, 4, 1024, 1024, 256, torch.bfloat16, True, 4096, 50.0, None, "bthd",
         "gemma2-2b train, local"),
    ]
    flex_bwd = {}
    for (B, H, KV, Tq, Tk, d, dtype, causal, window, cap, kv_len, layout, label) in bwd_cases:
        def make(heads, T):
            if layout == "bhtd":
                return torch.randn(B, heads, T, d, generator=gen, device=dev).to(dtype)
            return torch.randn(B, T, heads, d, generator=gen, device=dev).to(dtype).transpose(1, 2)

        q, k, v, do = make(H, Tq), make(KV, Tk), make(KV, Tk), make(H, Tq)
        kw = dict(scale=d ** -0.5, causal=causal, window=window, cap=cap, kv_len=kv_len)
        o, lse = flash_attention_fwd(q, k, v, **kw)

        def backward():
            dq, delta = flash_attention_bwd_dq(q, k, v, o, do, lse, **kw)
            return (delta, dq) + flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)

        got = backward()
        plain = attention_bwd_ref(q, k, v, o, lse, do, **kw)
        tol = BWD_TOL[dname[dtype]]
        errs = {n: rel_err(a, b) for n, a, b in zip(("delta", "dq", "dk", "dv"), got, plain)}
        for n, e in errs.items():
            t = BWD_TOL["float32"] if n == "delta" else tol
            check(e <= t, f"flash backward {label}: {n} err {e} > {t}")
        check(all(bool(torch.isfinite(t.float()).all()) for t in got),
              f"flash backward {label}: non-finite grads")
        check(got[1].stride() == q.stride() and got[2].stride() == k.stride()
              and got[3].stride() == v.stride(), f"flash backward {label}: grads not in the inputs' layout")
        again = backward()                    # no atomics: bitwise deterministic
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"flash backward {label}: two identical calls differ")
        delta = got[0]
        masks = dict(causal=causal, window=window, kv_len=kv_len)
        work = {"flash_attention_bwd_preprocess": cost.attention_bwd_preprocess(o),
                "flash_attention_bwd_dq": cost.attention_bwd_dq(q, k, v, o, do, lse, **masks),
                "flash_attention_bwd_dkv": cost.attention_bwd_dkv(q, k, v, do, lse, delta,
                                                                  **masks)}
        fused_ms = device_ms(lambda: flash_attention_bwd_dq(q, k, v, o, do, lse, **kw))
        calls = {"flash_attention_bwd_preprocess": (
                     fused_ms, lambda: attention_bwd_preprocess_ref(o, do),
                     lambda: torch.einsum("bhtd,bhtd->bht", o, do)),
                 "flash_attention_bwd_dq": (
                     fused_ms, lambda: attention_bwd_ref(q, k, v, o, lse, do, **kw)[:2], None),
                 "flash_attention_bwd_dkv": (
                     device_ms(lambda: flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)),
                     lambda: attention_bwd_grads_ref(q, k, v, do, lse, delta, **kw), None)}
        whole_bwd_ms = None
        if sdpa_computes(Tq, Tk, causal, window, cap, kv_len):
            # the library's whole backward (dq, dk and dv in one call)
            qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
            ol = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal, scale=d ** -0.5,
                                                enable_gqa=True)
            whole_bwd_ms = device_ms(lambda: torch.autograd.grad(ol, (qs, ks, vs), do,
                                                                 retain_graph=True))
        elif label == "learner seq shape":
            whole_bwd_ms = flex_seq.get("bwd_ms")  # phase 3's flex_attention, this shape
        elif label.startswith("gemma2-2b train"):
            # the softcap rules SDPA out: compiled flex_attention's backward,
            # the cap as its score_mod. The local layers' 4096 window masks
            # nothing at T = 1024, so both rows compute one function: timed once
            if "gemma2_train" not in flex_bwd:
                flex_bwd["gemma2_train"] = flex_ms(q, k, v, do, d ** -0.5, Tq, cap)
                emit("flex_attention", label="gemma2-2b train", **flex_bwd["gemma2_train"])
            whole_bwd_ms = flex_bwd["gemma2_train"].get("bwd_ms")
        # errors relative to max(1, max |plain|): delta, dq, max of dk and dv
        err_of = {"flash_attention_bwd_preprocess": errs["delta"],
                  "flash_attention_bwd_dq": errs["dq"],
                  "flash_attention_bwd_dkv": max(errs["dk"], errs["dv"])}
        tol_of = {"flash_attention_bwd_preprocess": BWD_TOL["float32"],
                  "flash_attention_bwd_dq": tol, "flash_attention_bwd_dkv": tol}
        for name, (ms, plain_fn, library_fn) in calls.items():
            b_ms, b_by = bound(work[name], dname[dtype])
            library_ms = device_ms(library_fn) if library_fn else whole_bwd_ms
            r = dict(shape=[B, H, KV, Tq, Tk, d], strided=layout == "bthd",
                     dtype=dname[dtype], window=window, cap=cap, kv_len=kv_len,
                     label=label, max_abs_err=err_of[name], tol=tol_of[name],
                     ms=ms, plain_ms=device_ms(plain_fn, plain=True),
                     library_ms=library_ms, bound_ms=b_ms, bound_by=b_by)
            if name == "flash_attention_bwd_preprocess":
                r["note"] = "runs inside flash_attention_bwd_dq: ms is the fused kernel's"
            if name == "flash_attention_bwd_dkv":
                r["design"] = dkv_design(q, k, v)
            results[name].append(r)
            emit("kernel", name=name, **r)

    scan_cases = [  # B, T, dtype, element offset of deltas and decays, label
        (ENV_B, ENV_T, torch.float32, 0, "GAE, env step"),
        (1, SEQ_T, torch.float32, 0, "V-trace, seq step"),
        (13, 100, torch.float32, 0, "odd"), (4, 40, torch.bfloat16, 0, "bf16 inputs"),
        (5, 1, torch.float32, 0, "T = 1"), (1, SEQ_T + 1, torch.float32, 0, "T = 4097"),
        (3, SEQ_T, torch.bfloat16, 0, "bf16, three long rows"),
        (ENV_B, ENV_T, torch.float32, 1, "misaligned views, env shape"),
        (3, SEQ_T, torch.bfloat16, 1, "misaligned views, bf16 long rows")]

    def at_offset(t, off):
        """t as a contiguous view `off` elements into its storage."""
        return torch.cat([t.new_zeros(off), t.flatten()])[off:].view(t.shape) if off else t

    for (B, T, dtype, off, label) in scan_cases:
        deltas = at_offset(torch.randn(B, T, generator=gen, device=dev).to(dtype), off)
        decays = at_offset((0.99 * torch.rand(B, T, generator=gen, device=dev)).to(dtype), off)
        init = torch.randn(B, generator=gen, device=dev)
        y = reverse_discounted_scan_p(deltas, decays, init)
        ry = reverse_discounted_scan_ref(deltas, decays, init)
        fwd_err = ((y - ry).abs().max() / ry.abs().max()).item()
        check(fwd_err <= SCAN_TOL, f"scan {label}: err {fwd_err} of max |y| > {SCAN_TOL}")
        check(torch.equal(y, reverse_discounted_scan_p(deltas, decays, init)),
              f"scan {label}: two identical calls differ")
        # the closed-form backward (the kernel on flipped arrays) against
        # autograd through the plain loop
        g = torch.randn(B, T, generator=gen, device=dev)
        leaves = [t.detach().requires_grad_() for t in (deltas, decays, init)]
        gk = torch.autograd.grad((reverse_discounted_scan(*leaves) * g).sum(), leaves)
        gr = torch.autograd.grad((reverse_discounted_scan_ref(*leaves) * g).sum(), leaves)
        gtol = SCAN_TOL if dtype == torch.float32 else TOL["bfloat16"]
        bwd_err = max(((a.float() - b.float()).abs().max()
                       / b.float().abs().max().clamp(min=1e-30)).item() for a, b in zip(gk, gr))
        check(bwd_err <= gtol, f"scan {label}: backward err {bwd_err} > {gtol}")
        b_ms, b_by = bound(cost.reverse_scan(deltas, decays, init), "float32")
        r = dict(shape=[B, T], dtype=dname[dtype], offset=off, label=label, max_abs_err=fwd_err,
                 bwd_err=bwd_err, tol=SCAN_TOL,
                 ms=device_ms(lambda: reverse_discounted_scan_p(deltas, decays, init)),
                 plain_ms=device_ms(lambda: reverse_discounted_scan_ref(deltas, decays, init),
                                    plain=True),
                 library_ms=None, bound_ms=b_ms, bound_by=b_by)
        results["reverse_discounted_scan_p"].append(r)
        emit("kernel", name="reverse_discounted_scan_p", **r)

    lap("kernels_bwd_scan")

    optimizer = optimizer_kernels(dev, device_ms, bound)
    lap("kernels_optimizer")

    # -- 4. serve the policy nets through the InfServer -----------------------
    counters = (rmsnorm, flash_attention_fwd, flash_attention_bwd_dq, flash_attention_bwd_dkv,
                reverse_discounted_scan_p, adamw_update, global_norm)
    serve_kernels = ("rmsnorm", "flash_attention_fwd")
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
    launches = {"serve": {c.__name__: c.launches for c in counters}}
    for name in serve_kernels:
        check(launches["serve"][name] > 0, f"{name} was never launched on the serving path")

    lap("serve")

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

    lap("serve_vs_cpu")

    # -- 6. train: env steps and sequence steps on the card ---------------------
    # Per step, forward: 2 RMSNorms per layer and the final one, 1 attention
    # per layer; backward: dq (which computes delta in its prologue, so the
    # preprocess has no launch of its own) and dk/dv per layer; 1 scan (GAE
    # or V-trace; its backward is not on the path: the targets are detached).
    # remat runs each unit's forward again in the backward. Then the
    # optimizer's (`optimizer_launches`).
    cfg_env = get_arch("tleague-policy-s")
    cfg_seq = seq_config(get_arch)
    L = cfg_env.num_layers
    per_step = {
        "env": {"rmsnorm": 2 * L + 1, "flash_attention_fwd": L, "flash_attention_bwd_dq": L,
                "flash_attention_bwd_dkv": L, "reverse_discounted_scan_p": 1,
                **optimizer_launches(param_shapes(cfg_env))},
        "seq": {"rmsnorm": 4 * L + 1, "flash_attention_fwd": 2 * L, "flash_attention_bwd_dq": L,
                "flash_attention_bwd_dkv": L, "reverse_discounted_scan_p": 1,
                **optimizer_launches(param_shapes(cfg_seq))}}
    train = {}
    for c in counters:
        c.launches = 0
    dispatch.stats(reset=True)
    learn_rng = np.random.default_rng(4)
    for which, cfg, n_steps in (("env", cfg_env, ENV_STEPS), ("seq", cfg_seq, SEQ_STEPS)):
        opt = adamw(3e-4, clip_norm=1.0)
        if which == "env":
            step = build_env_train_step(cfg, NUM_ACTIONS, opt)
            batch = env_batch(learn_rng, ENV_B, ENV_T, dev)
        else:
            step = build_seq_train_step(cfg, opt, loss="vtrace", remat=True)
            batch = seq_batch(learn_rng, SEQ_T, cfg.vocab_size, dev)
        params = init_params(torch.Generator(device=dev).manual_seed(5), cfg)
        state = opt.init(params)
        first = tree_map(torch.clone, params)
        before = {c.__name__: c.launches for c in counters}
        designs_before = dkv_designs()
        times, losses = [], []
        for _ in range(n_steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, metrics = step(params, state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(metrics["loss"].item())
        check(all(np.isfinite(losses)), f"{which} step: non-finite loss {losses}")
        check(all(bool(torch.isfinite(p).all()) for p in tree_leaves(params)),
              f"{which} step: non-finite params")
        check(any(not torch.equal(a, b) for a, b in zip(tree_leaves(params), tree_leaves(first))),
              f"{which} step: params unchanged")
        for c in counters:
            n = c.launches - before[c.__name__]
            want = n_steps * per_step[which][c.__name__]
            check(n == want, f"{which} step: {c.__name__} launched {n} times, want {want}")
        # the policy's d = 32 (and the env step's T = 26): the mma.sync dk/dv
        designs = {k: v - designs_before[k] for k, v in dkv_designs().items()}
        check(designs == {"mma_sync": n_steps * L, "wgmma": 0},
              f"{which} step: dk/dv launches by design {designs}")
        train[which] = {"median_step_ms": 1e3 * statistics.median(times),
                       "step_ms": [round(1e3 * t, 3) for t in times], "losses": losses,
                       "metrics": {k: v.item() for k, v in metrics.items()}}
        emit("train", kind=which, arch=cfg.name, steps=n_steps,
             batch=[ENV_B, ENV_T, OBS_LEN] if which == "env" else [1, SEQ_T],
             compute_dtype=cfg.compute_dtype, launches_per_step=per_step[which],
             kernel_launches_per_step=sum(per_step[which].values()), **train[which])
    launches["train"] = {c.__name__: c.launches for c in counters}
    for name, n in launches["train"].items():
        check(n > 0, f"{name} was never launched on the learner path")
    st = dispatch.stats()
    for op in ("attention", "rmsnorm", "reverse_scan", "global_norm", "adamw"):
        check(st.get(f"{op}|kernel", 0) > 0, f"learner path: {op} not on the kernel tier")
    check(not any("|reference" in key for key in st),
          f"learner path: plain versions ran on the card: {st}")
    emit("train_dispatch", stats=st)

    lap("train")

    # -- 7. train step 1 on the card against the port's CPU step (fp32) --------
    learn_vs_cpu = {}
    for which, cfg in (("env", dataclasses.replace(cfg_env, compute_dtype="float32")),
                      ("seq", cfg_seq)):
        opt = with_grads(adamw(3e-4, clip_norm=1.0))
        if which == "env":
            step = build_env_train_step(cfg, NUM_ACTIONS, opt)
            batch = env_batch(learn_rng, ENV_B, ENV_T, "cpu")
        else:
            step = build_seq_train_step(cfg, opt, loss="vtrace", remat=True)
            batch = seq_batch(learn_rng, SEQ_T, cfg.vocab_size, "cpu")
        params = init_params(torch.Generator().manual_seed(6), cfg)
        to_dev = lambda t: tree_map(lambda a: a.to(dev), t)
        _, _, m_cpu = step(params, opt.init(params), batch)
        _, _, m_dev = step(to_dev(params), opt.init(to_dev(params)), to_dev(batch))
        errs = {"loss": abs(m_dev["loss"].item() - m_cpu["loss"].item()),
                "grads": max((a.cpu() - b).abs().max().item() for a, b in
                             zip(tree_leaves(m_dev["grads"]), tree_leaves(m_cpu["grads"])))}
        learn_vs_cpu[which] = max(errs.values())
        for name, e in errs.items():
            check(e <= CARD_VS_CPU_TOL, f"{which} step card vs CPU ({name}): {e} > {CARD_VS_CPU_TOL}")
        emit("train_card_vs_cpu", kind=which, compute_dtype="float32", max_abs_err=errs,
             tol=CARD_VS_CPU_TOL)

    lap("train_vs_cpu")

    # -- 8. league: the learner's side of the loop on the card ------------------
    launches["league"], league_out = league_phase(dev, cfg_env, counters, smi, per_step)
    lap("league")

    # -- 9. envs, actors, the quickstart loop, the runtime, a checkpoint -------
    # a policy-s forward: 2 RMSNorms per layer and the final one, 1 attention
    # per layer; a local segment runs 2T + 1 forwards, a served one T + 1
    # flushes (each step's θ and φ in one grouped forward)
    per_forward = {"rmsnorm": 2 * cfg_env.num_layers + 1,
                   "flash_attention_fwd": cfg_env.num_layers}
    envs_out = envs_phase(dev, smi)
    lap("envs")
    launches["actors"], actors_out, theta0 = actors_phase(dev, cfg_env, counters, smi,
                                                          per_forward)
    lap("actors")
    launches["league_loop"], loop_out, loop_learner = league_loop_phase(
        dev, cfg_env, counters, smi, per_forward, per_step, theta0)
    lap("league_loop")
    launches["runtime"], runtime_out = runtime_phase(dev, cfg_env, counters, smi, per_forward,
                                                     per_step)
    lap("runtime")
    checkpoint_phase(dev, loop_learner, smi)
    lap("checkpoint")

    # -- 10. the league across processes: transport, multiprocess, fleet ------
    launches["transport"], transport_out = transport_phase(dev, cfg_env, counters, smi,
                                                           per_forward)
    lap("transport")
    launches["multiprocess"], mp_out = multiprocess_phase(smi, per_forward, per_step)
    lap("multiprocess")
    launches["fleet"], fleet_out = fleet_phase(dev, cfg_env, smi, per_forward)
    lap("fleet")
    launches["faults"], faults_out = faults_phase(smi, list(SOURCES))
    lap("faults")
    launches["examples"], examples_out = examples_phase(counters, smi, per_forward, per_step)
    lap("examples")
    for path in ("actors", "league_loop", "runtime", "transport", "multiprocess", "fleet",
                 "faults", "examples"):
        for name in ("rmsnorm", "flash_attention_fwd"):
            check(launches[path][name] > 0, f"{name} was never launched on the {path} path")
    for path in ("league_loop", "runtime", "multiprocess", "faults", "examples"):
        for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv",
                     "reverse_discounted_scan_p"):
            check(launches[path][name] > 0, f"{name} was never launched on the {path} path")

    # -- 11. decode: prefill and KV-cache decode at full width -----------------
    launches["decode"], decode_out = decode_phase(dev, counters, smi)
    lap("decode")
    for name in ("rmsnorm", "flash_attention_fwd"):
        check(launches["decode"][name] > 0, f"{name} was never launched on the decode path")

    # -- 12. the moe, ssm, hybrid and vlm families at full width -------------
    launches["families"], families_out = families_phase(dev, counters, smi)
    lap("families")
    for name in ("rmsnorm", "flash_attention_fwd"):
        check(launches["families"][name] > 0, f"{name} was never launched on the families path")

    # -- 13. the audio family and every family's train step ------------------
    launches["audio"], audio_out = audio_phase(dev, counters, smi)
    lap("audio")
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        check(launches["audio"][name] > 0, f"{name} was never launched on the audio path")
    launches["train_families"], train_families_out = train_families_phase(dev, counters, smi)
    lap("train_families")
    for name in SOURCES:
        if name != "flash_attention_bwd_preprocess":
            check(launches["train_families"][name] > 0,
                  f"{name} was never launched on the train_families path")
    # latent attention: its (192, 128) kernels and kimi-k2-instruct's train step
    launches["mla"], mla_rows, mla_train, mla_designs = mla_phase(dev, counters, smi,
                                                                   device_ms, bound)
    lap("mla")
    # the dense learn cells' dk/dv, on its warpgroup-MMA design
    launches["dkv"], dkv_rows = dkv_phase(dev, counters, smi, device_ms, bound)
    lap("dkv")

    # -- 14. the mesh: a (1, 1) DeviceMesh of this card ---------------------------
    launches["mesh"], mesh_out = mesh_phase(dev, counters, smi, per_forward, holds)
    lap("mesh")
    for name in SOURCES:
        if name != "flash_attention_bwd_preprocess":
            check(launches["mesh"][name] > 0, f"{name} was never launched on the mesh path")

    # -- 15. the mesh split over two gloo ranks of this card ----------------------
    launches["mesh_split"], split_ranks, split_out = mesh_split_phase(smi, list(SOURCES),
                                                                      holds)
    lap("mesh_split")

    # -- 16. summary -------------------------------------------------------------
    # main-path shapes by label, and launches per unit of the main path: per
    # flush (policy-s, policy-m), per env step and per seq step
    main_shapes = ("policy-s serving", "policy-m serving", "learner env shape",
                   "learner seq shape", "GAE, env step", "V-trace, seq step", "actor forward",
                   "served actor, grouped", "gemma2 prefill", "gemma2 sliding prefill, local",
                   "qwen3 prefill", "qwen3 prefill q-norm", "qwen3 prefill k-norm",
                   "gemma2 decode step", "qwen3 decode step", "qwen3-moe prefill q-norm",
                   "qwen3-moe prefill k-norm", "kimi-k2 prefill", "hymba prefill",
                   "pixtral prefill", "kimi-k2 decode step", "hymba decode step",
                   "pixtral decode step", "qwen3-moe prefill", "hubert train shape",
                   "qwen3-moe train, G=16", "kimi-k2 train, G=8", "hymba train, G=5",
                   "hubert prefill", "pixtral train, G=4", "gemma2-2b train, global",
                   "gemma2-2b train, local", "mistral prefill", "mistral decode step")
    per_unit = {name: {"flush_policy_s": 0, "flush_policy_m": 0,
                       "env_step": per_step["env"].get(name, 0),
                       "seq_step": per_step["seq"].get(name, 0),
                       "local_segment": (2 * ACT_T + 1) * per_forward.get(name, 0),
                       "served_segment": (ACT_T + 1) * per_forward.get(name, 0),
                       "runtime_learner_step": runtime_out["runs"]["prefetch"][
                           "launches_per_learner_step"].get(name, 0),
                       **{f"{unit}_{arch}": rec[f"launches_per_{unit}"].get(name, 0)
                          for arch, rec in {**decode_out, **families_out}.items()
                          for unit in ("prefill", "step")},
                       "prefill_hubert-xlarge": audio_out["launches_per_prefill"].get(name, 0),
                       "mlm_step_hubert-xlarge": audio_out["launches_per_step"].get(name, 0),
                       **{f"train_step_{arch}": rec["launches_per_step"].get(name, 0)
                          for arch, rec in train_families_out.items()},
                       "mesh_flush_policy_s": per_forward.get(name, 0),
                       "mesh_train_step_qwen3-8b": mesh_out["train"]["launches_per_step"].get(
                           name, 0),
                       f"mesh_prefill_{MESH_DECODE_ARCH}":
                           mesh_out["decode"]["launches_per_prefill"].get(name, 0),
                       "train_step_kimi-k2-instruct.l6": mla_train["launches_per_step"].get(
                           name, 0)}
                for name in (*SOURCES, "adamw_update", "global_norm")}
    for arch, key in (("tleague-policy-s", "flush_policy_s"),
                      ("tleague-policy-m", "flush_policy_m")):
        L = get_arch(arch).num_layers
        per_unit["rmsnorm"][key], per_unit["flash_attention_fwd"][key] = 2 * L + 1, L
    kernels = []
    for name, (src, replaces) in SOURCES.items():
        head = results[name][0]   # the policy-s serving shape; the env step's for the learner's
        by_path = {path: counts.get(name, 0) for path, counts in launches.items()}
        kernels.append({"name": name, "route": "cuda", "source": src,
                        **({"note": head["note"]} if "note" in head else {}),
                        "replaces": replaces, "launches": sum(by_path.values()),
                        "launches_by_path": by_path, "launches_per_unit": per_unit[name],
                        "launches_mesh_split_each_rank": [r[name] for r in split_ranks],
                        "max_abs_err": max(r["max_abs_err"] for r in results[name]),
                        "ms": head["ms"], "plain_ms": head["plain_ms"],
                        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
                        "library_ms": head["library_ms"], "shape": head["shape"],
                        "dtype": head["dtype"],
                        "main_path_ms": {r["label"]: [r["ms"], r["bound_ms"]]
                                         for r in results[name] if r["label"] in main_shapes}})
    # the optimizer's kernels, which replace no TPU kernel
    for name in ("adamw_update", "global_norm"):
        by_path = {path: counts.get(name, 0) for path, counts in launches.items()}
        kernels.append({"name": name, "route": "cuda",
                        "source": "src/repro_torch/kernels/csrc/adamw.cu",
                        "replaces": None, "launches": sum(by_path.values()),
                        "launches_by_path": by_path, "launches_per_unit": per_unit[name],
                        **{key: optimizer[name][key] for key in (
                            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                            "shape", "dtype")}})
    # latent attention's kernels, which replace no TPU kernel (the JAX
    # package has no latent attention): only the mla path's train steps
    # launch them, since no other path runs a model with v narrower than q;
    # the dk/dv rows count their own design's launches
    for name, (wrapper, src, design) in MLA_KERNELS.items():
        n, per_step = ((launches["mla"][wrapper], mla_train["launches_per_step"][wrapper])
                       if design is None else
                       (mla_designs[design], mla_train["dkv_launches_per_step_by_design"][design]))
        kernels.append({"name": name, "wrapper": wrapper, "route": "cuda", "source": src,
                        **({"note": mla_rows[name]["note"]} if "note" in mla_rows[name] else {}),
                        **({"design": design} if design else {}),
                        "replaces": None, "launches": n, "launches_by_path": {"mla": n},
                        "launches_per_unit": {"train_step_kimi-k2-instruct.l6": per_step},
                        **{key: mla_rows[name][key] for key in (
                            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                            "shape", "dtype")}})
    # a short digest first, so a log that keeps only the tail still has it:
    # serve is [median flush ms, rows/s] per flush kind at 256 rows; train is
    # the median step ms
    emit("summary", card=smi, build_s=round(build_s, 2), nvcc_s=_build.build_seconds,
         serve=serve, card_vs_cpu_max_err=card_vs_cpu,
         train={k: round(v["median_step_ms"], 3) for k, v in train.items()},
         train_card_vs_cpu_max_err=learn_vs_cpu,
         league={k: round(v, 3) for k, v in league_out.items()},
         envs_step_ms={k: v["step_ms"] for k, v in envs_out.items()},
         actors={m: [round(v["segment_ms"], 3), round(v["frames_per_s"], 1)]
                 for m, v in actors_out.items()},
         league_loop=[round(loop_out["iteration_ms"], 3), round(loop_out["learn_ms"], 3)],
         runtime={m: [v["frames_per_s"], round(v["learn_ms_median"], 3)]
                  for m, v in runtime_out["runs"].items()},
         transport={"noop_rtt_ms": round(transport_out["noop_rtt_ms_median"], 4),
                    "pull_ms": {c: {k: round(v["ms_median"], 3) for k, v in p.items()
                                    if k != "push_ms"}
                                for c, p in transport_out["pulls"].items()},
                    "put_ms": round(transport_out["put_when_room_ms_median"], 3)},
         multiprocess={m: [round(v["frames_per_s"], 1),
                           round((v["after_first_steps"] or {}).get("frames_per_s") or 0.0, 1),
                           round(v["actor_loop_frames_per_s"], 1),
                           round(v["actor_segment_only_frames_per_s"], 1),
                           round(v["learner_steps_per_s"], 2)] for m, v in mp_out.items()},
         fleet=[round(fleet_out["gateway_rows_per_s"]), round(fleet_out["inproc_rows_per_s"])],
         faults={n: round(v["command_s"], 1) for n, v in faults_out["smokes"].items()},
         examples={n: round(v["seconds"], 1) for n, v in examples_out.items()},
         decode={a: [round(v["prefill_ms_median"], 3), round(v["decode_ms_median"], 3),
                     v["consistency"]["float32"], v.get("card_vs_cpu", {}).get("max_err")]
                 for a, v in decode_out.items()},
         families={a: [round(v["prefill_ms_median"], 3), round(v["decode_ms_median"], 3),
                       v["consistency"]["err"], v["card_vs_cpu"]["max_err"]]
                   for a, v in families_out.items()},
         audio=[round(audio_out["prefill_ms_median"], 3), round(audio_out["step_ms_median"], 3),
                audio_out["card_vs_cpu"]["max_err"]],
         train_families={a: [round(v["step_ms_median"], 3), v["losses"][0], v["losses"][-1],
                             v["card_vs_cpu"]["max_err"]["grads"]]
                         for a, v in train_families_out.items()},
         mla=[round(mla_train["step_ms_median"], 3), round(mla_train["peak_gb"], 2),
              {n: [r["ms"], r["bound_ms"]] for n, r in mla_rows.items()}],
         dkv={n: [r["ms"], r["bound_ms"], r["library_ms"]] for n, r in dkv_rows.items()},
         mesh={"flush_ms": {k: round(v, 3) for k, v in mesh_out["serve"]["flush_ms_median"].items()},
               "train_step_ms": round(mesh_out["train"]["step_ms_median"], 3),
               "train_peak_mb": round(mesh_out["train"]["peak_mb"]),
               "max_err": [mesh_out["serve"]["max_abs_err"],
                           mesh_out["train"]["max_abs_err"]["grads"],
                           mesh_out["moe"]["max_abs_err"]["grads"]],
               "decode_bitwise_equal": mesh_out["decode"]["bitwise_equal"]},
         mesh_split={n.split(":")[1]: [c["max_abs_err"], c["ms"]]
                     for n, c in split_out["cases"].items()},
         seconds=time.perf_counter() - t_start, phase_seconds=laps)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
