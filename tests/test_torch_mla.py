"""Kimi-K2-Instruct's layers in the port against the benchmark's plain
reference (`perfbench/reference/mla.py`, plain PyTorch written from the
published architecture), on seeded random weights at a small size: d 256,
4 heads, lora ranks 64 and 32, rope 16, v 32, a dense layer then 4 MoE
layers each holding 4 of 16 experts (4 per token) and a shared expert; all
in fp32 on the CPU.

- latent attention's output and gradients;
- one whole learner step's loss, gradient norm and per-leaf gradients;
- the sigmoid router's choices and weights, the correction bias changing
  a choice and weighing none;
- the expert share: the partial sums of the 4 shares of a layer, the
  shared expert counted once, are the uncut layer's result;
- YaRN's frequencies and scale against the hand values (pairs up to 19
  keep their frequency, from 20 divided by 32; 192^-0.5 * 1.81326);
- the plain attention at q/k 192 and v 128 against a naive softmax;
- the shared expert's width, apart from the dense layers'.

Tolerances: fp32 forwards 2e-5 and gradients 1e-4 (relative to the
largest magnitude), the JAX reference's own (ROADMAP); the step's loss and
norm 1e-5 relative, as both sum the same fp32 terms in other orders.
"""
import dataclasses
import json
import math
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import weights_mla as WM  # noqa: E402
from perfbench.reference import mla as RM  # noqa: E402
from repro_torch.configs import MLAConfig, YarnScaling, get_arch  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_bwd_ref,
    attention_fwd_ref,
)
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402

SEED = 2 ** 33 + 7
SIZES = dict(d_model=256, hidden_size=256, num_attention_heads=4, q_lora_rank=64,
             kv_lora_rank=32, qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32,
             intermediate_size=384, moe_intermediate_size=64, vocab_size=128,
             value_head_hidden=32, num_layers=5, n_routed_experts=4,
             num_experts_per_tok=4, param_dtype="float32", compute_dtype="float32")


def small(held=4, router=16, capacity_factor=1.25):
    """(the benchmark's file, the port's ArchConfig) at the tests' size."""
    cfg = json.loads((ROOT / "perfbench/configs/kimi-k2-instruct.l6.json").read_text())
    cfg = dict(cfg, **dict(SIZES, n_routed_experts=held),
               published=dict(cfg["published"], n_routed_experts=router))
    cfg["moe"] = dict(cfg["moe"], num_experts=held, experts_per_token=4, d_ff_expert=64,
                      capacity_factor=capacity_factor)
    base = get_arch("kimi-k2-instruct")
    arch = dataclasses.replace(
        base, num_layers=5, d_model=256, num_heads=4, num_kv_heads=4, head_dim=48, d_ff=384,
        d_ff_shared=64, vocab_size=128, value_head_hidden=32, param_dtype="float32",
        compute_dtype="float32",
        mla=MLAConfig(q_lora_rank=64, kv_lora_rank=32, qk_nope_head_dim=32,
                      qk_rope_head_dim=16, v_head_dim=32),
        moe=dataclasses.replace(base.moe, num_experts=held, experts_per_token=4,
                                d_ff_expert=64, capacity_factor=capacity_factor),
        router=dataclasses.replace(base.router, experts=router))
    return cfg, arch


def _close(got, want, tol):
    scale = max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= tol * scale


def _slices(cfg, seed=SEED):
    return {k: WM.draw(lf, seed, r, "cpu", torch.float32) for k, lf, r in WM.slices(cfg)}


def _layer(P, pre, r):
    return {k[len(pre):-len(f"[{r}]")]: t for k, t in P.items()
            if k.startswith(pre) and k.endswith(f"[{r}]")}


def _nest(flat):
    tree = {}
    for k, t in flat.items():
        node = tree
        parts = k.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t
    return tree


def test_mla_block_matches_the_reference():
    cfg, arch = small()
    P = _slices(cfg)
    flat = {k: t.clone().requires_grad_(True)
            for k, t in _layer(P, "blocks.sub0.", 1).items() if k.startswith("attn.")}
    x = torch.randn(2, 40, 256, generator=torch.Generator().manual_seed(1), requires_grad=True)
    pos = torch.arange(40).expand(2, 40)
    y = A.mla_attention(_nest(flat)["attn"], arch, x, pos)
    want = RM.mla(flat, cfg, x)
    _close(y, want, 2e-5)
    g = torch.randn_like(y)
    got = torch.autograd.grad(y, [x] + list(flat.values()), g)
    ref = torch.autograd.grad(want, [x] + list(flat.values()), g)
    for a, b in zip(got, ref):
        _close(a, b, 1e-4)


def test_a_learner_step_matches_the_reference():
    from repro_torch import learners, optim
    from repro_torch.rl.vtrace_loss import VTraceConfig

    cfg, arch = small()
    WM.check_layout(cfg, arch, init_params)
    tensors = WM.make(cfg, SEED, "cpu")
    B, T = 2, 48
    g = torch.Generator().manual_seed(3)
    batch = {"tokens": torch.randint(0, 128, (B, T), generator=g),
             "actions": torch.randint(0, 128, (B, T), generator=g),
             "rewards": torch.randn(B, T, generator=g),
             "discounts": 0.99 * (torch.rand(B, T, generator=g) > 0.05).float(),
             "bootstrap_value": torch.randn(B, generator=g)}
    RM.behave(cfg, tensors, batch)
    hp = dict(value_coef=0.5, entropy_coef=0.01, gamma=0.99, lam=1.0, clip_rho=1.0, clip_c=1.0)
    step = learners.build_seq_train_step(arch, optim.adamw(1e-3), hp=VTraceConfig(**hp),
                                         loss="vtrace", remat=True)
    loss, _, grads = step.value_and_grad(WM.program_tree(cfg, tensors), batch)
    rloss, rgrads = RM.loss_and_grads(_slices(cfg), cfg, hp, batch)
    assert abs(loss.item() - rloss.item()) <= 1e-5 * max(1.0, abs(rloss.item()))
    norm = math.sqrt(sum(float(t.double().square().sum()) for t in rgrads.values()))
    got = 0.0
    for key, lf, r in WM.slices(cfg):
        t = grads
        for p in lf.path:
            t = t[p]
        t = t[r] if lf.stacked else t
        got += float(t.double().square().sum())
        _close(t, rgrads[key], 1e-4)
    assert abs(math.sqrt(got) - norm) <= 1e-5 * norm


def test_the_sigmoid_router_picks_by_bias_and_weighs_by_score():
    s = torch.tensor([[0.90, 0.80, 0.70, 0.60, 0.10]])
    bias = torch.tensor([0.0, 0.0, -0.25, 0.0, 0.0])
    w, e = MOE.sigmoid_choices(s, torch.zeros(5), 2, 2.827)
    assert e.tolist() == [[0, 1]]
    w, e = MOE.sigmoid_choices(s, bias, 3, 2.827)
    assert sorted(e[0].tolist()) == [0, 1, 3]             # the bias moved expert 2 out
    want = torch.tensor([0.9, 0.8, 0.6]) / 2.3 * 2.827    # the scores, not s + b
    torch.testing.assert_close(w[0][torch.argsort(e[0])], want)
    cfg, _ = small()
    p = {"moe.router.w": torch.randn(256, 16, generator=torch.Generator().manual_seed(4)),
         "moe.router.bias": torch.randn(16, generator=torch.Generator().manual_seed(5)) * 0.1}
    x = torch.randn(64, 256, generator=torch.Generator().manual_seed(6))
    rs, rw, ri = RM.route(p, dict(cfg, num_experts_per_tok=4), x)
    w, e = MOE.sigmoid_choices(torch.sigmoid(x @ p["moe.router.w"]), p["moe.router.bias"], 4,
                               cfg["routed_scaling_factor"])
    assert torch.equal(e, ri)
    torch.testing.assert_close(w, rw)
    assert not torch.equal(torch.topk(rs, 4).indices, ri)   # the bias changes some choice


def _moe_params(P, r, lo, n, R):
    """Layer r's MoE as the port holds the share of experts [lo, lo + n):
    the router's columns (and bias) rolled so that they come first."""
    lay = _layer(P, "blocks.sub0.", r)
    flat = {k[len("moe."):]: t for k, t in lay.items() if k.startswith("moe.")}
    roll = torch.roll(torch.arange(R), -lo)
    flat["router.w"], flat["router.bias"] = flat["router.w"][:, roll], flat["router.bias"][roll]
    for k in ("up", "gate", "down"):
        flat[k] = flat[k][lo:lo + n]
    return _nest(flat)


@pytest.mark.parametrize("capacity_factor", [1.25, 8.0])
def test_the_expert_shares_add_up_to_the_uncut_layer(capacity_factor):
    cfg, arch = small(held=16, capacity_factor=capacity_factor)
    P = _slices(cfg)
    x = torch.randn(2, 24, 256, generator=torch.Generator().manual_seed(7))
    want, _ = RM.moe({k[len("blocks.sub0."):-3]: t for k, t in P.items()
                      if k.startswith("blocks.sub0.moe.") and k.endswith("[0]")}, cfg, x)
    share_cfg = dataclasses.replace(arch, moe=dataclasses.replace(arch.moe, num_experts=4))
    parts = [MOE.moe_apply(_moe_params(P, 0, 4 * m, 4, 16), share_cfg, x)[0] for m in range(4)]
    shared = L.mlp(_moe_params(P, 0, 0, 4, 16)["shared"], x)
    _close(sum(parts) - 3 * shared, want, 2e-5)
    uncut, _ = MOE.moe_apply(_moe_params(P, 0, 0, 16, 16), arch, x)
    _close(uncut, want, 2e-5)


def test_yarn_frequencies_and_scale_are_the_hand_values():
    kimi = get_arch("kimi-k2-instruct")
    inv = L.yarn_freqs(64, 50000.0, kimi.rope_scaling)
    plain = 1.0 / 50000.0 ** (torch.arange(0, 64, 2, dtype=torch.float32) / 64)
    torch.testing.assert_close(inv[:20], plain[:20], rtol=0, atol=0)
    torch.testing.assert_close(inv[20:], plain[20:] / 32, rtol=1e-6, atol=0)
    assert abs(A.mla_scale(kimi) / 192 ** -0.5 - 1.81326) < 1e-5
    assert A.mla_rope(kimi, "cpu")[1] == 1.0
    cfg = json.loads((ROOT / "perfbench/configs/kimi-k2-instruct.l6.json").read_text())
    torch.testing.assert_close(RM.inv_freq(cfg), inv, rtol=0, atol=0)
    assert RM.softmax_scale(cfg) == pytest.approx(A.mla_scale(kimi), rel=1e-12)
    # the correction range of beta_fast = beta_slow = 1 over 64 dims and base 50000
    dim = 64 * math.log(4096 / (2 * math.pi)) / (2 * math.log(50000))
    assert (math.floor(dim), math.ceil(dim)) == (19, 20)
    s = YarnScaling(factor=32.0, original_max_position=4096)      # DeepSeek-V3's betas
    assert L.yarn_freqs(64, 50000.0, s)[0] == plain[0]


@pytest.mark.parametrize("causal", [True, False])
def test_plain_attention_at_192_and_128_is_a_softmax(causal):
    g = torch.Generator().manual_seed(8)
    q, k = torch.randn(2, 3, 37, 192, generator=g), torch.randn(2, 3, 37, 192, generator=g)
    v, do = torch.randn(2, 3, 37, 128, generator=g), torch.randn(2, 3, 37, 128, generator=g)
    scale = 192 ** -0.5 * 1.81326
    qd, kd, vd = (t.double().requires_grad_(True) for t in (q, k, v))
    s = qd @ kd.transpose(-1, -2) * scale
    if causal:
        s = s.masked_fill(torch.ones(37, 37, dtype=torch.bool).triu(1), float("-inf"))
    naive = torch.softmax(s, -1) @ vd
    o, lse = attention_fwd_ref(q, k, v, scale=scale, causal=causal)
    assert o.shape == (2, 3, 37, 128)
    _close(o.double(), naive.detach(), 2e-5)
    _, dq, dk, dv = attention_bwd_ref(q, k, v, o, lse, do, scale=scale, causal=causal)
    for got, want in zip((dq, dk, dv), torch.autograd.grad(naive, (qd, kd, vd), do.double())):
        _close(got.double(), want, 1e-4)


def test_the_shared_expert_has_its_own_width():
    kimi = get_arch("kimi-k2-instruct")
    assert (kimi.d_ff, kimi.shared_ff) == (18432, 2048)
    p = init_params(torch.Generator().manual_seed(0), kimi.smoke())
    assert p["dense_prefix"]["sub0"]["mlp"]["up"]["w"].shape[-1] == kimi.smoke().d_ff == 512
    assert p["blocks"]["sub0"]["moe"]["shared"]["up"]["w"].shape[-1] == 128
    stand_in = get_arch("kimi-k2-1t-a32b").smoke()      # the JAX package's rule, held
    q = init_params(torch.Generator().manual_seed(0), stand_in)
    assert q["blocks"]["sub0"]["moe"]["shared"]["up"]["w"].shape[-1] == stand_in.d_ff


def test_the_runner_refuses_group_limited_routing_and_other_sizes():
    from perfbench.cells import learn_mla as C
    from perfbench.harness import Refused
    cfg, arch = small()
    C.check_arch(cfg, arch)
    for bad in (dict(n_group=8, topk_group=4), dict(v_head_dim=64), dict(q_lora_rank=32)):
        with pytest.raises(Refused):
            C.check_arch(dict(cfg, **bad), arch)


@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_runs_at_a_tiny_size_on_the_cpu(trace):
    """`learn.kimi-k2-l6.b1-t8192`'s runner end to end at the tiny size of
    `weights_mla.check_layout`, fp32: the port's first steps against the
    reference well inside the cell's limits, and traced, the readers of the
    program's phases and the step's FLOPs read something (the attention
    rooflines, the device's idle share and the update's CUDA events read
    device time, which the CPU has none of)."""
    import time

    from perfbench import harness as H
    from perfbench.cells import learn_mla as C
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = H.find_cell(manifest, "learn.kimi-k2-l6.b1-t8192", 2 ** 31 + 99, 0.2, trace)
    t, arch = WM.tiny(cell.cfg, H.program_config(cell.cfg))
    t = dict(t, param_dtype="float32", compute_dtype="float32", hidden_size=64)
    arch = dataclasses.replace(arch, param_dtype="float32", compute_dtype="float32")
    cell = dataclasses.replace(cell, cfg=t, device=torch.device("cpu"), arch=arch,
                               traffic=dict(cell.traffic, batch=2, unroll=40, pool=4),
                               t_start=time.perf_counter())
    out = C.run(cell)
    assert out.attempted > 0 and out.failed == 0
    assert all(out.checks[k] <= lim / 100 for k, lim in cell.limits.items())
    if not trace:
        assert out.metrics["learn_frames_per_s"] > 0
        return
    got = {m["name"]: H.read_metric(m["name"], out.summary) for m in manifest["per_layer"]
           if cell.name in m.get("workloads", [])}
    for name in ("mla_attn_fwd_roofline.learn_mla", "mla_attn_bwd_roofline.learn_mla",
                 "device_idle.learn_mla", "optim_update_ms.learn_mla"):
        assert got.pop(name) is None, name
    assert set(got) == {"mfu.learn_mla", "mla_project_ms.learn_mla", "moe_route_ms.learn_mla",
                        "learn_fwd_ms.learn_mla", "learn_bwd_ms.learn_mla",
                        "grad_norm_ms.learn_mla", "adamw_ms.learn_mla"}
    assert all(v > 0 for v in got.values()), got


@pytest.mark.parametrize("name", ["mfu.learn_mla", "mla_attn_fwd_roofline.learn_mla",
                                  "mla_attn_bwd_roofline.learn_mla", "mla_project_ms.learn_mla",
                                  "moe_route_ms.learn_mla", "learn_fwd_ms.learn_mla",
                                  "learn_bwd_ms.learn_mla", "grad_norm_ms.learn_mla",
                                  "adamw_ms.learn_mla", "optim_update_ms.learn_mla",
                                  "device_idle.learn_mla"])
def test_a_new_reader_with_nothing_to_read_returns_nothing(name):
    from perfbench import harness as H
    for s in ({"kind": "learn", "units": 3, "window_s": 1.0, "busy_s": 1.0,
               "spans": {"attention": {"device_s": 1.0, "bwd_device_s": 1.0}},
               "model_flops_per_unit": 1, "attention_fwd_bound_s": 0.1,
               "attention_bwd_bound_s": 0.1}, None, {}):
        assert H.read_metric(name, s) is None
