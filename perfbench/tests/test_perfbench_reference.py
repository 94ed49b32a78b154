"""The plain reference against hand-written small cases."""
import math

import numpy as np
import pytest
import torch

from perfbench.reference import learn as RL
from perfbench.reference import model as M


def test_rmsnorm_by_hand():
    x = torch.tensor([[3.0, 4.0]])
    y = M.rmsnorm(x, torch.tensor([1.0, 2.0]), eps=0.0)
    r = math.sqrt((9 + 16) / 2)
    assert torch.allclose(y, torch.tensor([[3 / r, 8 / r]]))


def test_rope_rotates_each_pair_by_its_angle():
    x = torch.tensor([1.0, 0.0, 0.0, 1.0]).reshape(1, 1, 1, 4).repeat(1, 3, 1, 1)
    y = M.rope(x, theta=100.0)
    # pairs (x0, x2) and (x1, x3); frequencies 1 and 1/10
    for t in range(3):
        a0, a1 = t * 1.0, t / 10.0
        want = [math.cos(a0), -math.sin(a1), math.sin(a0), math.cos(a1)]
        assert torch.allclose(y[0, t, 0], torch.tensor(want), atol=1e-6)


def test_causal_attention_by_hand():
    cfg = {"num_heads": 1, "num_kv_heads": 1, "head_dim": 2, "rope_theta": 1e4}
    eye = torch.eye(2)
    p = {"attn.wq.w": eye, "attn.wk.w": eye, "attn.wv.w": eye, "attn.wo.w": eye}
    x = torch.tensor([[[1.0, 0.0], [0.0, 1.0]]])
    y = M.attention(p, cfg, x)
    # row 0 sees itself only; row 1 mixes both keys by softmax of q.k / sqrt(2)
    assert torch.allclose(y[0, 0], torch.tensor([1.0, 0.0]), atol=1e-6)
    k0 = M.rope(x.reshape(1, 2, 1, 2), 1e4)[0, :, 0]
    s = (k0[1] @ k0.t()) / math.sqrt(2)
    w = torch.softmax(s, -1)
    assert torch.allclose(y[0, 1], w @ x[0], atol=1e-6)


def test_attention_blocks_do_not_change_the_result(monkeypatch):
    g = torch.Generator().manual_seed(0)
    cfg = {"num_heads": 4, "num_kv_heads": 2, "head_dim": 8, "rope_theta": 1e4}
    p = {"attn.wq.w": torch.randn(16, 32, generator=g),
         "attn.wk.w": torch.randn(16, 16, generator=g),
         "attn.wv.w": torch.randn(16, 16, generator=g),
         "attn.wo.w": torch.randn(32, 16, generator=g)}
    x = torch.randn(2, 9, 16, generator=g)
    whole = M.attention(p, cfg, x)
    monkeypatch.setattr(M, "SCORE_ELEMS", 2 * 4 * 9 * 2)        # blocks of 2 rows
    assert torch.allclose(M.attention(p, cfg, x), whole, atol=1e-5)


def test_moe_capacity_keeps_first_choices_rank_major():
    d = 2
    cfg = {"moe": {"num_experts": 2, "experts_per_token": 1, "capacity_factor": 0.5}}
    # every token picks expert 0; capacity max(int(4 * 1 * 0.5 / 2), 1) = 1
    p = {"moe.router.w": torch.tensor([[10.0, 0.0], [10.0, 0.0]]),
         "moe.up": torch.ones(2, d, 1), "moe.gate": torch.ones(2, d, 1),
         "moe.down": torch.ones(2, 1, d)}
    x = torch.tensor([[[1.0, 1.0], [2.0, 2.0], [3.0, 3.0], [4.0, 4.0]]])
    y = M.moe(p, cfg, x)[0]
    h = 2.0                                   # silu(2) * 2 for token 0
    want0 = torch.nn.functional.silu(torch.tensor(h)) * h
    assert torch.allclose(y[0], want0.repeat(2))
    assert torch.equal(y[1:], torch.zeros(3, 2))        # past capacity: dropped


def test_moe_second_choices_come_after_every_first_choice():
    cfg = {"moe": {"num_experts": 2, "experts_per_token": 2, "capacity_factor": 0.5}}
    # capacity max(int(2 * 2 * 0.5 / 2), 2) = 2: both first choices (expert 0
    # for both tokens) fill expert 0; the second choices go to expert 1
    p = {"moe.router.w": torch.tensor([[3.0, 0.0], [0.0, 0.0]]),
         "moe.up": torch.stack([torch.eye(2), 2 * torch.eye(2)]),
         "moe.gate": torch.stack([torch.eye(2), torch.eye(2)]) * 50,
         "moe.down": torch.stack([torch.eye(2), torch.eye(2)])}
    x = torch.tensor([[[1.0, 0.0], [1.0, 0.0]]])
    y = M.moe(p, cfg, x)[0]
    gates = torch.softmax(torch.tensor([3.0, 0.0]), -1)
    a = torch.nn.functional.silu(torch.tensor(50.0))
    want = gates[0] * a * 1.0 + gates[1] * a * 2.0
    assert torch.allclose(y[:, 0], want.repeat(2), rtol=1e-5)


def test_vtrace_by_hand():
    b_logp = torch.tensor([[0.0, 0.0]])
    t_logp = torch.tensor([[math.log(0.5), math.log(2.0)]])      # rho 0.5, 2 (clipped to 1)
    r = torch.tensor([[1.0, 2.0]])
    v = torch.tensor([[0.5, 1.0]])
    disc = torch.tensor([[0.9, 0.9]])
    boot = torch.tensor([3.0])
    vs, adv = RL.vtrace(b_logp, t_logp, r, v, disc, boot)
    d1 = 1.0 * (2.0 + 0.9 * 3.0 - 1.0)
    d0 = 0.5 * (1.0 + 0.9 * 1.0 - 0.5)
    vs1 = 1.0 + d1
    vs0 = 0.5 + d0 + 0.9 * 0.5 * (vs1 - 1.0)
    assert torch.allclose(vs, torch.tensor([[vs0, vs1]]))
    assert torch.allclose(adv, torch.tensor([[0.5 * (1.0 + 0.9 * vs1 - 0.5),
                                              1.0 * (2.0 + 0.9 * 3.0 - 1.0)]]))


def test_adamw_first_step_moves_each_weight_by_lr_times_its_sign():
    cfg = {"num_layers": 1, "d_model": 4, "num_heads": 1, "num_kv_heads": 1, "head_dim": 4,
           "d_ff": 4, "vocab_size": 8, "param_dtype": "float32", "value_head_hidden": 4,
           "rope_theta": 1e4}
    opt = {"lr": 1.0, "warmup_steps": 1, "b1": 0.9, "b2": 0.999, "eps": 1e-20, "clip_norm": 1e9}
    hp = {"value_coef": 0.5, "entropy_coef": 0.01, "lam": 1.0, "clip_rho": 1.0, "clip_c": 1.0}
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, 8, (1, 5), generator=g),
             "actions": torch.randint(0, 8, (1, 5), generator=g),
             "behavior_logp": torch.full((1, 5), -2.0), "rewards": torch.randn(1, 5, generator=g),
             "discounts": torch.full((1, 5), 0.9), "bootstrap_value": torch.zeros(1)}
    out = RL.readings(cfg, opt, hp, seed=3, batches=[batch], device="cpu")
    for k, n in out["change"].items():
        # every element moves by exactly lr where its gradient is not 0
        numel = {"embed.table": 32, "lm_head.w": 32}.get(k)
        if numel:
            assert n <= math.sqrt(numel) + 1e-5
    assert np.isfinite(out["loss"][0]) and out["grad_norm"][0] > 0
    assert out["change"]["value_head.out.b"] == pytest.approx(1.0, abs=1e-5)


def test_compare_by_hand():
    ref = {"loss": [2.0], "grad_norm": [4.0], "grad1": {"a": 1.0, "b": 3.0, "c": 1e-9},
           "grad1_raw": {"a": 1.0, "b": 3.0, "c": 1e-9}, "change": {"a": 2.0, "b": 2.0, "c": 0.5}}
    port = {"loss": [2.5], "grad_norm": [5.0], "grad1": {"a": 1.5, "b": 3.0, "c": 0.0},
            "change": {"a": 2.0, "b": 1.0, "c": 99.0}}
    got = RL.compare(port, ref)
    assert got["loss"] == pytest.approx(0.25)
    assert got["grad_norm"] == pytest.approx(0.25)
    assert got["grad1"] == pytest.approx(0.5)           # leaf a, over the median leaf's 1.0
    assert got["change"] == pytest.approx(0.5)          # leaf c left out: no gradient
