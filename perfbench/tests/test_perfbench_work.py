"""`work.py`'s counts against hand counts at toy shapes."""
import pytest

from perfbench import work

DENSE = {"num_layers": 2, "d_model": 4, "num_heads": 2, "num_kv_heads": 1, "head_dim": 2,
         "d_ff": 8, "vocab_size": 10, "value_head_hidden": 3}
MOE = dict(DENSE, moe={"num_experts": 4, "experts_per_token": 2, "d_ff_expert": 5})


def test_live_pairs():
    assert work.live_pairs(3, 3) == 6                     # 1 + 2 + 3
    assert work.live_pairs(3, 3, causal=False) == 9
    assert work.live_pairs(4, 4, window=2) == 7           # 1 + 2 + 2 + 2


def test_learn_step_flops_by_hand():
    # per layer: wq 4x4, wk 4x2, wv 4x2, wo 4x4 = 48; MLP 3 * 4 * 8 = 96
    n = 2 * (48 + 96) + 4 * 10 + 4 * 3 + 3
    pairs = 3 * 4 // 2                                    # T = 3: 6 live pairs a row
    attn = 2 * 2 * 2 * 5 * pairs                          # L * H * hd * B * pairs
    assert work.learn_step_flops(DENSE, B=5, T=3) == 6 * n * 15 + 12 * attn


def test_serve_flush_flops_counts_active_experts_and_the_action_columns():
    # per layer: attention 48, router 4 * 4, k = 2 experts of 3 * 4 * 5
    per_layer = 48 + 16 + 2 * 60
    rows, T, A = 3, 2, 6
    blocks = 2 * 2 * per_layer * rows * T
    attn = 4 * 2 * 2 * 2 * rows * 3                       # 3 live pairs a row at T = 2
    head = 2 * rows * (4 * A + 4 * 3 + 3)
    assert work.serve_flush_flops(MOE, rows, T, A) == blocks + attn + head


def test_attention_work_by_hand():
    q, k = (2, 4, 8, 16), (2, 2, 8, 16)                   # B, H or KV, T, d
    live = 8 * 36                                         # B * H * T(T+1)/2
    fw = work.attention_fwd(q, k, 2)
    assert fw.flops == 4 * 16 * live
    assert fw.bytes == (2 * 2 * 4 * 8 * 16 + 2 * 2 * 2 * 8 * 16) * 2 + 8 * 8 * 4
    bw = work.attention_bwd(q, k, 2)
    # S, dP, dV, dK, dQ once each (5 matmuls of 2 * d a pair), delta 2 * d a row
    assert bw.flops == 10 * 16 * live + 2 * 16 * 8 * 8
    # read q, o, dO and k, v; write dq, dk, dv; read the log-sum-exp
    assert bw.bytes == (4 * 8 * 8 * 16 + 4 * 2 * 2 * 8 * 16) * 2 + 8 * 8 * 4


def test_bound_is_the_larger_of_compute_and_bytes():
    w = work.Work(flops=int(work.PEAK_FLOPS), bytes=int(work.PEAK_BYTES) // 2)
    assert w.seconds() == pytest.approx(1.0)
    w = work.Work(flops=0, bytes=int(work.PEAK_BYTES) * 3)
    assert w.seconds() == pytest.approx(3.0)


def test_rmsnorm_work():
    assert work.rmsnorm(numel=12, d=4, esz=2) == (48, 2 * 12 * 2 + 16)
