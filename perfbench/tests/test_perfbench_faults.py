"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a chip and drives the rest of a
run on the CPU at a tiny width in fp32, where a sound run reads far under
the cell's committed limits, and breaks the port the way a cell of its
kind can break: a train step that leaves its state unchanged, half of each
batch left out, window steps whose loss is not finite, the served actions
altered where they are produced (each flush's actions off by one), and one
slot of each actor answered from another slot's observation. (One chip has
no exchange between chips to leave out.)"""
import itertools

import pytest

from conftest import tiny_cell
from perfbench import control
from perfbench import harness as H

LEARN = ["learn.mistral-large-l2.b4-t2048", "learn.mistral-large-l2.b1-t8192"]
SERVE = "serve.qwen3-moe-l8.a32x8-o26"


def _verdict(cell):
    ok, rows = H.verdict(cell, H.run_cell(cell))
    return ok, {k: v for k, v, _ in rows}


@pytest.mark.parametrize("workload", LEARN + [SERVE])
def test_a_sound_run_is_correct(manifest, workload):
    ok, got = _verdict(tiny_cell(manifest, workload))
    assert ok, got


@pytest.mark.parametrize("workload", LEARN)
def test_a_step_that_leaves_its_state_unchanged_is_caught(manifest, workload, monkeypatch):
    from repro_torch import optim
    from repro_torch.utils import tree_global_norm
    real = optim.adamw

    def frozen(*a, **kw):
        opt = real(*a, **kw)

        def update(grads, state, params):
            return params, state, {"grad_norm": tree_global_norm(grads)}
        return optim.Optimizer(opt.init, update)
    monkeypatch.setattr(optim, "adamw", frozen)
    ok, got = _verdict(tiny_cell(manifest, workload))
    assert not ok and got["change"] == pytest.approx(1.0)


@pytest.mark.parametrize("workload", LEARN)
def test_half_of_each_batch_left_out_is_caught(manifest, workload, monkeypatch):
    from repro_torch import learners
    real = learners.build_seq_train_step

    def halved(*a, **kw):
        step = real(*a, **kw)

        def train_step(params, state, batch):
            B, T = batch["tokens"].shape
            cut = ({k: v[:B // 2] for k, v in batch.items()} if B > 1 else
                   {k: (v[:, :T // 2] if v.dim() == 2 else v) for k, v in batch.items()})
            return step(params, state, cut)
        return train_step
    monkeypatch.setattr(learners, "build_seq_train_step", halved)
    ok, got = _verdict(tiny_cell(manifest, workload))
    assert not ok, got


@pytest.mark.parametrize("workload", LEARN)
def test_window_steps_that_are_not_finite_fail_and_add_no_frames(manifest, workload,
                                                                 monkeypatch):
    from repro_torch import learners
    real = learners.build_seq_train_step
    cell = tiny_cell(manifest, workload)

    def late_nan(*a, **kw):
        step, calls = real(*a, **kw), itertools.count()

        def train_step(params, state, batch):
            params, state, m = step(params, state, batch)
            if next(calls) >= cell.traffic["check_steps"]:   # past the compared steps
                m = dict(m, loss=m["loss"] * float("nan"))
            return params, state, m
        return train_step
    monkeypatch.setattr(learners, "build_seq_train_step", late_nan)
    out = H.run_cell(cell)
    ok, rows = H.verdict(cell, out)
    assert all(v <= lim for _, v, lim in rows), rows     # the compared steps are sound
    assert out.failed == out.attempted > 0 and not ok
    assert out.metrics["learn_frames_per_s"] == 0


@pytest.mark.parametrize("fault", ["altered_actions", "stale_slot"])
def test_served_faults_are_caught(manifest, monkeypatch, fault):
    from repro_torch.infserver import server as S
    cell = tiny_cell(manifest, SERVE)
    planted = (control.altered_actions(cell.traffic["num_actions"]) if fault == "altered_actions"
               else control.stale_rows(cell.traffic["slots"]))
    real = S.InfServer._forward
    monkeypatch.setattr(S.InfServer, "_forward",
                        lambda self, *a, **kw: planted(real, self, *a, **kw))
    ok, got = _verdict(cell)
    assert not ok, got


@pytest.mark.parametrize("workload", LEARN + [SERVE])
def test_a_traced_run_reads_its_per_layer_metrics(manifest, workload):
    cell = tiny_cell(manifest, workload, trace=True)
    out = H.run_cell(cell)
    s = out.summary
    assert s["units"] > 0 and s["window_s"] > 0
    assert s["spans"]["attention"]["calls"] > 0
    if cell.traffic["kind"] == "learn":
        assert s["spans"]["attention"]["bwd_ids"], "no attention backward found by sequence number"
        assert H.read_metric("mfu.learn", s) > 0
    else:
        assert s["spans"]["moe"]["calls"] > 0 and H.read_metric("mfu.serve", s) > 0
