"""The port's examples (`examples/torch_*.py`) on the CPU, at a tiny size,
and two of them held against their `repro` twins on weights carried over
with `repro_torch.params.from_reference`:

- each example's `main(argv)` with `--device cpu` returns its numbers:
  quickstart 1 period x 2 iterations, rps_nash `--iters 2`, pommerman
  `--periods 1 --steps 2 --envs 2 --eval-episodes 1`, serve_policy 2 rows
  and 2 new tokens; without a card and without `--device cpu` each raises;
- rps_nash's `action_distribution` against `repro`'s, within 1e-5, at fp32
  and at the config's bf16 compute (within bf16's rounding there);
- serve_policy's prefill logits (fp32, within 1e-4; T = 32, below the
  reference's 64-token prefill cut) and greedy tokens (equal) against
  `repro`'s `prefill` and `decode_step`;
- loading rps_nash twice re-registers its game manager without raising.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.params import from_reference

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def load(name, alias=None):
    """An example file as a module (`examples/` is not a package)."""
    spec = importlib.util.spec_from_file_location(alias or f"example_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_runs_on_cpu():
    out = load("torch_quickstart").main(["--device", "cpu", "--periods", "1", "--iters", "2"])
    assert out["learner_steps"] == 2 and len(out["losses"]) == 2
    assert np.isfinite(out["losses"]).all() and np.isfinite(out["entropies"]).all()
    assert out["league"]["num_freezes"] == 1
    assert out["league"]["frozen_pool"] == ["main:0000"]
    assert out["throughput"]["rfps"] > 0 and out["throughput"]["cfps"] > 0


def test_rps_nash_runs_on_cpu():
    out = load("torch_rps_nash").main(["--device", "cpu", "--iters", "2"])
    for mode in ("independent", "fsp"):
        d = out[mode]["dists"]
        assert d.shape == (2, 3)
        np.testing.assert_allclose(d.sum(1), 1.0, atol=1e-5)
        assert 0 <= out[mode]["max_dev"] <= 2 / 3 and 1 / 3 <= out[mode]["avg_peak"] <= 1


def test_pommerman_league_runs_on_cpu():
    out = load("torch_pommerman_league").main(
        ["--device", "cpu", "--periods", "1", "--steps", "2", "--envs", "2",
         "--eval-episodes", "1"])
    assert len(out["curve"]) == 1 and 0.0 <= out["curve"][0] <= 1.0
    state = out["league_states"][0]
    assert state["num_freezes"] == 2                     # both roles froze once
    assert sorted(state["frozen_pool"]) == ["exploiter:0:0000", "main:0000"]


def test_serve_policy_runs_on_cpu():
    out = load("torch_serve_policy").main(["--device", "cpu", "--batch", "2",
                                           "--new-tokens", "2"])
    assert out["logits"].shape[:2] == (2, 32) and np.isfinite(out["logits"]).all()
    assert out["cache_length"] == 32 and out["tokens"].shape == (2, 3)
    assert out["requests_served"] == 32 and out["batches_run"] == 1
    assert out["decode_ms_per_token"] > 0


@pytest.mark.parametrize("name", ["torch_quickstart", "torch_rps_nash",
                                  "torch_pommerman_league", "torch_serve_policy"])
def test_example_raises_without_a_card(name, monkeypatch):
    mod = load(name)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main([])


@pytest.mark.parametrize("compute,atol", [("float32", 1e-5), ("bfloat16", 1e-2)])
def test_rps_nash_action_distribution_matches_repro(compute, atol):
    from repro.configs import get_arch as jax_arch
    from repro.envs import make_env as jax_env
    from repro.models import init_params as jax_init
    from repro_torch.configs import get_arch
    from repro_torch.envs import make_env

    twin = load("rps_nash", "example_rps_nash_twin")
    port = load("torch_rps_nash")
    jcfg = dataclasses.replace(jax_arch("tleague-policy-s"), compute_dtype=compute)
    tcfg = dataclasses.replace(get_arch("tleague-policy-s"), compute_dtype=compute)
    for seed in (0, 1):
        params = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(seed), jcfg))
        want = twin.action_distribution(jcfg, jax_env("rps", episode_len=4), params)
        got = port.action_distribution(tcfg, make_env("rps", device="cpu", episode_len=4),
                                       from_reference(params, "cpu"))
        np.testing.assert_allclose(got, want, atol=atol, rtol=0)
        assert abs(got.sum() - 1) < 1e-5


def test_serve_policy_prefill_and_greedy_tokens_match_repro():
    from repro.configs import get_arch as jax_arch
    from repro.models import decode_step as jax_decode
    from repro.models import init_params as jax_init
    from repro.models import prefill as jax_prefill
    from repro_torch.configs import get_arch

    B, T, new = 2, 32, 2
    jcfg = dataclasses.replace(jax_arch("gemma2-2b").smoke(), compute_dtype="float32")
    tcfg = dataclasses.replace(get_arch("gemma2-2b").smoke(), compute_dtype="float32")
    params = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(0), jcfg))
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)

    logits, _, state = jax.jit(lambda p, b: jax_prefill(p, jcfg, b))(
        params, {"tokens": jnp.asarray(toks)})
    step = jax.jit(lambda p, t, s: jax_decode(p, jcfg, t, s))
    tok = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)
    want = [tok]
    for _ in range(new):
        lg, _, state = step(params, tok, state)
        tok = jnp.argmax(lg[:, -1:], -1).astype(jnp.int32)[..., 0:1]
        want.append(tok)
    want = np.concatenate([np.asarray(t) for t in want], 1)

    port = load("torch_serve_policy")
    got_logits, length, got, _ = port.generate(tcfg, from_reference(params, "cpu"),
                                               torch.from_numpy(toks), new)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(logits), atol=1e-4, rtol=0)
    assert length == T
    np.testing.assert_array_equal(got, want)


def test_rps_nash_registers_twice_without_raising():
    from repro_torch.core import GAME_MGRS

    first = load("torch_rps_nash", "example_rps_nash_a")
    second = load("torch_rps_nash", "example_rps_nash_b")
    assert GAME_MGRS["independent"] is second.IndependentGameMgr
    assert first.IndependentGameMgr.name == second.IndependentGameMgr.name == "independent"
