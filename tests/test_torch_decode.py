"""The port's decode path (`prefill`, `decode_step`, `init_decode_state`)
against the JAX package's, on the CPU.

The same params (made by `repro.models.init_params`, carried over with
`repro_torch.params.from_reference`) and the same tokens (from a numpy
seed) go through both packages; `repro` runs in its default CPU tier, as
its own `tests/test_smoke_archs.py` runs it. `decode_step` starts from
`repro`'s own prefill or `init_decode_state` state, converted with
`from_reference`, so each entry point is held on its own.

Tolerances: 1e-4 abs on logits and values and 1e-5 on the caches' k and v
at fp32 compute; at bf16 compute, where the two frameworks round to bf16
at different places, 2e-2 of max(1, max |reference|): one bf16 ulp of a
logit near 32 is 0.25 (gemma2's tied head gives logits of 20-50 before
its softcap). Positions and lengths exactly.

`repro`'s prefill keeps only the last `reserve` (64) prompt keys when it
does not slide (`repro/models/transformer.py:386`), so it is held here at
T <= 64, where it is right; `test_reference_prefill_truncates_long_prompts`
shows the fault and that the port's decode matches its own forward there.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.models import decode_step as jax_decode_step
from repro.models import forward_train as jax_forward
from repro.models import init_decode_state as jax_init_decode_state
from repro.models import init_params as jax_init
from repro.models import prefill as jax_prefill
from repro_torch.configs import get_arch
from repro_torch.models import (decode_step, forward_train, init_decode_state, init_params,
                                prefill)
from repro_torch.params import from_reference, to_reference

DENSE = ["qwen3-8b", "gemma2-2b", "mistral-large-123b", "command-r-35b"]
CASES = [(a, "float32") for a in DENSE] + [("gemma2-2b", "bfloat16"), ("qwen3-8b", "bfloat16")]
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
CACHE_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
B, T = 2, 16


@pytest.fixture(scope="module")
def ref():
    """`repro`'s entry points, one jitted closure each (configs and the
    decode options static)."""
    return {"prefill": jax.jit(jax_prefill, static_argnames=("cfg", "sliding")),
            "decode": jax.jit(jax_decode_step, static_argnames=("cfg", "window", "uniform")),
            "forward": jax.jit(jax_forward, static_argnames=("cfg",))}


def _cfgs(arch, compute="float32"):
    return (dataclasses.replace(jax_arch(arch).smoke(), compute_dtype=compute),
            dataclasses.replace(get_arch(arch).smoke(), compute_dtype=compute))


@functools.lru_cache(maxsize=None)
def _params(arch):
    cfg = jax_arch(arch).smoke()
    return jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(0), cfg))


def _tokens(cfg, n, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, n)).astype(np.int32)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32) if a.dtype == jnp.bfloat16
                        else np.asarray(a), tree)


def _close(got, want, compute, tol=TOL):
    """Within tol[compute]: absolute at fp32, of max(1, max |want|) at bf16."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    atol = tol[compute]
    if compute == "bfloat16":
        atol *= max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def _state_close(got, want, compute):
    """A port state (tensors) against a `repro` state (numpy): same keys
    and shapes, k and v within CACHE_TOL, positions and lengths exact."""
    got, want = to_reference(got), _np(want)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree.leaves(got)):
        name = jax.tree_util.keystr(path)
        assert g.shape == w.shape, name
        if name.endswith("['pos']") or name.endswith("['length']"):
            assert g.dtype == np.int32, name
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            _close(g, w, compute, CACHE_TOL)


@pytest.mark.parametrize("arch,compute", CASES)
def test_prefill_matches_repro(ref, arch, compute):
    jcfg, tcfg = _cfgs(arch, compute)
    params, toks = _params(arch), _tokens(jcfg, T)
    jl, jv, jst = ref["prefill"](params, jcfg, {"tokens": jnp.asarray(toks)})
    tl, tv, tst = prefill(from_reference(params, "cpu"), tcfg,
                          {"tokens": torch.from_numpy(toks).long()})
    assert tl.shape == (B, T, tcfg.vocab_size) and tl.dtype == torch.float32
    _close(tl, jl, compute)
    _close(tv, jv, compute)
    _state_close(tst, jst, compute)


@pytest.mark.parametrize("uniform", [True, False])
@pytest.mark.parametrize("arch,compute", CASES)
def test_decode_step_matches_repro(ref, arch, compute, uniform):
    """Three steps from `repro`'s prefill state, carried over with
    `from_reference`; the port's state is consumed each step."""
    jcfg, tcfg = _cfgs(arch, compute)
    params = _params(arch)
    tparams = from_reference(params, "cpu")
    toks = _tokens(jcfg, T + 3, seed=1)
    _, _, jst = ref["prefill"](params, jcfg, {"tokens": jnp.asarray(toks[:, :T])})
    tst = from_reference(jax.tree.map(np.asarray, jst), "cpu")
    for i in range(T, T + 3):
        tok = toks[:, i:i + 1]
        jl, jv, jst = ref["decode"](params, jcfg, jnp.asarray(tok), jst, uniform=uniform)
        tl, tv, tst = decode_step(tparams, tcfg, torch.from_numpy(tok).long(), tst,
                                  uniform=uniform)
        assert tl.shape == (B, 1, tcfg.vocab_size) and tv.shape == (B, 1)
        _close(tl, jl, compute)
        _close(tv, jv, compute)
    _state_close(tst, jst, compute)


@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen3-8b"])
def test_sliding_ring_past_its_wrap(ref, arch):
    """`long_context_window` 128, a 120-token prompt, 16 steps at window
    128: the ring wraps at the first step and overwrites its oldest keys."""
    jcfg, tcfg = _cfgs(arch)
    W, n, steps = jcfg.long_context_window, 120, 16
    params = _params(arch)
    tparams = from_reference(params, "cpu")
    toks = _tokens(jcfg, n + steps, seed=2)
    _, _, jst = ref["prefill"](params, jcfg, {"tokens": jnp.asarray(toks[:, :n])}, sliding=True)
    _, _, tst = prefill(tparams, tcfg, {"tokens": torch.from_numpy(toks[:, :n]).long()},
                        sliding=True)
    _state_close(tst, jst, "float32")
    for i in range(n, n + steps):
        tok = toks[:, i:i + 1]
        jl, jv, jst = ref["decode"](params, jcfg, jnp.asarray(tok), jst, window=W, uniform=True)
        tl, tv, tst = decode_step(tparams, tcfg, torch.from_numpy(tok).long(), tst, window=W,
                                  uniform=True)
        _close(tl, jl, "float32")
        _close(tv, jv, "float32")
    assert int(tst["length"][0]) == n + steps
    _state_close(tst, jst, "float32")


@pytest.mark.parametrize("seq,sliding,prefilled", [(40, False, None), (40, False, 5),
                                                   (200, True, None), (200, True, 100)])
def test_init_decode_state_matches_repro(ref, seq, sliding, prefilled):
    jcfg, tcfg = _cfgs("qwen3-8b")
    jst = jax_init_decode_state(jcfg, B, seq, sliding=sliding, prefilled=prefilled)
    tst = init_decode_state(tcfg, B, seq, sliding=sliding, prefilled=prefilled, device="cpu")
    _state_close(tst, jst, "float32")
    params = _params("qwen3-8b")
    tok = _tokens(jcfg, 1, seed=3)
    window = jcfg.long_context_window if sliding else 0
    jl, jv, jst = ref["decode"](params, jcfg, jnp.asarray(tok), jst, window=window)
    tl, tv, tst = decode_step(from_reference(params, "cpu"), tcfg, torch.from_numpy(tok).long(),
                              tst, window=window)
    _close(tl, jl, "float32")
    _close(tv, jv, "float32")
    _state_close(tst, jst, "float32")


@pytest.mark.parametrize("n", [16, 100])
@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_own_forward(arch, n):
    """decode(n | prefill(0..n-1)) equals forward_train(0..n) at position n,
    past `reserve` too (the port writes every prompt key)."""
    _, cfg = _cfgs(arch)
    params = init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.from_numpy(_tokens(cfg, n + 1, seed=4)).long()
    fl, fv, _ = forward_train(params, cfg, {"tokens": toks})
    pl, pv, state = prefill(params, cfg, {"tokens": toks[:, :n]})
    torch.testing.assert_close(pl, fl[:, :n], atol=1e-4, rtol=0)
    dl, dv, state = decode_step(params, cfg, toks[:, n:], state)
    torch.testing.assert_close(dl[:, 0], fl[:, n], atol=1e-4, rtol=0)
    torch.testing.assert_close(dv[:, 0], fv[:, n], atol=1e-4, rtol=0)
    assert state["length"].tolist() == [n + 1] * B


def test_reference_prefill_truncates_long_prompts(ref):
    """The reference's fault the port does not copy: after a 100-token
    prefill, `repro`'s cache holds only the last 64 prompt keys, so its
    decode is far from its own forward; the port's matches its forward."""
    n = 100
    jcfg, tcfg = _cfgs("qwen3-8b")
    params, toks = _params("qwen3-8b"), _tokens(jcfg, n + 1, seed=5)
    jf, _, _ = ref["forward"](params, jcfg, {"tokens": jnp.asarray(toks)})
    _, _, jst = ref["prefill"](params, jcfg, {"tokens": jnp.asarray(toks[:, :n])})
    assert int((np.asarray(jst["blocks"]["kv0"]["pos"][0, 0]) >= 0).sum()) == 64
    jl, _, _ = ref["decode"](params, jcfg, jnp.asarray(toks[:, n:]), jst)
    assert float(np.abs(np.asarray(jl[:, 0]) - np.asarray(jf[:, n])).max()) > 1e-2

    tparams, ttoks = from_reference(params, "cpu"), torch.from_numpy(toks).long()
    tf, _, _ = forward_train(tparams, tcfg, {"tokens": ttoks})
    _, _, tst = prefill(tparams, tcfg, {"tokens": ttoks[:, :n]})
    assert int((tst["blocks"]["kv0"]["pos"][0, 0] >= 0).sum()) == n
    tl, _, _ = decode_step(tparams, tcfg, ttoks[:, n:], tst)
    torch.testing.assert_close(tl[:, 0], tf[:, n], atol=1e-4, rtol=0)


def test_from_reference_carries_a_decode_state(ref):
    """A `repro` decode state at bf16 compute crosses leaf by leaf: bf16
    caches stay bf16 with the same values, int32 positions and lengths stay
    int32, and the layout (every cache leaf on the leading repeat axis) is
    the port's own."""
    jcfg, tcfg = _cfgs("gemma2-2b", "bfloat16")
    _, _, jst = ref["prefill"](_params("gemma2-2b"), jcfg,
                               {"tokens": jnp.asarray(_tokens(jcfg, T))})
    tst = from_reference(jax.tree.map(np.asarray, jst), "cpu")
    kv = tst["blocks"]["kv0"]
    assert kv["k"].dtype == kv["v"].dtype == torch.bfloat16
    assert kv["pos"].dtype == kv["length"].dtype == tst["length"].dtype == torch.int32
    assert kv["k"].shape == (1, B, T + 64, jcfg.num_kv_heads, jcfg.head_dim)
    for got, want in zip(jax.tree.leaves(tst), jax.tree.leaves(jst)):
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    own = init_decode_state(tcfg, B, T + 64, prefilled=0, device="cpu")
    assert [(a.shape, a.dtype) for a in jax.tree.leaves(own["blocks"])] == [
        (a.shape, a.dtype) for a in jax.tree.leaves(tst["blocks"])]


def test_decode_demo_sliding_sampled_is_seeded():
    """The decode demo over the ring buffer with sampled tokens: the draws
    come from the demo's seeded generator, so one seed gives one sequence."""
    from repro_torch.launch.serve import serve

    kw = dict(smoke=True, batch=2, prompt_len=150, new_tokens=3, sliding=True,
              temperature=1.0, verbose=False, device="cpu")
    a = serve("qwen3-8b", seed=1, **kw)
    b = serve("qwen3-8b", seed=1, **kw)
    assert len(a) == 3 and all(t.shape == (2, 1) for t in a)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(0 <= int(t.min()) and int(t.max()) < 512 for t in a)
