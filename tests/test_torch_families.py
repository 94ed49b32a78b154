"""The port's moe, ssm, hybrid and vlm families against the JAX package's,
on the CPU.

Each family's `smoke()` config; params made by `repro.models.init_params`
and carried over with `repro_torch.params.from_reference`, inputs from a
numpy seed. `repro` runs jitted in its default CPU tier, as its own
`tests/test_smoke_archs.py` runs it.

- MoE routing (`route_topk`) on the same numpy gates: slots, keep and
  counts exactly, weights within 1e-6; the data is asserted to have a
  top-k margin above 1e-5, so no tie decides a rank. A capacity low
  enough to drop tokens drops the same ones. `moe_apply`'s (y, aux).
- RWKV6's time mix (full and step) and channel mix; Mamba's full pass and
  step.
- `forward_train`, `prefill` and 3 decode steps (uniform on and off) for
  qwen3-moe, kimi-k2 (its dense prefix and shared expert), rwkv6, hymba
  and pixtral (a patch prefix; a decode step takes a `patch_embeds`
  dict); hymba's sliding ring past its wrap; the port's decode against its
  own `forward_train`.

Tolerances as `tests/test_torch_decode.py`: 1e-4 abs on logits, values
and outputs at fp32, 1e-5 on states; at bf16 compute 2e-2 of max(1, max
|reference|). The RWKV6 state `S` sums T outer products k v^T, so it is
held at 1e-5 of max(1, max |S|) (its entries reach ~10 at T = 16).
Positions and lengths exactly.
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
from repro.models import moe as jax_moe
from repro.models import prefill as jax_prefill
from repro.models import ssm as jax_ssm
from repro_torch.configs import get_arch
from repro_torch.models import (decode_step, forward_train, init_decode_state, init_params,
                                prefill)
from repro_torch.models import moe, ssm
from repro_torch.params import from_reference, to_reference

FAMILIES = ["qwen3-moe-235b-a22b", "kimi-k2-1t-a32b", "rwkv6-3b", "hymba-1.5b", "pixtral-12b"]
CASES = [(a, "float32") for a in FAMILIES] + [(a, "bfloat16") for a in
                                               ("rwkv6-3b", "hymba-1.5b", "pixtral-12b")]
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
STATE_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
B, T, P = 2, 16, 8            # rows, tokens, pixtral's patch prefix


@pytest.fixture(scope="module")
def ref():
    """`repro`'s entry points, one jitted closure each."""
    return {"prefill": jax.jit(jax_prefill, static_argnames=("cfg", "sliding")),
            "decode": jax.jit(jax_decode_step, static_argnames=("cfg", "window", "uniform")),
            "forward": jax.jit(jax_forward, static_argnames=("cfg",))}


def _cfgs(arch, compute="float32", **kw):
    return (dataclasses.replace(jax_arch(arch).smoke(), compute_dtype=compute, **kw),
            dataclasses.replace(get_arch(arch).smoke(), compute_dtype=compute, **kw))


@functools.lru_cache(maxsize=None)
def _params(arch):
    return jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(0), jax_arch(arch).smoke()))


def _batch(cfg, n, seed=0, patches=True):
    """(repro batch, port batch): n tokens per row, and for the vlm family a
    prefix of P patch embeddings."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, n)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks).long()}
    if cfg.family == "vlm" and patches:
        pe = rng.normal(size=(B, P, cfg.d_model)).astype(np.float32)
        jb["patch_embeds"], tb["patch_embeds"] = jnp.asarray(pe), torch.from_numpy(pe)
    return jb, tb


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32) if a.dtype == jnp.bfloat16
                        else np.asarray(a), tree)


def _close(got, want, compute, tol=TOL, relative=False):
    """Within tol[compute]: absolute at fp32 (or relative to max(1, max
    |want|) with `relative`), of max(1, max |want|) at bf16."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    atol = tol[compute]
    if compute == "bfloat16" or relative:
        atol *= max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def _state_close(got, want, compute):
    """A port state (tensors) against a `repro` state (numpy): same keys and
    shapes, floats within STATE_TOL (RWKV6's S relative to its size),
    positions and lengths exact."""
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
            _close(g, w, compute, STATE_TOL, relative=name.endswith("['tm_S']"))


# -- MoE routing ---------------------------------------------------------------

def _gates(N, E, seed):
    logits = np.random.default_rng(seed).normal(size=(N, E)).astype(np.float32)
    g = np.exp(logits - logits.max(-1, keepdims=True))
    return g / g.sum(-1, keepdims=True)


def _assert_margin(gates, k):
    """No tie decides a rank: the top k + 1 gates of every row differ by
    more than 1e-5."""
    top = -np.sort(-gates, axis=-1)[:, :k + 1]
    assert float(np.diff(-top, axis=-1).min()) > 1e-5


@pytest.mark.parametrize("N,E,k,capacity", [(64, 8, 2, 40), (64, 8, 2, 9), (37, 16, 8, 8),
                                            (4, 128, 8, 8)])
def test_route_topk_matches_repro(N, E, k, capacity):
    gates = _gates(N, E, seed=N + E)
    _assert_margin(gates, k)
    js, jw, jk, jc = jax_moe.route_topk(jnp.asarray(gates), k, capacity)
    ts, tw, tk, tc = moe.route_topk(torch.from_numpy(gates), k, capacity)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6, rtol=0)
    if capacity < N * k / E:                  # the drop cases do drop
        assert not tk.all()


def _moe_inputs(arch, n, seed):
    jcfg, tcfg = _cfgs(arch)
    sub = "sub0"
    p = _params(arch)["blocks"][sub]["moe"]
    p = jax.tree.map(lambda a: a[0], p)       # the first repeat unit's experts
    x = np.random.default_rng(seed).normal(size=(B, n, jcfg.d_model)).astype(np.float32)
    gates = jax.nn.softmax(x.reshape(-1, jcfg.d_model) @ np.asarray(p["router"]["w"]), -1)
    _assert_margin(np.asarray(gates), jcfg.moe.experts_per_token)
    return jcfg, tcfg, p, x


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "kimi-k2-1t-a32b"])
def test_moe_apply_matches_repro(arch):
    jcfg, tcfg, p, x = _moe_inputs(arch, T, seed=1)
    jy, ja = jax_moe.moe_apply(p, jcfg, jnp.asarray(x))
    ty, ta = moe.moe_apply(from_reference(p, "cpu"), tcfg, torch.from_numpy(x))
    _close(ty, jy, "float32")
    _close(ta, ja, "float32")


@pytest.mark.parametrize("cf", [0.5, 1.0])
def test_moe_drops_the_same_tokens_as_repro(cf):
    """capacity_factor below what the load needs: the same choices go to the
    drop bucket in both packages, and the outputs (dropped tokens get only
    their kept experts) agree."""
    arch = "qwen3-moe-235b-a22b"
    jcfg, tcfg, p, x = _moe_inputs(arch, T, seed=2)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=cf))
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe, capacity_factor=cf))
    e = jcfg.moe
    N = B * T
    capacity = max(int(N * e.experts_per_token * cf / e.num_experts), e.experts_per_token)
    xf = x.reshape(N, -1)
    jg = jax.nn.softmax(jnp.asarray(xf) @ p["router"]["w"], -1)
    tg = torch.softmax(torch.from_numpy(xf) @ torch.tensor(np.asarray(p["router"]["w"])), -1)
    _, _, jkeep, _ = jax_moe.route_topk(jg, e.experts_per_token, capacity)
    _, _, tkeep, _ = moe.route_topk(tg, e.experts_per_token, capacity)
    assert not bool(np.asarray(jkeep).all())
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    jy, ja = jax_moe.moe_apply(p, jcfg, jnp.asarray(x))
    ty, ta = moe.moe_apply(from_reference(p, "cpu"), tcfg, torch.from_numpy(x))
    _close(ty, jy, "float32")
    _close(ta, ja, "float32")


def test_expert_parallel_raises_naming_the_mesh_slice():
    """The toggle no longer raises (the mesh is ported): with no mesh scope
    `moe_apply` keeps its routed path whatever the toggle says; inside a
    data-parallel scope on a one-rank mesh it takes the mesh path
    (`_moe_ranked`), and so does `moe_apply_ep`, each equal to the routed
    path (`tests/test_torch_mesh.py` holds them on (2, 4))."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import close_local_mesh, make_local_mesh

    _, tcfg = _cfgs("qwen3-moe-235b-a22b")
    p = moe.init_moe(torch.Generator().manual_seed(0), tcfg, torch.float32)
    x = torch.randn(2, 8, tcfg.d_model, generator=torch.Generator().manual_seed(1))
    y0, a0 = moe.moe_apply(p, tcfg, x)
    moe.set_expert_parallel(True)
    try:
        y1, a1 = moe.moe_apply(p, tcfg, x)           # no mesh scope: the routed path
        assert torch.equal(y1, y0) and torch.equal(a1, a0)
        mesh = make_local_mesh("cpu")
        try:
            with SH.data_parallel(mesh, ("data",)):
                y2, a2 = moe.moe_apply(p, tcfg, x)   # the mesh path
                y3, a3 = moe.moe_apply_ep(p, tcfg, x, mesh)
        finally:
            close_local_mesh()
    finally:
        moe.set_expert_parallel(False)
    for y, a in ((y2, a2), (y3, a3)):
        torch.testing.assert_close(y, y0, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(a, a0, rtol=1e-5, atol=1e-6)


# -- the scans -----------------------------------------------------------------

def test_rwkv_time_mix_and_channel_mix_match_repro():
    jcfg, tcfg = _cfgs("rwkv6-3b")
    unit = jax.tree.map(lambda a: a[0], _params("rwkv6-3b")["blocks"]["sub0"])
    tunit = from_reference(unit, "cpu")
    rng = np.random.default_rng(3)
    d, hs = jcfg.d_model, jcfg.ssm.head_size
    x = rng.normal(size=(B, T, d)).astype(np.float32)
    xp = rng.normal(size=(B, d)).astype(np.float32)
    S0 = rng.normal(size=(B, d // hs, hs, hs)).astype(np.float32)
    jy, (jx, jS) = jax_ssm.rwkv_time_mix(unit["time_mix"], jcfg, jnp.asarray(x),
                                         jnp.asarray(xp), jnp.asarray(S0))
    ty, (tx, tS) = ssm.rwkv_time_mix(tunit["time_mix"], tcfg, torch.from_numpy(x),
                                     torch.from_numpy(xp), torch.from_numpy(S0))
    _close(ty, jy, "float32")
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    _close(tS, jS, "float32", STATE_TOL, relative=True)
    # one step from that state
    x1 = rng.normal(size=(B, 1, d)).astype(np.float32)
    jy, (jx, jS) = jax_ssm.rwkv_time_mix_step(unit["time_mix"], jcfg, jnp.asarray(x1), (jx, jS))
    ty, (tx, tS) = ssm.rwkv_time_mix_step(tunit["time_mix"], tcfg, torch.from_numpy(x1),
                                          (tx, tS))
    _close(ty, jy, "float32")
    _close(tS, jS, "float32", STATE_TOL, relative=True)
    jy, jx = jax_ssm.rwkv_channel_mix(unit["channel_mix"], jcfg, jnp.asarray(x), jnp.asarray(xp))
    ty, tx = ssm.rwkv_channel_mix(tunit["channel_mix"], tcfg, torch.from_numpy(x),
                                  torch.from_numpy(xp))
    _close(ty, jy, "float32")
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))


@pytest.mark.parametrize("n", [T, 3])         # 3 = conv_kernel - 1: the buffer is all of x
def test_mamba_full_and_step_match_repro(n):
    jcfg, tcfg = _cfgs("hymba-1.5b")
    p = jax.tree.map(lambda a: a[0], _params("hymba-1.5b")["blocks"]["sub0"]["mamba"])
    tp = from_reference(p, "cpu")
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, n, jcfg.d_model)).astype(np.float32)
    jy, jst = jax_ssm.mamba_apply(p, jcfg, jnp.asarray(x))
    ty, tst = ssm.mamba_apply(tp, tcfg, torch.from_numpy(x))
    _close(ty, jy, "float32")
    for a, b in zip(tst, jst):
        _close(a, b, "float32", STATE_TOL)
    x1 = rng.normal(size=(B, 1, jcfg.d_model)).astype(np.float32)
    jy, jst = jax_ssm.mamba_apply(p, jcfg, jnp.asarray(x1), state=jst)
    ty, tst = ssm.mamba_apply(tp, tcfg, torch.from_numpy(x1), state=tst)
    _close(ty, jy, "float32")
    for a, b in zip(tst, jst):
        _close(a, b, "float32", STATE_TOL)


# -- the entry points ----------------------------------------------------------

def _prefix(cfg):
    return P if cfg.family == "vlm" else 0


@pytest.mark.parametrize("arch,compute", CASES)
def test_forward_train_matches_repro(ref, arch, compute):
    jcfg, tcfg = _cfgs(arch, compute)
    params = _params(arch)
    jb, tb = _batch(jcfg, T)
    jl, jv, ja = ref["forward"](params, jcfg, jb)
    tl, tv, ta = forward_train(from_reference(params, "cpu"), tcfg, tb)
    assert tl.shape == (B, _prefix(tcfg) + T, tcfg.vocab_size) and tl.dtype == torch.float32
    _close(tl, jl, compute)
    _close(tv, jv, compute)
    assert ta.dtype == torch.float32 and (float(ta) > 0) == (tcfg.moe is not None)
    _close(ta, ja, "float32")


@pytest.mark.parametrize("arch,compute", CASES)
def test_prefill_matches_repro(ref, arch, compute):
    jcfg, tcfg = _cfgs(arch, compute)
    params = _params(arch)
    jb, tb = _batch(jcfg, T)
    jl, jv, jst = ref["prefill"](params, jcfg, jb)
    tl, tv, tst = prefill(from_reference(params, "cpu"), tcfg, tb)
    _close(tl, jl, compute)
    _close(tv, jv, compute)
    _state_close(tst, jst, compute)
    assert ("dense_prefix" in tst) == bool(tcfg.moe and tcfg.moe.first_k_dense)


@pytest.mark.parametrize("uniform", [True, False])
@pytest.mark.parametrize("arch,compute", CASES)
def test_decode_step_matches_repro(ref, arch, compute, uniform):
    """Three steps from `repro`'s prefill state, carried over with
    `from_reference`; pixtral's first step takes a `patch_embeds` dict."""
    jcfg, tcfg = _cfgs(arch, compute)
    params = _params(arch)
    tparams = from_reference(params, "cpu")
    jb, _ = _batch(jcfg, T)
    _, _, jst = ref["prefill"](params, jcfg, jb)
    tst = from_reference(jax.tree.map(np.asarray, jst), "cpu")
    rng = np.random.default_rng(5)
    for i in range(3):
        if i == 0 and jcfg.family == "vlm":
            pe = rng.normal(size=(B, 1, jcfg.d_model)).astype(np.float32)
            jin, tin = {"patch_embeds": jnp.asarray(pe)}, {"patch_embeds": torch.from_numpy(pe)}
        else:
            tok = rng.integers(0, jcfg.vocab_size, (B, 1)).astype(np.int32)
            jin, tin = jnp.asarray(tok), torch.from_numpy(tok).long()
        jl, jv, jst = ref["decode"](params, jcfg, jin, jst, uniform=uniform)
        tl, tv, tst = decode_step(tparams, tcfg, tin, tst, uniform=uniform)
        assert tl.shape == (B, 1, tcfg.vocab_size) and tv.shape == (B, 1)
        _close(tl, jl, compute)
        _close(tv, jv, compute)
    _state_close(tst, jst, compute)
    assert tst["length"].tolist() == [_prefix(tcfg) + T + 3] * B


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_matches_own_forward(arch):
    """decode(T | prefill(0..T-1)) equals forward_train(0..T) at position T
    (pixtral after its patch prefix); the smoke MoE drops no token."""
    _, cfg = _cfgs(arch)
    params = init_params(torch.Generator().manual_seed(0), cfg)
    _, full = _batch(cfg, T + 1, seed=6)
    n = _prefix(cfg) + T
    fl, fv, _ = forward_train(params, cfg, full)
    pl, pv, state = prefill(params, cfg, {**full, "tokens": full["tokens"][:, :T]})
    torch.testing.assert_close(pl, fl[:, :n], atol=1e-4, rtol=0)
    torch.testing.assert_close(pv, fv[:, :n], atol=1e-4, rtol=0)
    dl, dv, state = decode_step(params, cfg, full["tokens"][:, T:], state)
    torch.testing.assert_close(dl[:, 0], fl[:, n], atol=1e-4, rtol=0)
    torch.testing.assert_close(dv[:, 0], fv[:, n], atol=1e-4, rtol=0)
    assert state["length"].tolist() == [n + 1] * B


def test_hymba_sliding_ring_past_its_wrap(ref):
    """hymba's every layer local (window 64): a 120-token prompt into a
    ring of 120 slots, then 16 steps at window 128 (the long_500k
    variant), which overwrite the oldest keys; the Mamba states carry on."""
    arch = "hymba-1.5b"
    jcfg, tcfg = _cfgs(arch)
    W, n, steps = jcfg.long_context_window, 120, 16
    params = _params(arch)
    tparams = from_reference(params, "cpu")
    toks = np.random.default_rng(7).integers(0, jcfg.vocab_size, (B, n + steps)).astype(np.int32)
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
    _state_close(tst, jst, "float32")


@pytest.mark.parametrize("arch,sliding", [("kimi-k2-1t-a32b", False), ("rwkv6-3b", False),
                                          ("hymba-1.5b", True)])
def test_init_decode_state_matches_repro(ref, arch, sliding):
    jcfg, tcfg = _cfgs(arch)
    seq = 200
    jst = jax_init_decode_state(jcfg, B, seq, sliding=sliding)
    tst = init_decode_state(tcfg, B, seq, sliding=sliding, device="cpu")
    _state_close(tst, jst, "float32")
    params = _params(arch)
    tok = np.random.default_rng(8).integers(0, jcfg.vocab_size, (B, 1)).astype(np.int32)
    window = jcfg.long_context_window if sliding else 0
    jl, jv, jst = ref["decode"](params, jcfg, jnp.asarray(tok), jst, window=window)
    tl, tv, tst = decode_step(from_reference(params, "cpu"), tcfg, torch.from_numpy(tok).long(),
                              tst, window=window)
    _close(tl, jl, "float32")
    _close(tv, jv, "float32")
    _state_close(tst, jst, "float32")


def test_audio_family_has_no_decode_step():
    """hubert is encoder-only: `init_decode_state` and `decode_step` raise,
    as `repro`'s init_decode_state asserts; its prefill runs
    (`tests/test_torch_audio.py`)."""
    cfg = get_arch("hubert-xlarge").smoke()
    with pytest.raises(ValueError, match="encoder-only"):
        init_decode_state(cfg, B, 8, device="cpu")
    params = init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(ValueError, match="encoder-only"):
        decode_step(params, cfg, torch.zeros((B, 1), dtype=torch.long), {})
