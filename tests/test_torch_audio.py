"""The port's audio family (hubert-xlarge: an encoder-only stack over frame
embeddings) against the JAX package's, on the CPU.

hubert's `smoke()` config, and the same with its published head dim of 80,
so that d = 80 rides the model path; fp32 compute. Params made by
`repro.models.init_params` and carried over with
`repro_torch.params.from_reference`, inputs from a numpy seed; `repro`
runs jitted in its default CPU tier, as `tests/test_torch_families.py`
runs it.

- `init_params`' tree (keys, shapes, dtypes), carried both ways;
- LayerNorm (eps 1e-5) and the non-gated tanh-gelu MLP at hubert's
  published widths (d 1280, d_ff 5120);
- `forward_train` over frames: logits and values, and the attention is
  bidirectional (a later frame moves an earlier position's logits);
- `prefill`: logits, values and the caches (T <= 64, where `repro`'s
  prefill keeps every prompt key too);
- `init_decode_state` and `decode_step` raise (encoder-only);
- `build_mlm_train_step`: loss, `masked_acc`, every grad leaf and the
  params after a second Adam step from `repro`'s carried state (as
  `tests/test_torch_learner.py` compares steps), also with a mask that
  masks nothing.

Tolerance: 1e-4 abs (`tests/test_kernels.py`'s grad bar); params after
the second step within 0.1 * lr.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.learners.steps import build_mlm_train_step as jax_mlm_step
from repro.models import forward_train as jax_forward
from repro.models import init_params as jax_init
from repro.models import layers as jax_layers
from repro.models import prefill as jax_prefill
from repro.optim import Optimizer as JaxOptimizer
from repro.optim import adamw as jax_adamw
from repro_torch.configs import get_arch
from repro_torch.learners import build_mlm_train_step
from repro_torch.models import decode_step, forward_train, init_decode_state, init_params, prefill
from repro_torch.models import layers
from repro_torch.optim import Optimizer, adamw
from repro_torch.params import from_reference, opt_state_from_reference, to_reference
from repro_torch.utils import tree_flatten_with_path

TOL = 1e-4
LR = 3e-4
B, T = 2, 24
HEAD_DIMS = [None, 80]        # smoke()'s 64, and hubert's published 80


def _cfgs(head_dim):
    kw = dict(compute_dtype="float32", **({"head_dim": head_dim} if head_dim else {}))
    return (dataclasses.replace(jax_arch("hubert-xlarge").smoke(), **kw),
            dataclasses.replace(get_arch("hubert-xlarge").smoke(), **kw))


def _params(jcfg):
    return jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(0), jcfg))


def _frames(cfg, n=T, seed=0):
    return np.random.default_rng(seed).normal(size=(B, n, cfg.d_model)).astype(np.float32)


def _close(got, want, tol=TOL, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol, rtol=0,
                               err_msg=what)


@pytest.mark.parametrize("head_dim", HEAD_DIMS)
def test_init_params_tree_matches_repro(head_dim):
    jcfg, tcfg = _cfgs(head_dim)
    want = jax.eval_shape(lambda: jax_init(jax.random.PRNGKey(0), jcfg))
    got = init_params(torch.Generator().manual_seed(0), tcfg)
    assert [(jax.tree_util.keystr(p), tuple(a.shape), str(np.dtype(a.dtype)))
            for p, a in jax.tree_util.tree_flatten_with_path(want)[0]] \
        == [(p, tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for p, t in tree_flatten_with_path(got)[0]]
    assert tcfg.head_dim * tcfg.num_heads == tcfg.q_dim
    ref = _params(jcfg)
    back = to_reference(from_reference(ref, "cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_layernorm_and_gelu_mlp_at_hubert_width_match_repro():
    """hubert's sublayers at its published widths, fp32: LayerNorm (eps
    1e-5, perturbed scale and bias) and the non-gated MLP with `gelu`,
    the tanh form as `jax.nn.gelu`'s default."""
    cfg = jax_arch("hubert-xlarge")
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    ln = {"scale": (1 + 0.1 * rng.normal(size=cfg.d_model)).astype(np.float32),
          "bias": (0.1 * rng.normal(size=cfg.d_model)).astype(np.float32)}
    mp = jax.tree.map(np.asarray, jax_layers.mlp_init(jax.random.PRNGKey(6), cfg.d_model, cfg.d_ff,
                                                      jnp.float32, gated=cfg.mlp_gated))
    assert set(mp) == {"up", "down"}
    _close(layers.layernorm(from_reference(ln, "cpu"), torch.from_numpy(x)),
           jax_layers.layernorm(ln, jnp.asarray(x)), what="layernorm")
    _close(layers.mlp(from_reference(mp, "cpu"), torch.from_numpy(x), cfg.activation),
           jax_layers.mlp(mp, jnp.asarray(x), cfg.activation), what="mlp")


@pytest.mark.parametrize("head_dim", HEAD_DIMS)
def test_forward_train_over_frames_matches_repro(head_dim):
    jcfg, tcfg = _cfgs(head_dim)
    params = _params(jcfg)
    fe = _frames(jcfg)
    jl, jv, _ = jax.jit(jax_forward, static_argnames=("cfg",))(
        params, jcfg, {"frame_embeds": jnp.asarray(fe), "tokens": None})
    tp = from_reference(params, "cpu")
    tl, tv, aux = forward_train(tp, tcfg, {"frame_embeds": torch.from_numpy(fe), "tokens": None})
    assert tl.shape == (B, T, tcfg.vocab_size) and float(aux) == 0.0
    _close(tl, jl, what="logits")
    _close(tv, jv, what="values")
    # bidirectional: the last frame moves the first position's logits
    fe2 = fe.copy()
    fe2[:, -1] = _frames(jcfg, seed=7)[:, -1]
    tl2, _, _ = forward_train(tp, tcfg, {"frame_embeds": torch.from_numpy(fe2)})
    assert float((tl2[:, 0] - tl[:, 0]).abs().max()) > 1e-3


@pytest.mark.parametrize("head_dim", HEAD_DIMS)
def test_prefill_matches_repro(head_dim):
    """The encoder's serving pass (`prefill_32k`): logits, values and the
    caches `repro`'s prefill builds, and its own `forward_train`."""
    jcfg, tcfg = _cfgs(head_dim)
    params = _params(jcfg)
    fe = _frames(jcfg, seed=1)
    jl, jv, jst = jax.jit(jax_prefill, static_argnames=("cfg",))(
        params, jcfg, {"frame_embeds": jnp.asarray(fe)})
    tp = from_reference(params, "cpu")
    tl, tv, tst = prefill(tp, tcfg, {"frame_embeds": torch.from_numpy(fe)})
    _close(tl, jl, what="logits")
    _close(tv, jv, what="values")
    fl, _, _ = forward_train(tp, tcfg, {"frame_embeds": torch.from_numpy(fe)})
    _close(tl, fl.numpy(), what="prefill vs forward_train")
    got, want = to_reference(tst), jax.tree.map(np.asarray, jst)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree.leaves(got)):
        name = jax.tree_util.keystr(path)
        assert g.shape == w.shape, name
        if name.endswith("['pos']") or name.endswith("['length']"):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            _close(g, w, what=name)


def test_init_decode_state_and_decode_step_raise():
    _, tcfg = _cfgs(80)
    with pytest.raises(ValueError, match="encoder-only"):
        init_decode_state(tcfg, B, T, device="cpu")
    params = init_params(torch.Generator().manual_seed(0), tcfg)
    _, _, state = prefill(params, tcfg, {"frame_embeds": torch.zeros(B, 4, tcfg.d_model)})
    with pytest.raises(ValueError, match="encoder-only"):
        decode_step(params, tcfg, {"patch_embeds": torch.zeros(B, 1, tcfg.d_model)}, state)


def _with_grads(opt, cls):
    def update(grads, state, params):
        p, s, m = opt.update(grads, state, params)
        return p, s, {**m, "grads": grads}
    return cls(opt.init, update)


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(a, np.float32)
            for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _mlm_batch(cfg, mask_p, seed=3):
    rng = np.random.default_rng(seed)
    return {"frame_embeds": _frames(cfg, seed=seed),
            "units": rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32),
            "mask": rng.random((B, T)) < mask_p}


@pytest.mark.parametrize("head_dim,mask_p", [(None, 0.3), (80, 0.3), (80, 0.0)],
                         ids=["smoke", "d80", "d80-nothing-masked"])
def test_mlm_train_step_matches_repro(head_dim, mask_p):
    """Two `repro` steps from a fresh adamw state; the port's step 2 from
    `repro`'s params and state after step 1: loss, masked_acc, grads and
    the new params."""
    jcfg, tcfg = _cfgs(head_dim)
    batch = _mlm_batch(jcfg, mask_p)
    assert bool(batch["mask"].any()) == (mask_p > 0)
    asj = lambda t: jax.tree.map(jnp.asarray, t)
    jopt = _with_grads(jax_adamw(LR, clip_norm=1.0), JaxOptimizer)
    jstep = jax_mlm_step(jcfg, jopt, jit=True)
    p0 = _params(jcfg)
    p1, s1, _ = jstep(asj(p0), jopt.init(asj(p0)), asj(batch))
    p1, s1 = jax.tree.map(np.asarray, p1), jax.tree.map(np.asarray, s1)
    jp2, _, jm = jstep(asj(p1), asj(s1), asj(batch))

    topt = _with_grads(adamw(LR, clip_norm=1.0), Optimizer)
    tstep = build_mlm_train_step(tcfg, topt)
    tp2, ts2, tm = tstep(from_reference(p1, "cpu"), opt_state_from_reference(s1, "cpu"),
                         {k: torch.from_numpy(v) for k, v in batch.items()})
    assert int(ts2["step"]) == 2
    for k in ("loss", "masked_acc", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=TOL, rtol=TOL, err_msg=k)
    if mask_p == 0:
        assert float(tm["loss"]) == 0.0 and float(tm["masked_acc"]) == 0.0
    tg, jg = _flat(to_reference(tm["grads"])), _flat(jax.tree.map(np.asarray, jm["grads"]))
    assert tg.keys() == jg.keys()
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], atol=TOL, rtol=0, err_msg=k)
    tpf, jpf = _flat(to_reference(tp2)), _flat(jax.tree.map(np.asarray, jp2))
    for k in jpf:
        np.testing.assert_allclose(tpf[k], jpf[k], atol=0.1 * LR, rtol=0, err_msg=k)


def test_mlm_train_step_takes_an_encoder_only_arch():
    with pytest.raises(ValueError, match="encoder-only"):
        build_mlm_train_step(get_arch("tleague-policy-s"), adamw(LR))
