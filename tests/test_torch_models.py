"""The port's model path against the JAX package, on the CPU.

The same params (made by `repro.models.init_params` and carried over with
`repro_torch.params.convert`) and the same observations (from a seed, with
numpy) go through `repro.actors.policy.make_obs_policy` and the port's
counterpart. Tolerances: 1e-4 at fp32 compute; 5e-2 at bf16 compute, where
the two frameworks round to bf16 at different places (the JAX fast tier
scores attention in bf16, the port's plain version in fp32; measured
maximum 1.6e-2, on the 2-layer policy-m's logits; 7e-7 at fp32). Sampled actions and seeded
initialisations are never compared: the two RNG streams differ.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.actors.policy import make_obs_policy as jax_policy
from repro.configs import get_arch as jax_arch
from repro.models import init_params as jax_init
from repro.models import layers as JL
from repro.rl import distributions as JD
from repro_torch.actors.policy import make_obs_policy
from repro_torch.configs import get_arch
from repro_torch.models import forward_train, init_params
from repro_torch.models import layers as TL
from repro_torch.params import from_reference, to_reference
from repro_torch.rl import distributions as TD
from repro_torch.utils import tree_stack

TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _cfgs(name, **kw):
    """The same config in both packages (and policy-m cut to 2 layers)."""
    if name == "tleague-policy-m":
        kw.setdefault("num_layers", 2)
    return (dataclasses.replace(jax_arch(name), **kw),
            dataclasses.replace(get_arch(name), **kw))


def _jax_params(cfg, seed=0):
    return jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(seed), cfg))


def _shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = (tuple(v.shape), str(v.dtype).replace("torch.", ""))
    return out


@pytest.mark.parametrize("name", ["tleague-policy-s", "tleague-policy-m"])
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_policy_logits_values_match_jax(name, compute):
    jcfg, tcfg = _cfgs(name, compute_dtype=compute)
    params = _jax_params(jcfg)
    obs = np.random.default_rng(0).integers(0, jcfg.vocab_size, (6, 26)).astype(np.int32)
    jl, jv = jax_policy(jcfg, 6).logits_values(params, jnp.asarray(obs))
    tl, tv = make_obs_policy(tcfg, 6).logits_values(from_reference(params, "cpu"),
                                                    torch.from_numpy(obs).long())
    assert tl.shape == (6, 6) and tv.shape == (6,) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL[compute], rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=TOL[compute], rtol=0)


def test_feature_config_matches_jax():
    """Dense-family features beyond the policy nets: local/global layers with
    a sliding window, attention and final logit softcaps, post-block norms,
    tied and scaled embeddings, qk-norm and attention biases."""
    kw = dict(layer_pattern=("local", "global"), num_layers=2, sliding_window=5,
              attn_logit_softcap=20.0, final_logit_softcap=15.0, post_block_norms=True,
              tie_embeddings=True, embed_scale=True, qk_norm=True, attn_bias=True,
              activation="gelu", compute_dtype="float32")
    jcfg, tcfg = _cfgs("tleague-policy-s", **kw)
    params = _jax_params(jcfg, seed=3)
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, (3, 13)).astype(np.int32)
    from repro.models import forward_train as jax_forward
    jl, jv, _ = jax_forward(params, jcfg, {"tokens": jnp.asarray(tokens)})
    tl, tv, aux = forward_train(from_reference(params, "cpu"), tcfg,
                                {"tokens": torch.from_numpy(tokens).long()})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-4, rtol=0)
    assert float(aux) == 0.0


@pytest.mark.parametrize("name", ["tleague-policy-s", "tleague-policy-m"])
def test_grouped_forward_equals_per_model_forwards(name):
    """Params stacked on a model axis (the InfServer's grouped theta + phi
    forward) give each model's own forward."""
    jcfg, tcfg = _cfgs(name, compute_dtype="float32")
    models = [from_reference(_jax_params(jcfg, seed=s), "cpu") for s in (0, 1)]
    obs = torch.from_numpy(np.random.default_rng(2).integers(0, 512, (2, 4, 26))).long()
    pol = make_obs_policy(tcfg, 6)
    gl, gv = pol.logits_values(tree_stack(models), obs)
    assert gl.shape == (2, 4, 6) and gv.shape == (2, 4)
    for m in range(2):
        lm, vm = pol.logits_values(models[m], obs[m])
        torch.testing.assert_close(gl[m], lm, atol=1e-5, rtol=0)
        torch.testing.assert_close(gv[m], vm, atol=1e-5, rtol=0)


@pytest.mark.parametrize("kw", [{}, dict(tie_embeddings=True, post_block_norms=True,
                                         qk_norm=True, attn_bias=True,
                                         layer_pattern=("local", "global"))])
def test_init_params_layout_matches_jax(kw):
    """Same keys, shapes and dtypes as repro's init (the numbers differ), and
    the truncated-normal scale of `layers.py:15-24`."""
    jcfg, tcfg = _cfgs("tleague-policy-s", **kw)
    jp = jax.eval_shape(lambda: jax_init(jax.random.PRNGKey(0), jcfg))
    tp = init_params(torch.Generator().manual_seed(0), tcfg)
    assert _shapes(tp) == {k: (s, str(np.dtype(d))) for k, (s, d) in _shapes(
        jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), jp)).items()}
    w = tp["blocks"]["sub0"]["mlp"]["up"]["w"]
    assert float(w.abs().max()) <= 2.0 * tcfg.d_model ** -0.5 + 1e-6
    assert abs(float(w.std()) - 0.88 * tcfg.d_model ** -0.5) < 0.05 * tcfg.d_model ** -0.5


def test_non_dense_family_raises():
    """A family name the port does not know raises (every family of
    `repro`'s configs is ported)."""
    cfg = dataclasses.replace(get_arch("tleague-policy-s"), family="speech")
    with pytest.raises(NotImplementedError, match="not ported"):
        init_params(torch.Generator().manual_seed(0), cfg)


def test_param_conversion_round_trips():
    jcfg, _ = _cfgs("tleague-policy-s")
    params = _jax_params(jcfg)
    back = to_reference(from_reference(params, "cpu"))
    flat_a, flat_b = jax.tree.leaves(params), jax.tree.leaves(back)
    assert len(flat_a) == len(flat_b)
    assert all(np.array_equal(a, b) for a, b in zip(flat_a, flat_b))
    bf = np.asarray(jnp.asarray([1.5, -2.25, 3e-3], jnp.bfloat16))
    t = from_reference({"x": bf}, "cpu")["x"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(to_reference({"x": t})["x"], bf.astype(np.float32))


# -- layers and distributions ---------------------------------------------------------

def test_rope_mlp_softcap_embed_match_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, 4, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(7, dtype=np.int32), (2, 7)).copy()
    np.testing.assert_allclose(
        TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0).numpy(),
        np.asarray(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)),
        atol=1e-5, rtol=0)
    h = rng.standard_normal((3, 5, 16)).astype(np.float32)
    p = {k: {"w": rng.standard_normal(s).astype(np.float32) * 0.2}
         for k, s in (("up", (16, 24)), ("gate", (16, 24)), ("down", (24, 16)))}
    for act in ("silu", "gelu", "relu", "gelu_tanh"):
        np.testing.assert_allclose(
            TL.mlp(from_reference(p, "cpu"), torch.from_numpy(h), act).numpy(),
            np.asarray(JL.mlp(p, jnp.asarray(h), act)), atol=1e-5, rtol=0)
    np.testing.assert_allclose(TL.softcap(torch.from_numpy(h * 40), 30.0).numpy(),
                               np.asarray(JL.softcap(jnp.asarray(h * 40), 30.0)),
                               atol=1e-4, rtol=0)
    table = rng.standard_normal((11, 8)).astype(np.float32)
    tok = rng.integers(0, 11, (2, 3)).astype(np.int32)
    np.testing.assert_allclose(
        TL.embed({"table": torch.from_numpy(table)}, torch.from_numpy(tok).long(),
                 torch.float32, scale=True).numpy(),
        np.asarray(JL.embed({"table": table}, jnp.asarray(tok), jnp.float32, scale=True)),
        atol=1e-6, rtol=0)


def test_distributions_match_jax():
    rng = np.random.default_rng(6)
    lp = (3 * rng.standard_normal((5, 6))).astype(np.float32)
    lq = (3 * rng.standard_normal((5, 6))).astype(np.float32)
    a = rng.integers(0, 6, 5)
    tp, tq = torch.from_numpy(lp), torch.from_numpy(lq)
    pairs = [(TD.categorical_logp(tp, torch.from_numpy(a)),
              JD.categorical_logp(jnp.asarray(lp), jnp.asarray(a))),
             (TD.categorical_entropy(tp), JD.categorical_entropy(jnp.asarray(lp))),
             (TD.categorical_kl(tp, tq), JD.categorical_kl(jnp.asarray(lp), jnp.asarray(lq)))]
    for t, j in pairs:
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5, rtol=0)


def test_categorical_sample_follows_softmax_and_mask():
    logits = torch.tensor([0.0, 1.0, 2.0, 5.0])
    gen = torch.Generator().manual_seed(0)
    draws = TD.categorical_sample(gen, logits.expand(20000, 4))
    freq = torch.bincount(draws, minlength=4).float() / draws.numel()
    torch.testing.assert_close(freq, torch.softmax(logits, 0), atol=0.01, rtol=0)
    masked = TD.categorical_sample(gen, logits.expand(2000, 4), valid_actions=3)
    assert int(masked.max()) <= 2
    again = TD.categorical_sample(torch.Generator().manual_seed(0), logits.expand(20000, 4))
    assert torch.equal(draws, again)
