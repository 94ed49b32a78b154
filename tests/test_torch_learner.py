"""The port's learner step against the JAX package's, on the CPU: the RL
math, the optimizers and one full train step at env and at sequence scale.

The same params (made by `repro.models.init_params`) and optimizer state
(carried over with `repro_torch.params`) and the same batches (from a seed,
with numpy) go through `repro` and the port. The JAX steps run under
`repro`'s `dispatch.force("interpret")`, so their Pallas kernels run in
interpret mode, with a fresh step closure per call (the JAX jit cache
ignores the dispatch mode). Grads come out of both steps through an
optimizer that returns them among its metrics.

Tolerances: 1e-4 on the loss, metrics and every grad leaf at fp32 compute
(tests/test_kernels.py's grad bar); 1e-6 for the optimizers fed identical
grads; 2e-2 of each leaf's max |g| at bf16 compute, where the two packages
round to bf16 at different places. Updated params are compared after a
second Adam step from a carried JAX state, whose moments are no longer
sign(g), at lr * 0.1 = 3e-5: Adam divides each grad by its running RMS, so
an element whose grads are near zero turns a grad difference of 1e-7 into
a visible change of its update. Measured on the CPU: grads within 3.0e-7
(env step) and 4.1e-8 (seq step), params within 1.2e-7 and 6.6e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.kernels import dispatch as jax_dispatch
from repro.learners.steps import build_env_train_step as jax_env_step
from repro.learners.steps import build_seq_train_step as jax_seq_step
from repro.models import forward_train as jax_forward
from repro.models import init_params as jax_init
from repro.optim import Optimizer as JaxOptimizer
from repro.optim import adamw as jax_adamw
from repro.optim import sgd as jax_sgd
from repro.optim import schedules as jax_schedules
from repro.rl import ppo as JP
from repro.rl import returns as JR
from repro.rl.vtrace import vtrace as jax_vtrace
from repro.rl.vtrace_loss import VTraceConfig as JaxVTraceConfig
from repro.rl.vtrace_loss import vtrace_loss as jax_vtrace_loss
from repro_torch.configs import get_arch
from repro_torch.learners import build_env_train_step, build_seq_train_step
from repro_torch.models import init_params
from repro_torch.optim import Optimizer, adamw, schedules, sgd
from repro_torch.params import from_reference, opt_state_from_reference, to_reference
from repro_torch.rl import ppo as TP
from repro_torch.rl import returns as TR
from repro_torch.rl.vtrace import vtrace
from repro_torch.rl.vtrace_loss import VTraceConfig, vtrace_loss
from repro_torch.utils import tree_leaves, tree_map

TOL = 1e-4
OPT_TOL = 1e-6
BF16_REL = 2e-2
LR = 3e-4
NUM_ACTIONS = 6
OBS_LEN = 26


def _t(a):
    return torch.from_numpy(np.array(a))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        elif v is not None:
            out[prefix + k] = np.asarray(v.detach().float() if isinstance(v, torch.Tensor) else v,
                                         np.float32)
    return out


def _traj(rng, B, T):
    """Per-step RL fields (B, T) and the bootstrap (B,), as numpy."""
    return {"actions": rng.integers(0, NUM_ACTIONS, (B, T)).astype(np.int32),
            "behavior_logp": (-np.abs(rng.normal(size=(B, T))) - 1.0).astype(np.float32),
            "behavior_values": rng.normal(size=(B, T)).astype(np.float32),
            "rewards": rng.normal(size=(B, T)).astype(np.float32),
            "bootstrap_value": rng.normal(size=(B,)).astype(np.float32)}


def _discounts(rng, B, T, gamma=0.99):
    return (gamma * (rng.random((B, T)) >= 0.2)).astype(np.float32)


# -- RL math -----------------------------------------------------------------------

def test_gae_and_returns_match_jax():
    rng = np.random.default_rng(20)
    B, T = 5, 33
    tr = _traj(rng, B, T)
    disc = _discounts(rng, B, T)
    args = (tr["rewards"], tr["behavior_values"], disc, tr["bootstrap_value"])
    with jax_dispatch.force("interpret"):
        ja = JR.gae(*map(jnp.asarray, args), lam=0.9)
        jl = JR.lambda_return(*map(jnp.asarray, args), lam=0.9)
        jd = JR.discounted_return(*map(jnp.asarray, (args[0], args[2], args[3])))
    ta = TR.gae(*map(_t, args), lam=0.9)
    tl = TR.lambda_return(*map(_t, args), lam=0.9)
    td = TR.discounted_return(*map(_t, (args[0], args[2], args[3])))
    for t, j in zip((*ta, tl, td), (*ja, jl, jd)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=TOL, rtol=TOL)


def test_vtrace_matches_jax_and_carries_no_grad():
    rng = np.random.default_rng(21)
    B, T = 4, 20
    tr = _traj(rng, B, T)
    disc = _discounts(rng, B, T)
    target = (tr["behavior_logp"] + 0.3 * rng.normal(size=(B, T))).astype(np.float32)
    args = (tr["behavior_logp"], target, tr["rewards"], tr["behavior_values"], disc,
            tr["bootstrap_value"])
    kw = dict(lam=0.95, clip_rho=1.0, clip_c=0.9)
    with jax_dispatch.force("interpret"):
        jvs, jadv = jax_vtrace(*map(jnp.asarray, args), **kw)
    targs = [_t(a) for a in args]
    targs[3].requires_grad_()                          # values: the critic's output
    tvs, tadv = vtrace(*targs, **kw)
    assert not tvs.requires_grad and not tadv.requires_grad
    np.testing.assert_allclose(tvs.numpy(), np.asarray(jvs), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tadv.numpy(), np.asarray(jadv), atol=TOL, rtol=TOL)


def _loss_inputs(rng, B, T, A=NUM_ACTIONS):
    tr = _traj(rng, B, T)
    tr["discounts"] = _discounts(rng, B, T)
    logits = rng.normal(size=(B, T, A)).astype(np.float32)
    values = rng.normal(size=(B, T)).astype(np.float32)
    return logits, values, tr


@pytest.mark.parametrize("kind", ["ppo", "vtrace"])
def test_losses_and_grads_match_jax(kind):
    """Loss, metrics and grads wrt logits and values; the targets the scan
    computes carry no grad (`stop_gradient` in repro, `.detach()` here)."""
    rng = np.random.default_rng(22)
    logits, values, tr = _loss_inputs(rng, 3, 12)
    if kind == "ppo":
        jfn, jhp = JP.ppo_loss, JP.PPOConfig()
        tfn, thp = TP.ppo_loss, TP.PPOConfig()
    else:
        jfn, jhp = jax_vtrace_loss, JaxVTraceConfig(clip_c=0.9)
        tfn, thp = vtrace_loss, VTraceConfig(clip_c=0.9)
    jtr = {k: jnp.asarray(v) for k, v in tr.items()}
    with jax_dispatch.force("interpret"):
        (jl, jm), (jgl, jgv) = jax.value_and_grad(
            lambda lg, v: jfn(lg, v, jtr, jhp), argnums=(0, 1), has_aux=True)(
                jnp.asarray(logits), jnp.asarray(values))
    tlg, tv = _t(logits).requires_grad_(), _t(values).requires_grad_()
    tl, tm = tfn(tlg, tv, {k: _t(v) for k, v in tr.items()}, thp)
    tgl, tgv = torch.autograd.grad(tl, (tlg, tv))
    assert set(tm) == set(jm)
    np.testing.assert_allclose(tl.item(), float(jl), atol=TOL, rtol=TOL)
    for k in jm:
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), atol=TOL, rtol=TOL, err_msg=k)
    np.testing.assert_allclose(tgl.numpy(), np.asarray(jgl), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tgv.numpy(), np.asarray(jgv), atol=TOL, rtol=TOL)


# -- optimizers ----------------------------------------------------------------------

def _opt_params(rng):
    return {"a": rng.normal(size=(7, 5)).astype(np.float32),
            "b": {"c": rng.normal(size=(11,)).astype(np.float32)}}


@pytest.mark.parametrize("name,kw", [
    ("adamw", dict(weight_decay=0.01, clip_norm=1.0)),
    ("adamw", dict(master_fp32=True)),
    ("sgd", dict(momentum=0.9, clip_norm=0.5)),
    ("sgd", dict()),
])
def test_optimizers_match_jax(name, kw):
    """Three updates fed identical grads: params, state and metrics."""
    rng = np.random.default_rng(23)
    params = _opt_params(rng)
    jopt = (jax_adamw if name == "adamw" else jax_sgd)(1e-2, **kw)
    topt = (adamw if name == "adamw" else sgd)(1e-2, **kw)
    jp, tp = jax.tree.map(jnp.asarray, params), from_reference(params, "cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    assert set(js) == set(ts) and ts["step"].dtype == torch.int32
    for _ in range(3):
        grads = jax.tree.map(lambda p: rng.normal(size=p.shape).astype(np.float32), params)
        jp, js, jm = jopt.update(jax.tree.map(jnp.asarray, grads), js, jp)
        tp, ts, tm = topt.update(from_reference(grads, "cpu"), ts, tp)
    for got, want in ((tp, jp), ({k: v for k, v in ts.items() if k != "step"},
                                 {k: v for k, v in js.items() if k != "step"})):
        g, w = _flat(got), _flat(jax.tree.map(np.asarray, want))
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_allclose(g[k], w[k], atol=OPT_TOL, rtol=OPT_TOL, err_msg=k)
    assert int(ts["step"]) == int(js["step"]) == 3
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=OPT_TOL, rtol=OPT_TOL)


@pytest.mark.parametrize("kw", [dict(weight_decay=0.01, clip_norm=1.0),
                                dict(master_fp32=True, clip_norm=1.0)],
                         ids=["fp32", "bf16-master"])
def test_adamw_in_place_equals_the_functional_update(kw, monkeypatch):
    """`adamw(inplace=True)` writes into the tensors it is given and gives
    the functional update's numbers bit for bit; slices are made small
    here, so every leaf but the scalar is updated in several, the one
    whose first axis is a stack of one layer too."""
    import repro_torch.kernels.adamw.ops as adamw_ops
    monkeypatch.setattr(adamw_ops, "_SLICE_ELEMS", 8)
    dtype = torch.bfloat16 if kw.get("master_fp32") else torch.float32
    gen = torch.Generator().manual_seed(31)
    params = {"a": torch.randn(7, 5, generator=gen).to(dtype),
              "b": {"c": torch.randn(11, 3, generator=gen).to(dtype),
                    "s": torch.randn((), generator=gen).to(dtype)},
              "stack": torch.randn(1, 6, 4, generator=gen).to(dtype)}
    fopt, iopt = adamw(1e-2, **kw), adamw(1e-2, inplace=True, **kw)
    fp, fs = params, fopt.init(params)
    ip, is_ = tree_map(torch.clone, params), fopt.init(params)
    for _ in range(3):
        grads = tree_map(lambda p: (3 * torch.randn(p.shape, generator=gen)).to(dtype), params)
        fp, fs, fm = fopt.update(grads, fs, fp)
        leaves = tree_leaves(ip) + tree_leaves(is_["mu"])
        ip2, is_, im = iopt.update(grads, is_, ip)
        assert all(a is b for a, b in zip(tree_leaves(ip2) + tree_leaves(is_["mu"]), leaves))
        ip = ip2
    for a, b in zip(tree_leaves((fp, fs)), tree_leaves((ip, is_))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert all(torch.equal(fm[k], im[k]) for k in fm)


def test_schedules_match_jax():
    for fj, ft in ((jax_schedules.constant(0.1), schedules.constant(0.1)),
                   (jax_schedules.linear(1.0, 0.1, 10), schedules.linear(1.0, 0.1, 10)),
                   (jax_schedules.linear_warmup_cosine(1.0, 3, 12, 0.05),
                    schedules.linear_warmup_cosine(1.0, 3, 12, 0.05))):
        for s in (0, 1, 3, 7, 12, 20):
            np.testing.assert_allclose(float(ft(torch.tensor(s, dtype=torch.int32))),
                                       float(fj(jnp.int32(s))), atol=OPT_TOL, rtol=OPT_TOL)


def test_opt_state_carries_across():
    rng = np.random.default_rng(24)
    params = jax.tree.map(jnp.asarray, _opt_params(rng))
    for opt in (jax_adamw(1e-3, master_fp32=True), jax_sgd(1e-3)):
        state = jax.tree.map(np.asarray, opt.init(params))
        ts = opt_state_from_reference(state, "cpu")
        assert set(ts) == set(state) and ts["step"].dtype == torch.int32
        back = {k: v for k, v in to_reference(ts).items() if k != "step"}
        assert _flat(back).keys() == _flat({k: v for k, v in state.items() if k != "step"}).keys()
    with pytest.raises(ValueError):
        opt_state_from_reference({"mu": {}}, "cpu")


# -- the train steps -----------------------------------------------------------------

def _with_grads(opt, cls):
    """`opt` that also returns the grads it was fed, among its metrics."""
    def update(grads, state, params):
        p, s, m = opt.update(grads, state, params)
        return p, s, {**m, "grads": grads}
    return cls(opt.init, update)


def _jax_two_steps(build, jparams_np, batch_np):
    """Two JAX steps from a fresh adamw state: returns (params and state
    after step 1, metrics and params after step 2), as numpy."""
    opt = _with_grads(jax_adamw(LR, clip_norm=1.0), JaxOptimizer)
    asj = lambda t: jax.tree.map(jnp.asarray, t)
    with jax_dispatch.force("interpret"):
        step = build(opt)                       # a fresh closure per mode
        p1, s1, _ = step(asj(jparams_np), opt.init(asj(jparams_np)), asj(batch_np))
        p1, s1 = jax.tree.map(np.asarray, p1), jax.tree.map(np.asarray, s1)
        p2, _, m2 = step(asj(p1), asj(s1), asj(batch_np))
    return p1, s1, jax.tree.map(np.asarray, m2), jax.tree.map(np.asarray, p2)


def _port_step(build, p1, s1, batch_np):
    opt = _with_grads(adamw(LR, clip_norm=1.0), Optimizer)
    step = build(opt)
    params = from_reference(p1, "cpu")
    before = tree_map(torch.clone, params)
    out = step(params, opt_state_from_reference(s1, "cpu"),
               {k: torch.from_numpy(v) for k, v in batch_np.items()})
    for a, b in zip(tree_leaves(params), tree_leaves(before)):  # functional: inputs kept
        assert torch.equal(a, b)
    return out


def _compare_step(tm, tp, jm, jp, grad_tol=TOL, rel=False):
    tg, jg = _flat(tm.pop("grads")), _flat(jm.pop("grads"))
    assert tg.keys() == jg.keys()
    for k in jg:
        scale = max(float(np.abs(jg[k]).max()), 1e-30) if rel else 1.0
        np.testing.assert_allclose(tg[k], jg[k], atol=grad_tol * scale, rtol=0, err_msg=k)
    assert set(tm) == set(jm)
    if rel:
        return
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=TOL, rtol=TOL, err_msg=k)
    tpf, jpf = _flat(tp), _flat(jp)
    for k in jpf:
        np.testing.assert_allclose(tpf[k], jpf[k], atol=0.1 * LR, rtol=0, err_msg=k)


def _env_batch(rng, B, T):
    batch = _traj(rng, B, T)
    batch["obs"] = rng.integers(0, 16, (B, T, OBS_LEN)).astype(np.int32)
    batch["done"] = rng.random((B, T)) < 0.2
    return batch


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_env_train_step_matches_jax(compute):
    """policy-s at B=2, T=4, PPO-clip with GAE, adamw(3e-4, clip_norm=1.0)
    as `launch/train.py` trains it."""
    kw = dict(compute_dtype=compute)
    jcfg = dataclasses.replace(jax_arch("tleague-policy-s"), **kw)
    tcfg = dataclasses.replace(get_arch("tleague-policy-s"), **kw)
    rng = np.random.default_rng(25)
    jparams = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(1), jcfg))
    batch = _env_batch(rng, 2, 4)
    p1, s1, jm, jp = _jax_two_steps(lambda o: jax_env_step(jcfg, NUM_ACTIONS, o),
                                    jparams, batch)
    tp, ts, tm = _port_step(lambda o: build_env_train_step(tcfg, NUM_ACTIONS, o), p1, s1, batch)
    assert int(ts["step"]) == 2
    if compute == "float32":
        _compare_step(tm, tp, jm, jp)
    else:
        _compare_step(tm, tp, jm, jp, grad_tol=BF16_REL, rel=True)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=BF16_REL)


def test_seq_train_step_matches_jax():
    """V-trace over one 256-token sequence, every layer local with window 64
    and softcap 30, fp32 compute, remat on: the sequence-scale step of
    `benchmarks/run.py` cut from T = 4096 and window 512."""
    kw = dict(sliding_window=64, attn_logit_softcap=30.0, layer_pattern=("local",),
              compute_dtype="float32", max_position=8192)
    jcfg = dataclasses.replace(jax_arch("tleague-policy-s"), **kw)
    tcfg = dataclasses.replace(get_arch("tleague-policy-s"), **kw)
    rng = np.random.default_rng(26)
    jparams = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(2), jcfg))
    T = 256
    batch = _traj(rng, 1, T)
    batch["actions"] = rng.integers(0, jcfg.vocab_size, (1, T)).astype(np.int32)
    batch["behavior_logp"] = (batch["behavior_logp"] - 5.0).astype(np.float32)
    batch["tokens"] = rng.integers(0, jcfg.vocab_size, (1, T)).astype(np.int32)
    batch["discounts"] = _discounts(rng, 1, T)
    p1, s1, jm, jp = _jax_two_steps(
        lambda o: jax_seq_step(jcfg, o, loss="vtrace", jit=True), jparams, batch)
    tp, ts, tm = _port_step(lambda o: build_seq_train_step(tcfg, o, loss="vtrace"),
                            p1, s1, batch)
    _compare_step(tm, tp, jm, jp)


@pytest.mark.parametrize("arch,prefix", [("pixtral-12b", "patch_embeds"),
                                         ("hubert-xlarge", "frame_embeds")])
def test_seq_train_step_sees_the_modality_prefix(arch, prefix):
    """PPO over tokens after a prefix of patch (vlm) or frame (audio)
    embeddings, which the model sees first and the RL fields skip: the
    smoke config at fp32 params and compute, the same params and batch
    through `repro`'s step and the port's (loss, grads, the params after a
    second step)."""
    kw = dict(compute_dtype="float32", param_dtype="float32")
    jcfg = dataclasses.replace(jax_arch(arch).smoke(), **kw)
    tcfg = dataclasses.replace(get_arch(arch).smoke(), **kw)
    rng = np.random.default_rng(28)
    jparams = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(4), jcfg))
    B, P, T = 2, 6, 10
    batch = _traj(rng, B, T)
    batch["actions"] = rng.integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    batch["behavior_logp"] = (batch["behavior_logp"] - 5.0).astype(np.float32)
    batch["tokens"] = rng.integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    batch["discounts"] = _discounts(rng, B, T)
    batch[prefix] = rng.normal(size=(B, P, jcfg.d_model)).astype(np.float32)
    p1, s1, jm, jp = _jax_two_steps(lambda o: jax_seq_step(jcfg, o, jit=True), jparams, batch)
    tp, ts, tm = _port_step(lambda o: build_seq_train_step(tcfg, o), p1, s1, batch)
    _compare_step(tm, tp, jm, jp)


def test_remat_changes_no_grad():
    """`remat=True` recomputes each unit's forward in the backward; the
    grads are those of the plain forward."""
    cfg = dataclasses.replace(get_arch("tleague-policy-s"), compute_dtype="float32",
                              sliding_window=8, layer_pattern=("local",))
    rng = np.random.default_rng(27)
    params = init_params(torch.Generator().manual_seed(3), cfg)
    batch = _traj(rng, 1, 24)
    batch["discounts"] = _discounts(rng, 1, 24)
    batch["tokens"] = rng.integers(0, cfg.vocab_size, (1, 24)).astype(np.int32)
    out = []
    for remat in (False, True):
        opt = _with_grads(sgd(0.0), Optimizer)
        step = build_seq_train_step(cfg, opt, loss="vtrace", remat=remat)
        out.append(step(params, opt.init(params),
                        {k: torch.from_numpy(v) for k, v in batch.items()})[2])
    for k, v in _flat(out[0]["grads"]).items():
        np.testing.assert_allclose(_flat(out[1]["grads"])[k], v, atol=1e-6, rtol=0, err_msg=k)


def test_launch_optimizer_steps_match_jax_where_the_loss_rises():
    """Three steps of the launch optimizer (`adamw(3e-4, clip_norm=1.0)`,
    as `repro`'s launch/steps.py builds it) on one fixed on-policy batch:
    rwkv6 at 2 layers, d_model 1024 (16 heads of 64), vocab 4096, fp32,
    2 x 64 tokens, the behavior log-probs and values the initial policy's
    own. Adam's first step moves every element by about lr, which at this
    width moves PPO's ratio by 10^2 or more, and the loss ends higher than
    it began in `repro` as well: the port's losses and ratio means follow
    `repro`'s step by step. rtol 1e-3: the ratios of 10^2-10^3 magnify the
    two packages' 1e-7 grad differences (measured: 4.0e-4 on the last
    loss, 1.7e-4 on its ratio mean)."""
    kw = dict(d_model=1024, num_heads=16, num_kv_heads=16, d_ff=3584, vocab_size=4096,
              num_layers=2, compute_dtype="float32", param_dtype="float32")
    jcfg = dataclasses.replace(jax_arch("rwkv6-3b").smoke(), **kw)
    tcfg = dataclasses.replace(get_arch("rwkv6-3b").smoke(), **kw)
    rng = np.random.default_rng(29)
    B, T = 2, 64
    jparams = jax_init(jax.random.PRNGKey(5), jcfg)
    tokens = rng.integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    actions = rng.integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    with jax_dispatch.force("interpret"):
        lg, v, _ = jax_forward(jparams, jcfg, {"tokens": jnp.asarray(tokens)})
    logp = jax.nn.log_softmax(lg, -1)
    batch = {"tokens": tokens, "actions": actions,
             "behavior_logp": np.asarray(jnp.take_along_axis(logp, actions[..., None], -1)[..., 0]),
             "behavior_values": np.asarray(v, np.float32),
             "rewards": rng.normal(size=(B, T)).astype(np.float32),
             "bootstrap_value": rng.normal(size=(B,)).astype(np.float32),
             "discounts": _discounts(rng, B, T)}
    jopt, topt = jax_adamw(LR, clip_norm=1.0), adamw(LR, clip_norm=1.0)
    params = from_reference(jax.tree.map(np.asarray, jparams), "cpu")
    tstep, tstate = build_seq_train_step(tcfg, topt), topt.init(params)
    tb = {k: _t(x) for k, x in batch.items()}
    jb = jax.tree.map(jnp.asarray, batch)
    jstate = jopt.init(jparams)
    jm_all, tm_all = [], []
    with jax_dispatch.force("interpret"):
        jstep = jax_seq_step(jcfg, jopt, jit=True)
        for _ in range(3):
            jparams, jstate, jm = jstep(jparams, jstate, jb)
            params, tstate, tm = tstep(params, tstate, tb)
            jm_all.append({k: float(jm[k]) for k in ("loss", "ratio_mean")})
            tm_all.append({k: float(tm[k]) for k in ("loss", "ratio_mean")})
    # in `repro`: the ratio leaves 1 by 10^2 after one step, and the loss
    # ends above where it started (a check that the loss falls fails)
    assert jm_all[1]["ratio_mean"] > 100.0 and jm_all[-1]["loss"] > jm_all[0]["loss"]
    for i, (j, t) in enumerate(zip(jm_all, tm_all)):
        for k in j:
            np.testing.assert_allclose(t[k], j[k], rtol=1e-3, atol=TOL, err_msg=f"step {i} {k}")
