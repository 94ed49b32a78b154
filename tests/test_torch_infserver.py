"""The port's InfServer against the JAX package's, on the CPU.

Same params (carried over with `repro_torch.params.convert`) and same
observations. Values must match the JAX policy's; the port's logp must equal
JAX `categorical_logp(JAX logits, the port's action)`; sampled actions are
never compared (the two RNG streams differ). The registry and ticket
protocol (hash-gated swaps, stale drops, dead-owner expiry) is driven
through the same script on both servers and must count the same.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.actors.policy import make_obs_policy as jax_policy
from repro.configs import get_arch as jax_arch
from repro.infserver import InfServer as JaxInfServer
from repro.models import init_params as jax_init
from repro.rl.distributions import categorical_logp
from repro_torch.configs import get_arch
from repro_torch.infserver import InfServer
from repro_torch.kernels import dispatch
from repro_torch.params import from_reference

A = 6
L_OBS = 26


def _setup(compute="float32"):
    jcfg = dataclasses.replace(jax_arch("tleague-policy-s"), compute_dtype=compute)
    tcfg = dataclasses.replace(get_arch("tleague-policy-s"), compute_dtype=compute)
    theta, phi = (jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(s), jcfg))
                  for s in (0, 1))
    return jcfg, tcfg, theta, phi


def _obs(rng, n):
    return rng.integers(0, 512, (n, L_OBS)).astype(np.int32)


def _check_against_jax(jcfg, params, obs, result, atol):
    a, logp, v = result
    jl, jv = jax_policy(jcfg, A).logits_values(params, jnp.asarray(obs))
    assert a.dtype == np.int32 and ((a >= 0) & (a < A)).all()
    np.testing.assert_allclose(v, np.asarray(jv), atol=atol, rtol=0)
    np.testing.assert_allclose(logp, np.asarray(categorical_logp(jl, jnp.asarray(a))),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("compute,atol", [("float32", 1e-4), ("bfloat16", 5e-2)])
def test_single_flush_matches_jax(compute, atol):
    jcfg, tcfg, theta, _ = _setup(compute)
    server = InfServer(tcfg, A, from_reference(theta, "cpu"), device="cpu", max_batch=64)
    rng = np.random.default_rng(0)
    obs = [_obs(rng, n) for n in (5, 7, 4)]             # 16 rows: one bucket, no pad
    tickets = [server.submit(o) for o in obs]
    assert not any(t.done() for t in tickets)
    server.flush()
    assert all(t.done() for t in tickets) and server.last_batch_models == 1
    for o, t in zip(obs, tickets):
        _check_against_jax(jcfg, theta, o, t.result(), atol)
    st = server.stats()
    assert st["rows_served"] == 16 and st["occupancy"] == 1.0
    assert st["sharded"] is False and st["mesh_shape"] is None
    assert st["dispatch"].get("attention|reference", 0) >= tcfg.num_layers


def test_grouped_flush_matches_jax_per_model():
    jcfg, tcfg, theta, phi = _setup()
    server = InfServer(tcfg, A, from_reference(theta, "cpu"), device="cpu", max_batch=64)
    server.register_model("phi", from_reference(phi, "cpu"))
    rng = np.random.default_rng(1)
    obs_t, obs_p = _obs(rng, 5), _obs(rng, 3)            # padded to a shared bucket of 8
    tt = server.submit(obs_t)
    tp = server.submit(obs_p, model="phi")
    server.flush()
    assert server.last_batch_models == 2
    assert server.rows_padded == 16 and server.rows_served == 8
    _check_against_jax(jcfg, theta, obs_t, server.get(tt), 1e-4)
    _check_against_jax(jcfg, phi, obs_p, server.get(tp), 1e-4)


def test_full_queue_flushes_and_get_self_flushes():
    _, tcfg, theta, _ = _setup()
    server = InfServer(tcfg, A, from_reference(theta, "cpu"), device="cpu", max_batch=8)
    rng = np.random.default_rng(2)
    t1 = server.submit(_obs(rng, 4))
    assert server.queue_depth == 4 and server.batches_run == 0
    t2 = server.submit(_obs(rng, 4))                     # fills max_batch: flushes
    assert server.batches_run == 1 and t1.done() and t2.done()
    t3 = server.submit(_obs(rng, 2))
    assert server.get(t3)[0].shape == (2,)               # unresolved get flushes
    server.get(t1)
    with pytest.raises(KeyError):
        server.get(t1)                                   # results pop on read
    with pytest.raises(KeyError):
        server.submit(_obs(rng, 1), model="nobody")


def _protocol_script(server, params_a, params_b, obs):
    """Registry and ticket protocol calls, identical for both servers."""
    server.register_model("phi", params_b, content_hash="h-phi", version=3)
    server.register_model("phi", params_b, content_hash="h-phi", version=3)   # no-op
    server.register_model("phi", params_a, content_hash="h-old", version=2)   # stale
    server.update_params(params_a, content_hash="h-theta", version=1)
    server.update_params(params_a, content_hash="h-theta", version=1)        # no-op
    server.ensure_model("phi", params_a)                                     # kept
    probes = [server.has_model("phi", "h-phi"), server.has_model("phi", "h-x"),
              server.has_model("nobody")]
    dead = server.submit(obs)                   # its owner never collects it
    kept = server.submit(obs, model="phi")
    server.flush()
    dropped = server.submit(obs)
    server.discard(dropped)                     # queued, then forgotten
    blocked = server.submit(obs, model="phi")
    evict_refused = server.evict_model("phi")   # phi still has queued rows
    for _ in range(2):
        server.get(server.submit(obs))          # flushes 2 and 3
    server.get(kept)                            # within the TTL window: still held
    server.get(blocked)
    server.get(server.submit(obs))              # flush 4: `dead` outlived the TTL
    try:
        server.get(dead)
        expired = False
    except KeyError:
        expired = True
    evicted = server.evict_model("phi")
    st = server.stats()
    keys = ("swaps", "swap_noops", "swap_stale_drops", "tickets_expired",
            "results_held", "batches_run", "requests_served", "models_hosted",
            "queue_depth")
    return probes, evict_refused, evicted, expired, {k: st[k] for k in keys}


def test_registry_and_ticket_protocol_match_jax():
    jcfg, tcfg, theta, phi = _setup()
    obs = _obs(np.random.default_rng(3), 2)
    jserver = JaxInfServer(jcfg, A, theta, max_batch=64, ticket_ttl_flushes=3)
    tserver = InfServer(tcfg, A, from_reference(theta, "cpu"), device="cpu",
                        max_batch=64, ticket_ttl_flushes=3)
    ref = _protocol_script(jserver, theta, phi, obs)
    got = _protocol_script(tserver, from_reference(theta, "cpu"),
                           from_reference(phi, "cpu"), obs)
    assert got == ref
    assert got[:4] == ([True, False, False], False, True, True)
    assert got[4]["tickets_expired"] == 1 and got[4]["swap_noops"] == 2
    # the port adds the queue-wait counters, which `repro` has not
    assert set(tserver.stats()) == set(jserver.stats()) | {"mean_queue_wait_ms",
                                                           "max_queue_wait_ms"}
    assert set(tserver.telemetry()) == set(jserver.telemetry()) | {"mean_queue_wait_ms"}


def test_hot_swap_changes_values_and_keeps_stacks_fresh():
    _, tcfg, theta, phi = _setup()
    server = InfServer(tcfg, A, from_reference(theta, "cpu"), device="cpu", max_batch=64)
    server.register_model("phi", from_reference(phi, "cpu"))
    obs = _obs(np.random.default_rng(4), 3)

    def grouped_values():
        tt, tp = server.submit(obs), server.submit(obs, model="phi")
        server.flush()
        return server.get(tt)[2], server.get(tp)[2]

    v_theta, v_phi = grouped_values()
    assert len(server._stack_cache) == 1
    server.update_params(from_reference(phi, "cpu"))      # theta now holds phi's weights
    assert len(server._stack_cache) == 0                  # stale stack dropped
    w_theta, w_phi = grouped_values()
    np.testing.assert_allclose(w_theta, v_phi, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(w_phi, v_phi)
    assert np.abs(w_theta - v_theta).max() > 0


def test_stats_report_infer_mode_and_bf16_scope(monkeypatch):
    _, tcfg, theta, _ = _setup()
    monkeypatch.setenv("REPRO_KERNELS_INFER", "bf16")
    server = InfServer(tcfg, A, from_reference(theta, "cpu"), device="cpu")
    dispatch.stats(reset=True)
    server.get(server.submit(_obs(np.random.default_rng(5), 2)))
    st = server.stats()
    assert st["infer_mode"] == "bf16"
    assert st["dispatch"].get("attention|reference|bf16", 0) == tcfg.num_layers
