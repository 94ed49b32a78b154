"""The port's param plane against the JAX package's, on the CPU.

Manifests: `build_manifest` of a tree carried into the port
(`from_reference`) must equal `repro`'s on the same tree exactly: the same
leaf paths, the same per-leaf blake2b digests (fp32, int32, int64, bool
and 0-d leaves, in nested dicts and a list, inserted out of sorted order),
the same tree hash and byte count. `repro`'s `leaf_hash` raises on a bf16
leaf (numpy's buffer protocol refuses ml_dtypes' bfloat16), so a bf16 leaf
is held against `repro`'s recipe applied by hand: its dtype string `'<V2'`,
the shape's repr, and its bytes.

Pulls: the same push sequence goes into `repro.core.ModelPool` (numpy
leaves) and the port's (tensor leaves); `pull_if_changed` must give the same
answer types, changed paths, hash references and `pull_stats`, and
`apply_delta` and `CachedPuller` (cross-key adopts and lagging answers
included) must build the same trees.
"""
import hashlib

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import ModelKey as JaxKey
from repro.core import ModelPool as JaxPool
from repro.params import CachedPuller as JaxPuller
from repro.params import NotModified as JaxNotModified
from repro.params import apply_delta as jax_apply_delta
from repro.params import build_manifest as jax_build_manifest
from repro.params import leaf_hash as jax_leaf_hash
from repro_torch.core import ModelKey, ModelPool
from repro_torch.params import (CachedPuller, NotModified, ParamDelta, apply_delta,
                                build_manifest, from_reference, leaf_hash, to_reference)
from repro_torch.utils import tree_flatten_with_path


def _tree(seed=0, bf16=False):
    """Insertion order differs from sorted order at every level."""
    rng = np.random.default_rng(seed)
    up = rng.normal(size=(2, 4, 8)).astype(ml_dtypes.bfloat16 if bf16 else np.float32)
    return {
        "z_head": {"w": rng.normal(size=(4, 3)).astype(np.float32),
                   "b": rng.normal(size=(3,)).astype(np.float32)},
        "blocks": {"mlp": {"w_up": up},
                   "attn": {"wq": rng.normal(size=(2, 4, 4)).astype(np.float32),
                            "count": rng.integers(-9, 9, (2, 3)).astype(np.int32)}},
        "a_scale": np.float32(rng.normal()),
        "step": np.int64(7),
        "mask": rng.random((5,)) < 0.5,
        "stack": [rng.normal(size=(2,)).astype(np.float32),
                  rng.integers(0, 5, (3,)).astype(np.int32)],
    }


def _port(tree):
    """`from_reference`, keeping the bf16 leaf bf16 and the 0-d leaves 0-d."""
    return from_reference(tree, "cpu")


def _host(tree):
    """Comparable numpy leaves of either package's tree, by path."""
    flat, _ = tree_flatten_with_path(tree)
    out = {}
    for p, x in flat:
        if isinstance(x, torch.Tensor):
            x = x.float() if x.dtype == torch.bfloat16 else x
            x = x.numpy()
        x = np.asarray(x)
        out[p] = x.astype(np.float32) if x.dtype == ml_dtypes.bfloat16 else x
    return out


def _assert_same_tree(got, want):
    g, w = _host(got), _host(want)
    assert list(g) == list(w)
    for p in w:
        np.testing.assert_array_equal(g[p], w[p], err_msg=p)


def test_port_tree_keeps_dtypes():
    t = _port(_tree(bf16=True))
    assert t["blocks"]["mlp"]["w_up"].dtype == torch.bfloat16
    assert t["a_scale"].shape == () and t["step"].dtype == torch.int64
    assert t["mask"].dtype == torch.bool and isinstance(t["stack"], list)


@pytest.mark.parametrize("path", ["['a_scale']", "['blocks']['attn']['count']",
                                  "['blocks']['attn']['wq']", "['blocks']['mlp']['w_up']",
                                  "['mask']", "['stack'][0]", "['stack'][1]", "['step']",
                                  "['z_head']['b']", "['z_head']['w']"])
def test_leaf_hash_matches_jax(path):
    want = dict(tree_flatten_with_path(_tree())[0])[path]
    got = dict(tree_flatten_with_path(_port(_tree()))[0])[path]
    assert leaf_hash(got) == jax_leaf_hash(want)
    assert leaf_hash(np.asarray(want)) == jax_leaf_hash(want)    # numpy leaves too


def _bf16_recipe(a):
    """`repro.params.manifest.leaf_hash`'s recipe for a bf16 numpy leaf."""
    h = hashlib.blake2b(digest_size=16)
    h.update(a.dtype.str.encode())
    h.update(repr(a.shape).encode())
    h.update(a.view(np.uint16).tobytes())
    return h.hexdigest()


def test_bf16_leaf_hash_follows_the_recipe():
    a = _tree(bf16=True)["blocks"]["mlp"]["w_up"]
    assert a.dtype.str == "<V2"
    with pytest.raises(ValueError, match="buffer"):
        jax_leaf_hash(a)
    t = _port(_tree(bf16=True))["blocks"]["mlp"]["w_up"]
    assert leaf_hash(t) == leaf_hash(a) == _bf16_recipe(a)
    man = build_manifest(_port(_tree(bf16=True)), 0)
    want = dict(jax_build_manifest(_tree(), 0).leaf_hashes)
    want["['blocks']['mlp']['w_up']"] = _bf16_recipe(a)
    assert man.leaf_hashes == want


def test_manifest_matches_jax():
    tree = _tree()
    want = jax_build_manifest(tree, 3)
    got = build_manifest(_port(tree), 3)
    assert got.leaf_hashes == want.leaf_hashes
    assert list(got.leaf_hashes) == list(want.leaf_hashes)
    assert (got.tree_hash, got.nbytes, got.version) == (want.tree_hash, want.nbytes, 3)
    other = build_manifest(_port(_tree(1)), 4)
    assert got.changed_paths(other) == want.changed_paths(jax_build_manifest(_tree(1), 4))


def _answer(r):
    """A pull answer reduced to what both packages must agree on."""
    if isinstance(r, (NotModified, JaxNotModified)):
        return ("noop", r.version)
    return ("full" if r.full else "delta", r.manifest.version, r.manifest.tree_hash,
            sorted(r.leaves or {}), r.by_hash)


def _changed(tree, seed):
    """`tree` with two leaves replaced."""
    rng = np.random.default_rng(seed)
    out = {**tree, "z_head": {**tree["z_head"], "b": rng.normal(size=(3,)).astype(np.float32)}}
    out["mask"] = ~tree["mask"]
    return out


def _pull_script(pool, key_cls, to):
    """One push and pull sequence; returns the answers and the pool's stats."""
    k0, k1 = key_cls("main", 0), key_cls("exploiter", 0)
    t0, t1 = _tree(), _changed(_tree(), 5)
    answers = []
    pool.push(k0, to(t0))
    answers.append(pool.pull_if_changed(k0, None))             # full
    answers.append(pool.pull_if_changed(k0, 0))                # noop
    pool.push(k0, to(t1))
    answers.append(pool.pull_if_changed(k0, 0))                # delta: two leaves
    pool.push(k0, to(t1))
    answers.append(pool.pull_if_changed(k0, 1))                # delta: nothing changed
    answers.append(pool.pull_if_changed(k0, 99))               # unknown version: full
    held = set(answers[0].manifest.leaf_hashes.values())
    pool.push(k1, to(t0))
    answers.append(pool.pull_if_changed(k1, None, have_hashes=held))      # all by hash
    pool.push(k1, to(t1))
    answers.append(pool.pull_if_changed(k1, None, have_hashes=held))      # partly by hash
    answers.append(pool.pull_if_changed(k1, None, have_hashes={"nope"}))  # full
    pool.freeze(k0)
    answers.append(pool.pull_if_changed(k0, pool.version(k0)))            # frozen: noop
    return answers, dict(pool.pull_stats)


def test_pull_if_changed_matches_jax():
    want, want_stats = _pull_script(JaxPool(), JaxKey, lambda t: t)
    got, got_stats = _pull_script(ModelPool(), ModelKey, _port)
    assert [_answer(r) for r in got] == [_answer(r) for r in want]
    assert got_stats == want_stats
    assert isinstance(got[2], ParamDelta) and len(got[2].leaves) == 2
    assert got[5].leaves == {} and len(got[5].by_hash) == len(got[0].manifest.leaf_hashes)
    for g, w in zip(got, want):
        if not isinstance(g, NotModified) and g.full:
            _assert_same_tree(g.params, w.params)
        elif not isinstance(g, NotModified):
            _assert_same_tree(g.leaves, w.leaves)


def test_apply_delta_matches_jax():
    base, new = _tree(), _changed(_tree(), 6)
    jd = JaxPool()
    jd.push("k", base)
    jd.push("k", new)
    man0 = jax_build_manifest(base, 0)
    delta = {p: dict(tree_flatten_with_path(new)[0])[p]
             for p in jax_build_manifest(new, 1).changed_paths(man0)}
    want = jax_apply_delta(base, delta)
    tbase = _port(base)
    got = apply_delta(tbase, {p: torch.as_tensor(np.asarray(v)) for p, v in delta.items()})
    _assert_same_tree(got, want)
    assert got["blocks"]["attn"]["wq"] is tbase["blocks"]["attn"]["wq"]    # shared, not copied
    _assert_same_tree(tbase, base)                                        # base untouched
    with pytest.raises(KeyError, match="absent"):
        apply_delta(tbase, {"['nope']": torch.zeros(1)})


def _puller_script(pool, puller, key_cls, to):
    """Warm a puller on the seed, follow a changed push, then adopt the same
    content under a fresh key (zero bytes); returns (trees, manifests)."""
    k0, k1 = key_cls("exploiter", 0), key_cls("exploiter", 1)
    out = []
    pool.push(k0, to(_tree()))
    out.append(puller.get_with_manifest(k0))
    out.append(puller.get_with_manifest(k0))                 # NotModified
    pool.push(k0, to(_changed(_tree(), 7)))
    out.append(puller.get_with_manifest(k0))                 # delta
    pool.push(k1, to(_changed(_tree(), 7)))                   # reset onto held content
    out.append(puller.get_with_manifest(k1))                 # cross-key, by hash
    puller.drop(k0)
    return out


def test_cached_puller_matches_jax():
    jp, tp = JaxPool(), ModelPool()
    want = _puller_script(jp, JaxPuller(jp), JaxKey, lambda t: t)
    got = _puller_script(tp, CachedPuller(tp), ModelKey, _port)
    assert [m.tree_hash for _, m in got] == [m.tree_hash for _, m in want]
    assert [m.version for _, m in got] == [m.version for _, m in want]
    for (g, _), (w, _) in zip(got, want):
        _assert_same_tree(g, w)
    assert got[1][0] is got[0][0]                            # NotModified: same object
    assert tp.pull_stats == jp.pull_stats and tp.pull_stats["cross_key"] == 1
    # the cross-key adopt aliases the cached leaves instead of copying them
    assert got[3][0]["z_head"]["b"] is got[2][0]["z_head"]["b"]


def test_cached_puller_ignores_lagging_answers_like_jax():
    """A pool that answers the second pull from a replica stuck at version
    0: the newer cached tree wins and `stale_answers` counts it."""
    def run(pool_cls, key_cls, puller_cls, to):
        key = key_cls("m", 0)
        fresh, stale = pool_cls(), pool_cls()
        fresh.push(key, to(_tree()))
        fresh.push(key, to(_changed(_tree(), 8)))
        stale.push(key, to(_tree()))

        class Lagging:
            calls = 0

            def pull_if_changed(self, k, have_version=None, copy=None, have_hashes=None):
                Lagging.calls += 1
                return (fresh if Lagging.calls == 1 else stale).pull_if_changed(k, None)

        puller = puller_cls(Lagging())
        first = puller.get_with_manifest(key)
        second = puller.get_with_manifest(key)
        return first, second, puller.stale_answers

    jf, js, jn = run(JaxPool, JaxKey, JaxPuller, lambda t: t)
    tf, ts, tn = run(ModelPool, ModelKey, CachedPuller, _port)
    assert tn == jn == 1
    assert ts[1].version == js[1].version == tf[1].version
    assert ts[0] is tf[0]
    _assert_same_tree(ts[0], js[0])


def test_snapshot_on_pull_copies_tensor_leaves():
    pool = ModelPool(snapshot_on_pull=True)
    t = _port(_tree())
    pool.push("k", t)
    got = pool.pull("k")
    assert got["z_head"]["w"] is not t["z_head"]["w"]
    assert got["z_head"]["w"].data_ptr() != t["z_head"]["w"].data_ptr()
    _assert_same_tree(to_reference({"w": got["z_head"]["w"]}), {"w": _tree()["z_head"]["w"]})


@pytest.mark.parametrize("helper", ["tree_count_params", "tree_bytes", "tree_copy",
                                    "tree_zeros_like", "tree_cast", "tree_add", "tree_scale",
                                    "tree_lerp"])
def test_tree_helpers_match_jax(helper):
    """`repro_torch.utils.pytree`'s helpers against `repro.utils.pytree`'s
    on the same fp32 / int32 tree (leaves compared by path)."""
    import jax.numpy as jnp

    import repro.utils.pytree as jax_pytree
    import repro_torch.utils.pytree as pytree

    rng = np.random.default_rng(9)
    tree = {"b": {"w": rng.normal(size=(3, 4)).astype(np.float32),
                  "n": rng.integers(0, 9, (5,)).astype(np.int32)},
            "a": rng.normal(size=(2,)).astype(np.float32)}
    other = {"b": {"w": rng.normal(size=(3, 4)).astype(np.float32),
                   "n": rng.integers(0, 9, (5,)).astype(np.int32)},
             "a": rng.normal(size=(2,)).astype(np.float32)}
    jt, jo = (jax.tree.map(jnp.asarray, t) for t in (tree, other))
    tt, to = _port(tree), _port(other)
    args = {"tree_count_params": ((jt,), (tt,)), "tree_bytes": ((jt,), (tt,)),
            "tree_copy": ((jt,), (tt,)), "tree_zeros_like": ((jt,), (tt,)),
            "tree_cast": ((jt, jnp.bfloat16), (tt, torch.bfloat16)),
            "tree_add": ((jt, jo), (tt, to)), "tree_scale": ((jt, 0.5), (tt, 0.5)),
            "tree_lerp": ((jt, jo, 0.25), (tt, to, 0.25))}[helper]
    want = getattr(jax_pytree, helper)(*args[0])
    got = getattr(pytree, helper)(*args[1])
    if isinstance(want, int):
        assert got == want
        return
    _assert_same_tree(got, jax.tree.map(np.asarray, want))
    g, w = tree_flatten_with_path(got)[0], tree_flatten_with_path(want)[0]
    assert [str(x.dtype).replace("torch.", "") for _, x in g] == [str(x.dtype) for _, x in w]
    if helper == "tree_copy":
        assert got["a"] is not tt["a"] and got["a"].data_ptr() != tt["a"].data_ptr()
