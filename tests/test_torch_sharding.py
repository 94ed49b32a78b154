"""The port's sharding rules and input specs against `repro`'s, with no device.

`repro`'s side is built on `jax.sharding.AbstractMesh` exactly as
`tests/test_sharding.py` builds it; the port's on its own `AbstractMesh`
(`launch/mesh.make_production_mesh`). Specs are matched leaf by leaf by
path string (JAX flattens dicts in sorted key order, so lists are never
compared by position). Covered, for the ten assigned archs:
  - param specs on (16, 16) and (2, 16, 16), FSDP on and off;
  - batch specs, and decode-state specs with and without
    `shard_cache_len`, over the four input shapes (hubert's decode shapes
    are not built, as `repro` has no decode step for them);
  - the serving, stacked and observation specs at rows 1, 6, 64 and 256;
  - input specs' shapes and dtypes for all 40 (arch, shape) pairs;
  - the dry-run's per-device argument bytes against the sum of
    `NamedSharding.shard_shape` x itemsize, exactly.
"""
import functools

import jax
import numpy as np
import pytest

from repro.configs import get_arch as jax_arch
from repro.distributed import sharding as JSH
from repro.launch import specs as JSP
from repro.launch.dryrun import ASSIGNED
from repro.launch.steps import make_optimizer as jax_optimizer
from repro.models import init_params as jax_init
from repro_torch.configs import get_arch
from repro_torch.distributed import sharding as SH
from repro_torch.launch import specs as SP
from repro_torch.launch.dryrun import ASSIGNED as PORT_ASSIGNED, run_one
from repro_torch.launch.mesh import make_production_mesh

SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def fake_mesh(shape, axes):
    """AbstractMesh, as `tests/test_sharding.py` builds it."""
    try:
        return jax.sharding.AbstractMesh(tuple(zip(axes, shape)))
    except TypeError:
        return jax.sharding.AbstractMesh(shape, axes)


def _meshes(name):
    shape, axes = MESHES[name]
    return fake_mesh(shape, axes), make_production_mesh(multi_pod=len(shape) == 3)


@functools.lru_cache(maxsize=None)
def _jax_param_shapes(arch):
    return jax.eval_shape(functools.partial(jax_init, cfg=jax_arch(arch)),
                          jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _port_param_shapes(arch):
    return SP.param_shapes(get_arch(arch))


def _jpath(path):
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)


def _jax_specs(shardings):
    """{path string: spec tuple} of a tree of NamedShardings (or one)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        shardings, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
    return {_jpath(p): tuple(ns.spec) for p, ns in flat}


def _port_specs(specs):
    return SH.spec_items(specs)


def _pad(spec, n):
    """A JAX spec of fewer entries than dims means None for the rest."""
    return tuple(spec) + (None,) * (n - len(spec))


def _assert_same(jspecs, tspecs, shapes):
    assert set(jspecs) == set(tspecs)
    for k, leaf in shapes.items():
        assert _pad(jspecs[k], len(leaf)) == _pad(tspecs[k], len(leaf)), k


def _jax_shapes(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {_jpath(p): tuple(leaf.shape) for p, leaf in flat}


def test_assigned_archs_are_repros():
    assert PORT_ASSIGNED == ASSIGNED


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED)
def test_param_specs_match_repro(arch, mesh_name, fsdp):
    jm, tm = _meshes(mesh_name)
    js, ts = _jax_param_shapes(arch), _port_param_shapes(arch)
    jspecs = _jax_specs(JSH.param_shardings(js, jax_arch(arch), jm, fsdp=fsdp))
    tspecs = _port_specs(SH.param_shardings(ts, get_arch(arch), tm, fsdp=fsdp))
    _assert_same(jspecs, tspecs, _jax_shapes(js))
    assert any(any(e is not None for e in s) for s in tspecs.values())


_INPUT_CASES = [(a, s) for a in ASSIGNED for s in SHAPES
                if not (a == "hubert-xlarge" and s in ("decode_32k", "long_500k"))]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch,shape_name", _INPUT_CASES)
def test_batch_and_state_specs_match_repro(arch, shape_name, mesh_name):
    jm, tm = _meshes(mesh_name)
    jcfg, tcfg = jax_arch(arch), get_arch(arch)
    jkind, jsp = JSP.input_specs(jcfg, shape_name)
    tkind, tsp = SP.input_specs(tcfg, shape_name)
    assert jkind == tkind != "skip"
    if jkind != "decode":
        _assert_same(_jax_specs(JSH.batch_shardings(jsp, jm)),
                     _port_specs(SH.batch_shardings(tsp, tm)), _jax_shapes(jsp))
        return
    _assert_same(_jax_specs(JSH.batch_shardings(jsp["tokens"], jm)),
                 _port_specs(SH.batch_shardings(tsp["tokens"], tm)),
                 _jax_shapes(jsp["tokens"]))
    for scl in (False, True):
        _assert_same(
            _jax_specs(JSH.state_shardings(jsp["state"], jcfg, jm, shard_cache_len=scl)),
            _port_specs(SH.state_shardings(tsp["state"], tcfg, tm, shard_cache_len=scl)),
            _jax_shapes(jsp["state"]))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED)
def test_serving_stacked_and_obs_specs_match_repro(arch, mesh_name):
    jm, tm = _meshes(mesh_name)
    js, ts = _jax_param_shapes(arch), _port_param_shapes(arch)
    jserve = JSH.serving_param_shardings(js, jax_arch(arch), jm)
    tserve = SH.serving_param_shardings(ts, get_arch(arch), tm)
    _assert_same(_jax_specs(jserve), _port_specs(tserve), _jax_shapes(js))
    jstack = _jax_specs(JSH.stacked_param_shardings(jserve, jm))
    tstack = _port_specs(SH.stacked_param_shardings(tserve, tm))
    _assert_same(jstack, tstack, {k: (1,) + v for k, v in _jax_shapes(js).items()})
    for rows in (1, 6, 64, 256):
        assert _pad(JSH.obs_batch_sharding(jm, rows).spec, 1) == \
            SH.obs_batch_sharding(tm, rows)
        assert _pad(JSH.grouped_obs_sharding(jm, rows).spec, 2) == \
            SH.grouped_obs_sharding(tm, rows)


@pytest.mark.parametrize("arch,shape_name", [(a, s) for a in ASSIGNED for s in SHAPES])
def test_input_specs_match_repro(arch, shape_name):
    jkind, jsp = JSP.input_specs(jax_arch(arch), shape_name)
    tkind, tsp = SP.input_specs(get_arch(arch), shape_name)
    assert jkind == tkind
    if jkind == "skip":
        assert jsp is None and tsp is None
        return
    jflat, _ = jax.tree_util.tree_flatten_with_path(jsp)
    jl = {_jpath(p): (tuple(x.shape), np.dtype(x.dtype).name) for p, x in jflat}
    tl = {SH.path_str(p): (tuple(x.shape), str(x.dtype).removeprefix("torch."))
          for p, x in SH.leaves_with_path(tsp)}
    assert jl == tl
    assert all(x.device.type == "meta" for _, x in SH.leaves_with_path(tsp))


def _jax_shard_bytes(tree, shardings):
    """Sum over leaves of NamedSharding.shard_shape x itemsize."""
    leaves = jax.tree.leaves(tree)
    nss = jax.tree.leaves(shardings,
                          is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
    assert len(leaves) == len(nss)
    return sum(int(np.prod(ns.shard_shape(x.shape))) * np.dtype(x.dtype).itemsize
               for x, ns in zip(leaves, nss))


@pytest.mark.parametrize("arch,shape_name", _INPUT_CASES)
def test_argument_bytes_per_device_match_repro(arch, shape_name):
    """The dry-run's per-device argument bytes on (16, 16), FSDP on, equal
    `repro`'s shard shapes summed, exactly."""
    jm = fake_mesh(*MESHES["16x16"])
    jcfg = jax_arch(arch)
    js = _jax_param_shapes(arch)
    pshard = JSH.param_shardings(js, jcfg, jm, fsdp=True)
    kind, sp = JSP.input_specs(jcfg, shape_name)
    want = _jax_shard_bytes(js, pshard)
    if kind in ("train", "mlm_train"):
        opt = jax.eval_shape(jax_optimizer(jcfg).init, js)
        for k, v in opt.items():
            want += (_jax_shard_bytes(v, pshard) if k != "step"
                     else int(np.dtype(v.dtype).itemsize))
        want += _jax_shard_bytes(sp, JSH.batch_shardings(sp, jm))
    elif kind == "prefill":
        want += _jax_shard_bytes(sp, JSH.batch_shardings(sp, jm))
    else:
        want += _jax_shard_bytes(sp["tokens"], JSH.batch_shardings(sp["tokens"], jm))
        want += _jax_shard_bytes(sp["state"], JSH.state_shardings(sp["state"], jcfg, jm))
    rec = run_one(arch, shape_name, measure=False, verbose=False)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["memory"]["argument_size_in_bytes"] == want
