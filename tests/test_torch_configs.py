"""The port's architecture registry against the JAX package's: the same
names (and the port's own entries, `PORT_ONLY`), every field of every
config and of its `smoke()` variant (the fields only the port has at their
defaults, which keep the JAX package's behaviour), the same input shapes; `init_params` gives `repro`'s tree (keys, shapes, dtypes) for
the moe, ssm, hybrid, vlm and audio archs (hubert also at head dim 80, its
published one)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import INPUT_SHAPES as JAX_INPUT_SHAPES
from repro.configs import get_arch as jax_arch
from repro.configs import list_archs as jax_list_archs
from repro.models import init_params as jax_init
from repro_torch.configs import INPUT_SHAPES, PORT_ONLY, ArchConfig, get_arch, list_archs
from repro_torch.models import init_params
from repro_torch.utils import tree_flatten_with_path

FAMILIES = ["pixtral-12b", "rwkv6-3b", "kimi-k2-1t-a32b", "qwen3-moe-235b-a22b", "hymba-1.5b"]


def test_registry_names_match_repro():
    assert [n for n in list_archs() if n not in PORT_ONLY] == jax_list_archs()
    assert set(PORT_ONLY) <= set(list_archs())


# the fields the port's ArchConfig has beyond the JAX package's, at their defaults
PORT_FIELDS = {f.name: f.default for f in dataclasses.fields(ArchConfig)
               if f.name in ("mla", "rope_scaling", "router", "d_ff_shared")}


@pytest.mark.parametrize("arch", jax_list_archs())
def test_config_and_smoke_match_repro(arch):
    for ours, theirs in ((get_arch(arch), jax_arch(arch)),
                         (get_arch(arch).smoke(), jax_arch(arch).smoke())):
        mine = dataclasses.asdict(ours)
        assert {k: mine.pop(k) for k in PORT_FIELDS} == PORT_FIELDS
        assert mine == dataclasses.asdict(theirs)
        assert (ours.q_dim, ours.kv_dim, ours.param_count(), ours.active_param_count()) == (
            theirs.q_dim, theirs.kv_dim, theirs.param_count(), theirs.active_param_count())


def test_input_shapes_match_repro():
    assert {k: dataclasses.asdict(v) for k, v in INPUT_SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in JAX_INPUT_SHAPES.items()}


def _tree_matches(jcfg, tcfg):
    want = jax.eval_shape(lambda: jax_init(jax.random.PRNGKey(0), jcfg))
    got = init_params(torch.Generator().manual_seed(0), tcfg)
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [(jax.tree_util.keystr(p), tuple(a.shape), str(np.dtype(a.dtype))) for p, a in flat] \
        == [(p, tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for p, t in tree_flatten_with_path(got)[0]]


@pytest.mark.parametrize("head_dim", [None, 80])
def test_audio_init_params_tree_matches_repro(head_dim):
    """hubert's tree (the audio family, once refused here) against
    `repro`'s at `smoke()`, and with its published head dim of 80."""
    kw = {"head_dim": head_dim} if head_dim else {}
    _tree_matches(dataclasses.replace(jax_arch("hubert-xlarge").smoke(), **kw),
                  dataclasses.replace(get_arch("hubert-xlarge").smoke(), **kw))


@pytest.mark.parametrize("arch", FAMILIES)
def test_init_params_tree_matches_repro(arch):
    """Same paths, shapes and dtypes as `repro`'s init at `smoke()`
    (kimi-k2's `dense_prefix` stack included); the numbers differ."""
    _tree_matches(jax_arch(arch).smoke(), get_arch(arch).smoke())
