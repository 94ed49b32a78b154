"""The port's dry-run (`repro_torch.launch.dryrun`) on the CPU, with no device.

- `run_one` gives `ok` or `skip` for each of the 40 (arch, shape) pairs as
  `repro`'s `step_kind` says (38 ok, 2 skip: hubert has no decode step),
  and no record allocates a tensor off the meta device.
- The 1-and-2-unit extrapolation of `measured.global_flops` equals a
  direct count at 3 units, for a smoke config of each kind of step;
  `not_measured` names only what has no counterpart in the port (the
  per-device counts are in `tests/test_torch_dryrun_counts.py`).
- The CLI writes one record per pair into `--out`.
"""
import dataclasses
import json
import traceback

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro.configs import get_arch as jax_arch
from repro.configs.base import INPUT_SHAPES as JAX_SHAPES
from repro.launch.dryrun import ASSIGNED
from repro.launch.specs import step_kind
from repro_torch.configs import get_arch
from repro_torch.configs.base import INPUT_SHAPES, InputShape
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh

SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


class OffMeta(TorchDispatchMode):
    """Records every op whose output lies off the meta device, apart from
    the fake tensors of DTensor's shape inference (which hold no data) and
    the counting mesh's rank table (`make_counting_mesh`)."""

    def __init__(self):
        super().__init__()
        self.off = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if (isinstance(t, torch.Tensor) and not isinstance(t, FakeTensor)
                    and t.device.type != "meta" and not _in_counting_mesh()):
                self.off.append((str(func), tuple(t.shape), str(t.device)))
        return out


def _in_counting_mesh() -> bool:
    return any(f.name == "make_counting_mesh" for f in traceback.extract_stack())


@pytest.mark.parametrize("arch,shape_name", [(a, s) for a in ASSIGNED for s in SHAPES])
def test_run_one_ok_or_skip_on_meta_only(arch, shape_name):
    want = "skip" if step_kind(jax_arch(arch), JAX_SHAPES[shape_name]) == "skip" else "ok"
    guard = OffMeta()
    with guard:
        rec = dryrun.run_one(arch, shape_name, measure=False, verbose=False)
    assert rec["status"] == want, rec.get("error")
    assert guard.off == []
    if want == "ok":
        mem = rec["memory"]
        assert mem["argument_size_in_bytes"] > 0 and mem["output_size_in_bytes"] > 0
        assert set(rec["not_measured"]) == {
            "memory.generated_code_size_in_bytes", "hlo_lines", "lower_s", "compile_s",
            "memory.temp_size_in_bytes", "cost", "collectives"}
        assert all(isinstance(v, str) and v for v in rec["not_measured"].values())
        assert "measured" not in rec
        for k in ("arch", "shape", "mesh", "chips", "fsdp", "shard_cache_len", "remat",
                  "moe_ep", "params", "active_params", "kind"):
            assert k in rec


def test_forty_pairs_are_38_ok_and_2_skip():
    kinds = [step_kind(jax_arch(a), JAX_SHAPES[s]) for a in ASSIGNED for s in SHAPES]
    assert len(kinds) == 40 and kinds.count("skip") == 2


@pytest.fixture
def tiny_shapes(monkeypatch):
    for name, shape in (("tiny_train", InputShape("tiny_train", 32, 2, "train")),
                        ("tiny_prefill", InputShape("tiny_prefill", 32, 2, "prefill")),
                        ("tiny_decode", InputShape("tiny_decode", 32, 2, "decode"))):
        monkeypatch.setitem(INPUT_SHAPES, name, shape)


@pytest.mark.parametrize("arch", ["qwen3-8b", "qwen3-moe-235b-a22b", "rwkv6-3b",
                                  "hymba-1.5b", "kimi-k2-1t-a32b"])
@pytest.mark.parametrize("shape_name", ["tiny_train", "tiny_prefill", "tiny_decode"])
def test_flops_extrapolation_equals_direct_count(arch, shape_name, tiny_shapes):
    cfg = dryrun.at_units(get_arch(arch).smoke(), 3)
    mesh = make_production_mesh()
    guard = OffMeta()
    with guard:
        got = dryrun._measure_shallow(cfg, shape_name, (1, 1))
        direct = dryrun.count(cfg, shape_name, mesh)["flops"]
    assert guard.off == []
    assert got["units"] == 3 and got["per_unit_global_flops"] > 0
    assert got["global_flops"] == pytest.approx(direct, rel=1e-12)


def test_cli_writes_a_record_per_pair(tmp_path, capsys):
    dryrun.main(["--arch", "gemma2-2b", "--no-measure", "--out", str(tmp_path)])
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == sorted(f"gemma2-2b_{s}_16x16.json" for s in INPUT_SHAPES
                           if s in SHAPES)
    recs = [json.loads((tmp_path / f).read_text()) for f in files]
    assert all(r["status"] == "ok" for r in recs)
    assert "4 ok, 0 skip, 0 fail / 4 pairs" in capsys.readouterr().out


def test_kimi_train_bytes_per_device_on_the_production_mesh():
    """kimi-k2's train step on (16, 16): its per-device arguments (bf16
    params, adamw's fp32 master copy and moments, the batch) are at least
    14 bytes a param spread over the 256 devices."""
    from repro_torch.launch.specs import param_shapes

    rec = dryrun.run_one("kimi-k2-1t-a32b", "train_4k", measure=False, verbose=False)
    cfg = get_arch("kimi-k2-1t-a32b")
    assert rec["params"] == cfg.param_count() > 10 ** 12
    n = sum(t.numel() for t in tree_leaves(param_shapes(cfg)))
    per_dev = rec["memory"]["argument_size_in_bytes"]
    # 2 bytes of bf16 params + 12 of fp32 master and moments per param,
    # spread over at most 256 devices
    assert per_dev >= 14 * n / 256


def test_at_units_keeps_the_dense_prefix():
    cfg = get_arch("kimi-k2-1t-a32b")
    u, fkd, r = dryrun.units(cfg)
    assert fkd == cfg.moe.first_k_dense and r == (cfg.num_layers - fkd) // u
    assert dryrun.at_units(cfg, 2).num_layers == fkd + 2 * u
    assert dataclasses.replace(cfg, num_layers=cfg.num_layers) == cfg
