"""The port's dry-run counts (`repro_torch.launch.dryrun._measure_shallow`)
beside `repro`'s (`repro.launch.dryrun._measure_shallow`, XLA's cost
analysis and the collectives of the compiled HLO) for the same smoke
config, tiny shape and (2, 2) mesh: `repro` compiles on 4 forced host
devices in a process of its own, the port counts rank 0 of a counting
mesh. The keys are `repro`'s; the conventions behind them differ, and
each test names the gap:

- flops: XLA counts every op's work and the port matmuls, convolutions
  and its kernels' `cost.py` work, so the port's count is at most
  `repro`'s; MoE archs fall to about a third, since `repro` dispatches
  tokens to experts by one-hot einsums, which XLA counts as matmuls, and
  the port by gathers;
- collective bytes: the same operand convention, but a different plan.
  The port gathers each unit's FSDP weights and reduce-scatters their
  grads, eagerly and uncombined, where XLA's partitioner may all-reduce
  activations or grads, reshard with all-to-all and collective-permute,
  and combines ops; both move data by all-gather and all-reduce.
"""
import json
import os
import subprocess
import sys

import pytest

from repro_torch.configs import get_arch
from repro_torch.configs.base import INPUT_SHAPES, InputShape
from repro_torch.launch import dryrun

SHAPES = {"tiny_train": ("tiny_train", 32, 4, "train"),
          "tiny_decode": ("tiny_decode", 32, 4, "decode")}

_REPRO = """
import json, os, sys
import repro.launch.dryrun as RD          # sets XLA_FLAGS for 512 devices
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
from repro.configs import get_arch
from repro.configs.base import INPUT_SHAPES, InputShape
arch, shapes = sys.argv[1], json.loads(sys.argv[2])
mesh = jax.make_mesh((2, 2), ("data", "model"))
out = {}
for name, spec in shapes.items():
    INPUT_SHAPES[name] = InputShape(*spec)
    out[name] = RD._measure_shallow(get_arch(arch).smoke(), name, mesh, fsdp=True,
                                    shard_cache_len=False, remat=True)
print(json.dumps(out))
"""


def _repro_counts(arch):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(filter(None, ["src", os.environ.get("PYTHONPATH")])))
    run = subprocess.run([sys.executable, "-c", _REPRO, arch, json.dumps(SHAPES)],
                         capture_output=True, text=True, env=env, timeout=240,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert run.returncode == 0, run.stderr[-3000:]
    return json.loads(run.stdout.strip().splitlines()[-1])


# (the lowest port / repro FLOPs ratio, the train step's lowest)
FLOPS_FLOOR = {"qwen3-8b": (0.7, 0.9), "qwen3-moe-235b-a22b": (0.25, 0.25)}


@pytest.mark.timeout(300)
@pytest.mark.parametrize("arch", list(FLOPS_FLOOR))
def test_the_port_s_counts_beside_repro_s(arch, monkeypatch):
    for name, spec in SHAPES.items():
        monkeypatch.setitem(INPUT_SHAPES, name, InputShape(*spec))
    want = _repro_counts(arch)
    floor, train_floor = FLOPS_FLOOR[arch]
    for name in SHAPES:
        got = dryrun._measure_shallow(get_arch(arch).smoke(), name, (2, 2))
        ref = want[name]
        assert set(ref) <= set(got), name             # repro's keys, all there
        assert got["units"] == ref["units"]
        assert set(got["coll_breakdown"]) == set(ref["coll_breakdown"])
        ratio = got["flops"] / ref["flops"]
        assert (train_floor if name == "tiny_train" else floor) <= ratio <= 1.0, (name, ratio)
        kinds = {k for k, v in got["coll_breakdown"].items() if v}
        ref_kinds = {k for k, v in ref["coll_breakdown"].items() if v}
        assert {"all-gather", "all-reduce"} <= kinds & ref_kinds, (name, kinds, ref_kinds)
        # the port's plan: FSDP gathers, their grads reduce-scattered, no
        # resharding by all-to-all or permutes (expert parallelism is off)
        assert kinds <= {"all-gather", "all-reduce", "reduce-scatter"}, (name, kinds)
        assert ("reduce-scatter" in kinds) == (name == "tiny_train"), (name, kinds)
