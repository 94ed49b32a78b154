"""No JAX: the check by whole top-level module name, what the harness and
the port's paths it drives load, and a checkout without the port."""
import json
import os
import shutil
import subprocess
import sys
import types

from conftest import ROOT
from perfbench import harness as H


def test_forbidden_names_are_matched_whole(monkeypatch):
    for name in ("repro_torch", "repro_torch.models", "jax_like", "reproduce"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert H.forbidden_modules() == sorted(
        {m.split(".")[0] for m in sys.modules} & {"jax", "jaxlib", "flax", "repro"})
    for name in ("repro.models", "jaxlib", "flax.core"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert {"repro", "jaxlib", "flax"} <= set(H.forbidden_modules())


def test_the_harness_and_the_port_it_drives_load_no_jax():
    code = (f"import sys; sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
            "from perfbench import harness, trace\n"
            "import perfbench.cells.learn, perfbench.cells.serve\n"
            "import perfbench.reference.learn, perfbench.reference.serve\n"
            "import repro_torch.learners, repro_torch.infserver, repro_torch.optim\n"
            "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={k: v for k, v in os.environ.items()
                                           if k != "PYTHONPATH"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_a_checkout_of_only_the_benchmark_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cell = json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"][0]["name"]
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
                          "3000000001", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0
    assert '"correct"' not in out.stdout


def test_no_cuda_gives_no_result():
    cell = json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"][0]["name"]
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
                          "3000000001", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict({k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
                                  CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
