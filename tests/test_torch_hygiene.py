"""The port's boundaries: no JAX in it, CUDA by default, kernels from source.

- No module of `repro_torch`, and none of `chip_smoke.py`, the scripts in
  `tools/`, the port's fault smokes (`tests/smoke_torch_*.py` and their
  `tests/torch_smoke_lib.py`), its examples (`examples/torch_*.py`) and
  `tests/test_torch_cuda.py` (which run
  on the card's machine, where there is no jax), imports jax or the JAX
  package `repro` (an AST walk, and a fresh interpreter that imports the
  whole port and finds no jax in `sys.modules`).
- The command lines the port starts name only `repro_torch` modules, never
  a `repro` one (an AST walk cannot see a module named in a string): the
  multiprocess league's children (`_spawn_role`), the fleet's replicas
  (`spawn_replica`, both with `subprocess.Popen` captured), every
  command that `launch.k8s.render()` writes, and every child the fault
  smokes start (their `torch_smoke_lib.Child` captured; the shm
  producer's `-c` source walked).
- Entry points default to CUDA and raise where there is none.
- The kernel build raises without nvcc: there is no prebuilt fallback.
- chip_smoke.py fails, printing no result, without a card.
"""
import ast
import io
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.infserver import InfServer
from repro_torch.kernels import _build

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = {"jax", "jaxlib", "repro", "flax", "optax"}


def _roots_of(source: str):
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def _imported_roots(path: Path):
    return _roots_of(path.read_text())


def test_port_and_chip_smoke_import_no_jax():
    tools = sorted((ROOT / "tools").glob("*.py"))
    smokes = sorted((ROOT / "tests").glob("smoke_torch_*.py"))
    examples = sorted((ROOT / "examples").glob("torch_*.py"))
    assert {f.name for f in tools} >= {
        "time_flash.py", "time_norm_scan.py", "card_procs.py", "mesh_two_ranks.py",
        "train_memory.py"}
    assert len(smokes) == 4 and len(examples) == 4
    files = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + tools + smokes
             + [ROOT / "tests" / "torch_smoke_lib.py"] + examples
             + [ROOT / "tests" / "test_torch_cuda.py"])
    assert len(files) > 20
    bad = {str(f.relative_to(ROOT)): sorted(set(_imported_roots(f)) & FORBIDDEN)
           for f in files}
    assert {f: m for f, m in bad.items() if m} == {}


def test_importing_the_port_loads_no_jax():
    code = ("import pkgutil, importlib, sys, repro_torch\n"
            "import repro_torch.infserver\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "assert not any(n == 'repro' or n.startswith('repro.') for n in sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_infserver_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_arch("tleague-policy-s")
    with pytest.raises(RuntimeError, match="CUDA"):
        InfServer(cfg, 6)
    with pytest.raises(RuntimeError, match="CUDA"):
        InfServer(cfg, 6, device="cuda")
    assert InfServer(cfg, 6, device="cpu").device.type == "cpu"


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "CUDA_DEFAULT", tmp_path / "no-nvcc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not (tmp_path / "build").exists()


def test_build_key_covers_every_source():
    names = {p.name for p in _build.sources()}
    assert {"rmsnorm.cu", "flash_fwd.cu", "flash_bwd.cu", "reverse_scan.cu",
            "adamw.cu"} <= names
    assert set(_build.SIGNATURES) == {"rmsnorm_fwd", "flash_fwd", "flash_bwd_dq",
                                      "flash_bwd_dkv", "reverse_scan", "adamw_update",
                                      "global_norm_sumsq", "global_norm_finish"}
    assert "arch=compute_90a,code=sm_90a" in _build.FLAGS


def test_chip_smoke_fails_without_a_card(tmp_path):
    """No card: exit non-zero and print no result, in the checkout and in a
    directory holding chip_smoke.py alone."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    for where in (ROOT, tmp_path):
        r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=where, env=env,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode != 0 and r.stdout == "", (where, r.stdout, r.stderr)


def _modules_run(cmd):
    """The modules a command line runs with `-m`."""
    return [cmd[i + 1] for i, a in enumerate(cmd[:-1]) if a == "-m"]


def _assert_port_modules(mods):
    import importlib.util

    assert mods
    for m in mods:
        assert m.startswith("repro_torch."), m
        assert importlib.util.find_spec(m) is not None, m


def test_spawned_commands_run_only_port_modules(monkeypatch):
    """Capture what the launch layer hands `subprocess.Popen`: the
    league's role children and the fleet's replicas run `repro_torch`
    modules, with the port's `src` first on PYTHONPATH."""
    from repro_torch.launch import distributed
    from repro_torch.serving import fleet

    started = []

    class FakeProc:
        """Records the command; prints a replica's banner."""
        def __init__(self, cmd, **kw):
            started.append((cmd, kw.get("env") or {}))
            self.stdout = io.StringIO("REPLICA 127.0.0.1:1\n")

        def poll(self):
            return None

    monkeypatch.setattr(distributed.subprocess, "Popen", FakeProc)
    monkeypatch.setattr(fleet.subprocess, "Popen", FakeProc)
    distributed._spawn_role("learner", "127.0.0.1:1", ["--league-role", "main"])
    distributed._spawn_role("actor", "127.0.0.1:1", ["--device", "cpu"])
    fleet.spawn_replica(device="cpu", startup_timeout_s=5.0)
    assert len(started) == 3
    for cmd, env in started:
        _assert_port_modules(_modules_run(cmd))
        assert env["PYTHONPATH"].split(os.pathsep)[0] == str(ROOT / "src")
    assert _modules_run(started[-1][0]) == ["repro_torch.launch.serve"]


@pytest.mark.parametrize("kw", [{}, {"pool_replicas": 2, "serving_replicas": 2}])
def test_k8s_commands_run_only_port_modules(kw):
    import json as _json
    import re

    from repro_torch.launch.k8s import render

    out = render(**kw)
    cmds = [_json.loads(m) for m in re.findall(r"command: (\[[^\]]*\])", out, re.S)]
    assert len(cmds) >= 5
    _assert_port_modules([m for c in cmds for m in _modules_run(c)])
    assert "repro.launch" not in out and "repro.distributed" not in out



class _Stop(Exception):
    """Ends a captured smoke once its children have been started."""


def _capture_smoke_children(monkeypatch):
    """Replace the smokes' `Child` with a recorder: each command is kept, a
    banner wait answers a fake address (the shm producer's ends the run),
    and the first progress poll ends the run."""
    sys.path.insert(0, str(ROOT / "tests"))
    import torch_smoke_lib as lib

    started = []

    class FakeProc:
        returncode = None

        def poll(self):
            return None

    class FakeChild:
        def __init__(self, name, cmd, t0, extra_env=None):
            started.append(cmd)
            self.name, self.cmd, self.pid, self.exit_s = name, cmd, 0, None
            self.proc, self.lines = FakeProc(), []

        def wait_for(self, pattern, timeout):
            if "-c" in self.cmd:
                raise _Stop
            return "127.0.0.1:1"

        def kill_group(self):
            pass

        def records(self):
            return []

        def tail(self, n=12):
            return ""

    def stop(address):
        raise _Stop

    monkeypatch.setattr(lib, "Child", FakeChild)
    monkeypatch.setattr(lib, "progress", stop)
    return started


@pytest.mark.parametrize("smoke,n", [("smoke_torch_kill_coordinator", 3),
                                     ("smoke_torch_chaos", 7), ("smoke_torch_shm", 1)])
def test_fault_smokes_start_only_port_modules(smoke, n, monkeypatch, capsys):
    """The league smokes start `python -m repro_torch.launch.train` with the
    smoke's `--device`; the shm producer's `-c` source imports the port."""
    import importlib

    started = _capture_smoke_children(monkeypatch)
    mod = importlib.import_module(smoke)
    with pytest.raises(_Stop):
        mod.main(["--device", "cpu"])
    assert len(started) == n
    for cmd in started:
        if "-c" in cmd:
            src = cmd[cmd.index("-c") + 1]
            roots = set(_roots_of(src))
            assert "repro_torch" in roots and not roots & FORBIDDEN, roots
        else:
            assert _modules_run(cmd) == ["repro_torch.launch.train"]
            assert cmd[cmd.index("--device") + 1] == "cpu"


def test_serving_smoke_starts_only_port_replicas(monkeypatch):
    """The serving smoke's fleet is `spawn_fleet`'s `repro_torch.launch.serve
    --replica` processes, each given the smoke's `--device`."""
    sys.path.insert(0, str(ROOT / "tests"))
    import repro_torch.serving as serving
    import smoke_torch_serving as smoke
    from repro_torch.serving import fleet

    started = []

    class FakeProc:
        pid, returncode = 0, 0

        def __init__(self, cmd, **kw):
            started.append(cmd)
            self.stdout = io.StringIO("REPLICA 127.0.0.1:1\n")

        def poll(self):
            return 0

        def wait(self, timeout=None):
            return 0

    def stop(*a, **kw):
        raise _Stop

    monkeypatch.setattr(fleet.subprocess, "Popen", FakeProc)
    monkeypatch.setattr(serving, "ServingGateway", stop)
    with pytest.raises(_Stop):
        smoke.main(["--device", "cpu"])
    assert len(started) == smoke.REPLICAS
    for cmd in started:
        assert _modules_run(cmd) == ["repro_torch.launch.serve"]
        assert cmd[cmd.index("--device") + 1] == "cpu"
