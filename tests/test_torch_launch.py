"""The port's launch layer on the CPU: the `--sync` loop against `repro`'s,
the multiprocess league as users start it, the k8s render against
`repro`'s, the pool replica, and the kernel build across processes.

- `run_league_training` (`--sync`) on rps, small, in both packages: the
  same frozen keys and the same number of payoff games (the two
  frameworks' random streams differ, so no losses are compared).
- `run_multiprocess(..., device="cpu")` on rps, two actor processes and a
  step quota of 4: a clean shutdown, every exit code 0, and one JSON
  result line per child that parses, with its kernel launch counts.
- The CLI without `--device` on a host without a card raises instead of
  running on the CPU; `--sharded` serves over a one-rank mesh of its own
  process group and tears the group down at stop. The decode demo runs on
  the CPU, for a dense arch
  through the CLI and for one arch of each other decoding family in
  process.
- `k8s.render()` equals `repro`'s line for line, apart from the module
  names, the accelerator and the accelerator node pool.
- `ModelPoolReplica` (the `--role pool-replica` process's core), as
  `tests/test_robustness.py` holds `repro`'s.
- `_build.build()` in two processes at once, with a stub `nvcc` that
  counts its calls: each source is compiled once.

Every subprocess has a timeout and is killed in a `finally`.
"""
import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SPEC = ROOT / "examples" / "league_specs" / "main_minimax.json"


def _env(**extra):
    path = os.pathsep.join([str(ROOT / "src")] + (
        [os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH") else []))
    return dict(os.environ, PYTHONPATH=path, OMP_NUM_THREADS="1", **extra)


# -- the --sync loop against repro's -----------------------------------------
def test_sync_league_training_matches_repro():
    from repro.launch.train import run_league_training as jax_run
    from repro_torch.launch.train import run_league_training
    from repro_torch.utils import tree_leaves

    kw = dict(env_name="rps", arch="tleague-policy-s", game_mgr="sp_pfsp", num_envs=4,
              unroll_len=4, periods=2, steps_per_period=2, num_exploiters=1, seed=3,
              verbose=False)
    league, agents, history = run_league_training(device="cpu", **kw)
    jleague, _, jhistory = jax_run(**kw)
    state, jstate = league.league_state(), jleague.league_state()
    assert state["frozen_pool"] == jstate["frozen_pool"]
    assert [str(k) for k in league.frozen_pool] == [str(k) for k in jleague.frozen_pool]
    assert state["num_results"] == jstate["num_results"] > 0
    assert state["num_freezes"] == jstate["num_freezes"] == 4
    assert [(r["period"], r["it"], r["agent"], "skipped" in r) for r in history] == \
        [(r["period"], r["it"], r["agent"], "skipped" in r) for r in jhistory]
    assert all(np.isfinite(r["loss"]) for r in history if "loss" in r)
    for _, learner in agents.values():
        assert all(x.device.type == "cpu" for x in tree_leaves(learner.params))


# -- the multiprocess league ---------------------------------------------------
def test_run_multiprocess_cpu_clean_shutdown(monkeypatch, capfd):
    """Two roles, two actor processes, 4 learner steps per role; the
    children run on the CPU because the parent passes `--device cpu`."""
    from repro_torch.kernels import dispatch
    from repro_torch.launch.distributed import run_multiprocess
    from repro_torch.league import LeagueSpec

    dispatch.stats(reset=True)                  # this process's counts: the coordinator's
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("PYTHONPATH", _env()["PYTHONPATH"])
    spec = LeagueSpec.from_json(str(SPEC))
    report = run_multiprocess(spec, workers=2, env_name="rps", num_envs=4, unroll_len=4,
                              max_steps_per_role=4, max_seconds=240.0,
                              heartbeat_timeout_s=60.0, max_actor_restarts=0,
                              device="cpu", verbose=False)
    out = capfd.readouterr().out
    assert report["clean_shutdown"], report["worker_exit_codes"]
    assert report["worker_exit_codes"] == [0, 0, 0, 0] and report["actor_restarts"] == 0
    assert all(s >= 4 for s in report["progress"]["learner_steps"].values())
    window = report["after_first_steps"]
    assert window["seconds"] > 0 and window["learner_steps"] >= 0, window
    lines = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    kinds = sorted(ln["process"] for ln in lines)
    assert kinds == ["actor", "actor", "learner", "learner"], kinds
    for ln in lines:
        k = ln["kernels"]
        assert set(k["launches"]) == {"rmsnorm", "flash_attention_fwd", "flash_attention_bwd_dq",
                                      "flash_attention_bwd_dkv", "reverse_discounted_scan_p",
                                      "adamw_update", "global_norm"}
        assert sum(k["launches"].values()) == 0 and k["peak_cuda_bytes"] is None  # plain versions
        assert not any("|kernel" in t for t in k["dispatch"])
        if ln["process"] == "learner":
            assert ln["steps"] >= 4 and k["dispatch"]["reverse_scan|reference"] == ln["steps"]
        else:
            assert ln["frames_produced"] > 0 and ln["segments"] >= 1
            assert ln["segments_dropped"] == 0
    assert report["kernels"]["dispatch"] == {}                 # the coordinator ran no model


def test_cli_without_device_raises_without_a_card():
    """The README's entry point with no `--device`: CUDA is the default,
    so on a host without a card it raises before starting anything."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid here")
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--workers", "2",
                        "--env", "rps", "--league-spec", str(SPEC), "--max-steps", "4"],
                       env=_env(), capture_output=True, text=True, timeout=180)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr and "device='cpu'" in r.stderr
    assert not any(ln.startswith("{") for ln in r.stdout.splitlines())


def test_sharded_raises_not_implemented():
    """`--sharded` no longer raises: the infserver role (its coordinator
    unreachable, so it stops at once) and the coordinator's served
    InfServer each serve over a (1, 1) mesh of their own process group,
    report it, and tear the group down on the way out."""
    import torch.distributed as tdist

    from repro_torch.launch import distributed as dist
    from repro_torch.league import LeagueSpec

    st = dist.run_infserver("127.0.0.1:1", sharded=True, device="cpu",
                            heartbeat_timeout_s=2.0, verbose=False)
    assert st["sharded"] is True and st["mesh_shape"] == [1, 1]
    assert not tdist.is_initialized()
    spec = LeagueSpec.from_json(str(SPEC))
    report = dist.run_coordinator(spec, served=True, sharded=True, device="cpu",
                                  max_seconds=0.5, verbose=False)
    assert report["serving"]["sharded"] is True
    assert report["serving"]["mesh_shape"] == [1, 1]
    assert not tdist.is_initialized()


def test_decode_demo_runs_on_cpu():
    """`launch.serve` without a mode runs the decode demo: prefill, then
    greedy decode steps, `repro`'s two lines and one JSON line."""
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch", "gemma2-2b",
                        "--smoke", "--device", "cpu", "--new-tokens", "4", "--temperature", "0"],
                       env=_env(), capture_output=True, text=True, timeout=180)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.splitlines()
    assert lines[0].startswith("[serve] gemma2-2b-smoke: prefill(4x64)")
    assert lines[1].startswith("[serve] sampled tokens[0]:")
    out = json.loads(lines[-1])
    assert out["arch"] == "gemma2-2b-smoke" and out["device"] == "cpu"
    assert out["new_tokens"] == 4 and len(out["tokens0"]) == 4 and out["window"] == 0
    assert out["prefill_ms"] > 0 and out["decode_ms_per_token"] > 0
    assert all(0 <= t < 512 for t in out["tokens0"])


@pytest.mark.parametrize("arch,sliding", [("qwen3-moe-235b-a22b", False), ("rwkv6-3b", True),
                                          ("hymba-1.5b", True), ("pixtral-12b", False)])
def test_decode_demo_runs_each_family_on_cpu(arch, sliding, capsys):
    """The demo as `repro`'s runs these archs: token prompts only (pixtral
    too), and `--sliding` gives the ssm family no window."""
    from repro_torch.launch.serve import serve

    out = serve(arch, smoke=True, batch=2, prompt_len=20, new_tokens=3, sliding=sliding,
                temperature=0.0, device="cpu")
    assert len(out) == 3 and all(t.shape == (2, 1) for t in out)
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line["arch"] == f"{arch}-smoke" and line["new_tokens"] == 3
    assert line["window"] == (128 if sliding and arch != "rwkv6-3b" else 0)
    assert all(0 <= t < 512 for t in line["tokens0"])


def test_role_params_seed_every_mode_alike():
    """One init for every mode: role i's params are drawn from a generator
    seeded `seed * 1000 + i` (the threaded runtime's rule)."""
    from repro_torch.configs import get_arch
    from repro_torch.league.runtime import role_params
    from repro_torch.models import init_params
    from repro_torch.utils import tree_leaves

    cfg = get_arch("tleague-policy-s")
    a = role_params(cfg, 2, 1, torch.device("cpu"))
    b = init_params(torch.Generator().manual_seed(2001), cfg)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


# -- k8s -------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [{}, {"pool_replicas": 2, "signature": "sig"},
                                {"serving_replicas": 3, "inf_servers": 0}])
def test_k8s_render_matches_repro_but_modules_and_accelerator(kw):
    from repro.launch.k8s import render as jax_render
    from repro_torch.launch.k8s import render

    ours, theirs = render(**kw).splitlines(), jax_render(**kw).splitlines()
    assert len(ours) == len(theirs)
    changed = 0
    for a, b in zip(ours, theirs):
        if a == b:
            continue
        changed += 1
        swapped = (b.replace('"-m", "repro.', '"-m", "repro_torch.')
                    .replace('["python", "-m", "repro.', '["python", "-m", "repro_torch.')
                    .replace("google.com/tpu: 1", "nvidia.com/gpu: 1")
                    .replace("pool: tpu-v5e", "pool: gpu-h100"))
        assert a == swapped, (a, b)
    assert changed > 0
    assert "tpu" not in "\n".join(ours)


def test_k8s_renders_replica_fleet_and_endpoints():
    from repro_torch.launch.k8s import render

    out = render(pool_replicas=2, signature="sig")
    assert "sig-pool-replica" in out
    assert '"--role", "pool-replica"' in out
    assert "replicas: 2" in out
    assert '"--pool-endpoints", "sig-pool-replica:9008,sig-coordinator:9003"' in out
    assert '"--pool-endpoints", "sig-coordinator:9003,sig-pool-replica:9008"' in out
    assert "repro.dev/in-process-restart-budget" in out
    assert "repro.dev/rpc-retry-backoff" in out
    assert "pool-replica" not in render(pool_replicas=0)


def test_restart_budget_annotation_matches_code():
    from repro_torch.launch.distributed import DEFAULT_ACTOR_RESTARTS
    from repro_torch.launch.k8s import render

    assert f'repro.dev/in-process-restart-budget: "{DEFAULT_ACTOR_RESTARTS}"' in render()


# -- the pool replica --------------------------------------------------------------
def _small_params(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(16, 16)).astype(np.float32),
            "b": rng.normal(size=(16,)).astype(np.float32)}


class TestReplica:
    def test_install_refuses_non_monotonic(self):
        from repro_torch.core import ModelKey, ModelPool

        src, dst = ModelPool(), ModelPool()
        key = ModelKey("m", 0)
        src.push(key, _small_params())
        src.push(key, _small_params(1))
        v, man = src.version(key), src.manifest(key)
        assert dst.install(key, src.pull(key), v, manifest=man)
        assert dst.version(key) == v
        assert not dst.install(key, src.pull(key), v, manifest=man)
        assert not dst.install(key, src.pull(key), v - 1)
        assert dst.version(key) == v
        with pytest.raises(AssertionError):
            dst.install(key, src.pull(key), v + 1, manifest=man)

    def test_sync_version_coherent_and_frozen_mirrored(self):
        from repro_torch.core import ModelKey, ModelPool, ModelPoolReplica

        primary = ModelPool()
        key = ModelKey("m", 0)
        primary.push(key, _small_params())
        rep = ModelPoolReplica(primary, sync_interval_s=0.01)
        rep.sync_once()
        assert rep.version(key) == primary.version(key)
        assert rep.manifest(key).tree_hash == primary.manifest(key).tree_hash
        primary.push(key, _small_params(1))
        primary.freeze(key)
        rep.sync_once()
        assert rep.version(key) == primary.version(key)
        assert rep.pull_attr(key)["frozen"]
        assert rep.sync_stats["frozen_mirrored"] == 1
        np.testing.assert_array_equal(rep.pull(key)["w"], primary.pull(key)["w"])

    def test_replica_refuses_writes(self):
        from repro_torch.core import ModelKey, ModelPool, ModelPoolReplica

        rep = ModelPoolReplica(ModelPool())
        with pytest.raises(ValueError, match="read replica"):
            rep.push(ModelKey("m", 0), _small_params())
        with pytest.raises(ValueError, match="read replica"):
            rep.freeze(ModelKey("m", 0))

    def test_follow_thread_tracks_primary_over_rpc(self):
        """The replica follows a remote primary through the transport, as
        `run_pool_replica` runs it."""
        from repro_torch.core import ModelKey, ModelPool, ModelPoolReplica
        from repro_torch.distributed import transport as tp

        primary = ModelPool()
        key = ModelKey("m", 0)
        primary.push(key, _small_params())
        srv = tp.RpcServer({"pool": primary}).start()
        client = tp.ModelPoolClient(srv.address)
        rep = ModelPoolReplica(client, sync_interval_s=0.01).start_following()
        try:
            deadline = time.monotonic() + 10.0
            while key not in rep and time.monotonic() < deadline:
                time.sleep(0.01)
            assert key in rep
            primary.push(key, _small_params(2))
            while rep.version(key) < primary.version(key) and time.monotonic() < deadline:
                time.sleep(0.01)
            assert rep.version(key) == primary.version(key)
            np.testing.assert_array_equal(rep.pull(key)["w"], _small_params(2)["w"])
        finally:
            rep.stop()
            client.close()
            srv.close()


# -- the kernel build across processes ---------------------------------------------
def test_build_compiles_each_source_once_across_processes(tmp_path):
    """Two processes call `_build.build()` at once on an empty build dir,
    with a stub `nvcc` on PATH that logs each call and writes its `-o`
    output after a pause: the file lock makes one build and the other load
    its result, so each source is compiled once and linked once."""
    from repro_torch.kernels import _build

    bindir, build_dir, log = tmp_path / "bin", tmp_path / "build", tmp_path / "nvcc.log"
    bindir.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text(textwrap.dedent(f"""\
        #!{sys.executable}
        import sys, time
        args = sys.argv[1:]
        src = args[args.index("-c") + 1] if "-c" in args else "link"
        with open({str(log)!r}, "a") as f:
            f.write(src + "\\n")
        time.sleep(0.5)
        open(args[args.index("-o") + 1], "wb").close()
        """))
    nvcc.chmod(0o755)
    script = textwrap.dedent(f"""\
        import os, sys, time
        from pathlib import Path
        from repro_torch.kernels import _build
        _build.BUILD_DIR = Path({str(build_dir)!r})
        me, other = Path(sys.argv[1]), Path(sys.argv[2])
        me.touch()
        deadline = time.monotonic() + 60
        while not other.exists() and time.monotonic() < deadline:
            time.sleep(0.01)             # both start build() together
        print(_build.build())
        """)
    env = _env(PATH=f"{bindir}{os.pathsep}{os.environ['PATH']}")
    procs = [subprocess.Popen([sys.executable, "-c", script, str(tmp_path / f"ready{i}"),
                               str(tmp_path / f"ready{1 - i}")], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for i in range(2)]
    try:
        outs = [p.communicate(timeout=180) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    assert [p.returncode for p in procs] == [0, 0], [o[1][-2000:] for o in outs]
    built = {o[0].strip() for o in outs}
    assert len(built) == 1 and Path(built.pop()).is_file()
    calls = log.read_text().split()
    want = sorted(str(s) for s in _build.sources())
    assert sorted(c for c in calls if c != "link") == want
    assert calls.count("link") == 1
