"""Serving entry points: the single-process decode demo and the
replica-fleet gateway (the serving-gateway plane); counterpart of
`repro.launch.serve`.

Decode demo (prefill + autoregressive decode for a dense assigned arch;
`--smoke` runs the reduced variant, `--full` the published widths):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b --smoke \
      --batch 4 --prompt-len 64 --new-tokens 16 [--sliding] [--device cpu]

Standalone replica (one InfServer on the card behind an RpcServer; prints
`REPLICA host:port` for fleet discovery, serves until killed — the unit
`serving.fleet.spawn_replica` manages and k8s deploys):

  PYTHONPATH=src python -m repro_torch.launch.serve --replica \\
      --bind 0.0.0.0:9006 --arch tleague-policy-s --env rps

Gateway (a `ServingGateway` over RPC fronting replica endpoints):

  PYTHONPATH=src python -m repro_torch.launch.serve --gateway \\
      --replica-endpoints host0:9006,host1:9006

Gateway fleet (spawn N local replica processes, front them with a
`ServingGateway`, roll a model out to the fleet and drive a short
deadline-tagged traffic demo — the one-command serving-plane smoke):

  PYTHONPATH=src python -m repro_torch.launch.serve --replicas 4 \\
      --arch tleague-policy-s --env rps --demo-rounds 50

The demo and the replicas run on `--device` (CUDA by default, raising
without a card; `--device cpu` runs the plain PyTorch versions). Without
`--replica`, `--gateway` or `--replicas` the decode demo runs.
"""
from __future__ import annotations

import argparse
import json
import signal
import sys
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs import get_arch


def _wait_for_signal() -> None:
    """Block until SIGTERM/SIGINT."""
    done = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, lambda *_: done.set())
        except ValueError:                    # pragma: no cover - not main thread
            pass
    done.wait()


def serve(arch: str, *, smoke: bool = True, batch: int = 4, prompt_len: int = 64,
          new_tokens: int = 16, sliding: bool = False, temperature: float = 1.0,
          seed: int = 0, verbose: bool = True, device=None):
    """The decode demo: seeded params for `arch` (its `smoke()` variant
    unless smoke=False), a prefill of `batch` random prompts of
    `prompt_len` tokens, then `new_tokens` decode steps, every row at the
    same position (`uniform`). sliding=True decodes over the O(window) ring
    buffer with a `long_context_window` mask. Tokens are greedy at
    temperature 0, else a categorical draw from a `torch.Generator` on the
    device (so they differ from `repro`'s). Prints `repro`'s two lines and
    one JSON line; returns the sampled tokens, a list of (batch, 1)
    tensors. Timings end in a `torch.cuda.synchronize` on the card."""
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.rl.distributions import categorical_sample
    from repro_torch.utils import resolve_device

    dev = resolve_device(device)
    cfg = get_arch(arch)
    if smoke:
        cfg = cfg.smoke()
    if cfg.encoder_only:
        raise ValueError(f"{cfg.name} is encoder-only: no decode step")
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_params(gen, cfg)
    toks = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=gen, device=dev)
    window = cfg.long_context_window if sliding and cfg.family != "ssm" else 0

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    out = []
    with torch.inference_mode():
        sync()
        t0 = time.perf_counter()
        logits, _, state = prefill(params, cfg, {"tokens": toks}, sliding=sliding)
        sync()
        t_prefill = time.perf_counter() - t0
        tok = logits[:, -1:].argmax(-1)
        del logits
        t0 = time.perf_counter()
        for _ in range(new_tokens):
            lg, _, state = decode_step(params, cfg, tok, state, window=window, uniform=True)
            if temperature > 0:
                tok = categorical_sample(gen, lg[:, -1] / temperature)[:, None]
            else:
                tok = lg[:, -1:].argmax(-1)
            out.append(tok)
        sync()
        t_decode = (time.perf_counter() - t0) / max(new_tokens, 1)
    if verbose:
        tokens0 = [int(t[0, 0]) for t in out]
        print(f"[serve] {cfg.name}: prefill({batch}x{prompt_len}) "
              f"{t_prefill*1e3:.1f}ms; decode {t_decode*1e3:.1f}ms/token "
              f"(window={window or 'full'})")
        print("[serve] sampled tokens[0]:", tokens0)
        print(json.dumps({"arch": cfg.name, "device": str(dev), "batch": batch,
                          "prompt_len": prompt_len, "new_tokens": new_tokens,
                          "prefill_ms": 1e3 * t_prefill,
                          "decode_ms_per_token": 1e3 * t_decode,
                          "window": window, "tokens0": tokens0}), flush=True)
    return out


def run_replica(*, arch: str = "tleague-policy-s", env_name: str = "rps",
                seed: int = 0, max_batch: int = 256,
                bind: str = "127.0.0.1:0", verbose: bool = True,
                device=None) -> None:
    """One standalone serving replica: an InfServer on `device` behind an
    RpcServer, no coordinator required (the gateway is its control plane).
    Prints the `REPLICA host:port` discovery banner and blocks until
    SIGTERM/SIGINT; then prints its serving stats and kernel launch counts
    as one JSON line."""
    from repro_torch.distributed.transport import (InfServerBackend,
                                                   RpcServer, parse_addr)
    from repro_torch.envs import make_env
    from repro_torch.infserver import InfServer
    from repro_torch.launch.distributed import kernel_report
    from repro_torch.utils import resolve_device

    dev = resolve_device(device)
    cfg = get_arch(arch)
    env = make_env(env_name, device=dev)
    server = InfServer(cfg, env.spec.num_actions, seed=seed,
                       max_batch=max_batch, device=dev)
    host, port = parse_addr(bind)
    rpc = RpcServer({"inf": InfServerBackend(server)},
                    host=host, port=port).start()
    print(f"REPLICA {rpc.address}", flush=True)
    _wait_for_signal()
    rpc.close()
    if verbose:
        st = server.stats()
        print(f"[replica] served {st['rows_served']} rows over "
              f"{st['batches_run']} batches", flush=True)
        # one write for the line and its newline (replicas share a pipe)
        sys.stdout.write(json.dumps({"process": "replica", **st,
                                     "kernels": kernel_report(dev)}, default=str) + "\n")
        sys.stdout.flush()


def run_gateway(replica_endpoints, *, bind: str = "127.0.0.1:0",
                router: str = "lineage", max_inflight_rows: int = 4096,
                verbose: bool = True) -> None:
    """Serve a `ServingGateway` over RPC (namespace `inf`): every
    existing `InfServerClient` — and therefore every served Actor —
    talks to the replica FLEET through this address without knowing it.
    `replica_endpoints` is a comma-separated list (or list) of replica
    `host:port`s, e.g. the per-pod DNS names of the k8s StatefulSet.
    Blocks until SIGTERM/SIGINT. The gateway runs no model: it needs no
    card."""
    from repro_torch.distributed.transport import RpcServer, parse_addr
    from repro_torch.serving import GatewayBackend, ServingGateway
    from repro_torch.serving.fleet import connect

    if isinstance(replica_endpoints, str):
        replica_endpoints = [e.strip() for e in replica_endpoints.split(",")
                             if e.strip()]
    gw = ServingGateway([connect(ep) for ep in replica_endpoints],
                        router=router,
                        max_inflight_rows=max_inflight_rows).start()
    host, port = parse_addr(bind)
    rpc = RpcServer({"inf": GatewayBackend(gw)}, host=host,
                    port=port).start()
    print(f"GATEWAY {rpc.address} fronting "
          f"{len(replica_endpoints)} replicas", flush=True)
    _wait_for_signal()
    rpc.close()
    gw.stop()
    if verbose:
        st = gw.stats()
        print(f"[gateway] {st['rows']} rows over {st['requests']} requests, "
              f"shed {st['shed_requests']}, failovers {st['failovers']}",
              flush=True)


def serve_fleet(replicas: int, *, arch: str = "tleague-policy-s",
                env_name: str = "rps", seed: int = 0,
                demo_rounds: int = 50, demo_rows: int = 8,
                deadline_ms: float = 250.0, verbose: bool = True,
                device=None,
                on_rollout: Optional[Callable] = None) -> dict:
    """Spawn `replicas` local replica processes on `device`, front them
    with a `ServingGateway`, roll the demo model out to the fleet
    (probe-gated) and drive `demo_rounds` of deadline-tagged traffic
    across two lineages. Returns the gateway stats dict with the
    rollout reports (`rollouts`), the traffic's rows/s (`demo`) and each
    replica's own final report (`replica_reports`: its stats and kernel
    launch counts, printed at SIGTERM); the fleet is torn down before
    returning.

    The params are `role_params(cfg, seed, 0, device)`: made on the card
    and shipped to the replicas as numpy. `on_rollout(gateway, params,
    keys)`, when given, runs after the rollout and before the traffic:
    the one way to probe the live fleet, since the fleet is torn down
    before this returns. `chip_smoke.py` uses it to hold the replicas'
    outputs against the plain forward and to time warm traffic."""
    from repro_torch.core import ModelKey
    from repro_torch.envs import make_env
    from repro_torch.league.runtime import role_params
    from repro_torch.params.manifest import build_manifest
    from repro_torch.serving import ServingGateway
    from repro_torch.serving.fleet import connect, shutdown, spawn_fleet
    from repro_torch.utils import resolve_device

    dev = resolve_device(device)
    cfg = get_arch(arch)
    env = make_env(env_name, device=dev)
    params = role_params(cfg, seed, 0, dev)
    fleet = spawn_fleet(replicas, arch=arch, env_name=env_name,
                        base_seed=seed, device=str(dev))
    gw = None
    try:
        gw = ServingGateway([connect(r.address) for r in fleet]).start()
        keys = [ModelKey("main", 0), ModelKey("exploiter", 0)]
        rollouts = {}
        for key in keys:
            report = gw.rollout(key, params,
                                build_manifest(params, version=0))
            rollouts[str(key)] = report
            if verbose:
                print(f"[gateway] rollout {key}: shipped to "
                      f"{report['shipped_to']}/{replicas} replicas "
                      f"({report['bytes_shipped']} bytes, "
                      f"{report['propagation_ms']:.1f}ms)", flush=True)
        if on_rollout is not None:
            on_rollout(gw, params, keys)
        obs_len = env.spec.obs_len
        rng = np.random.default_rng(seed)
        rows0 = gw.stats()["rows"]
        t0 = time.perf_counter()
        for _ in range(demo_rounds):
            tickets = [gw.submit(
                rng.integers(0, 8, (demo_rows, obs_len)).astype(np.int32),
                model=keys[rng.integers(len(keys))],
                deadline_s=deadline_ms / 1e3) for _ in range(replicas)]
            for t in tickets:
                gw.get(t)
        dt = time.perf_counter() - t0
        st = gw.stats()
        served = st["rows"] - rows0
        if verbose:
            print(f"[gateway] {replicas} replicas: {served} rows in "
                  f"{dt:.2f}s ({served / dt:,.0f} rows/s), "
                  f"deadlines: {st['deadlines']}", flush=True)
        result = {**st, "rollouts": rollouts,
                  "demo": {"rows": served, "seconds": dt,
                           "rows_per_s": served / dt}}
    finally:
        if gw is not None:
            gw.stop()
        shutdown(fleet)
    # each replica prints its stats and kernel launch counts at SIGTERM
    result["replica_reports"] = [
        json.loads(line) for r in fleet for line in r.proc.stdout.read().splitlines()
        if line.startswith("{")]
    return result


def main():
    ap = argparse.ArgumentParser()
    # default depends on mode: the decode demo wants a decoder arch, the
    # replica/fleet modes serve the league policy
    ap.add_argument("--arch", default=None)
    # decode demo
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--sliding", action="store_true")
    ap.add_argument("--temperature", type=float, default=1.0)
    # serving-gateway plane
    ap.add_argument("--replica", action="store_true",
                    help="run one standalone InfServer replica (RPC) "
                         "until killed; prints 'REPLICA host:port'")
    ap.add_argument("--replicas", type=int, default=0, metavar="N",
                    help="spawn an N-replica local fleet behind a "
                         "ServingGateway and run the traffic demo")
    ap.add_argument("--gateway", action="store_true",
                    help="serve a ServingGateway over RPC fronting "
                         "--replica-endpoints (the k8s gateway pod)")
    ap.add_argument("--replica-endpoints", default="",
                    help="comma-separated replica host:port list for "
                         "--gateway")
    ap.add_argument("--router", default="lineage",
                    choices=("lineage", "least_loaded", "round_robin"))
    ap.add_argument("--max-inflight-rows", type=int, default=4096)
    ap.add_argument("--env", dest="env_name", default="rps")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-batch", type=int, default=256)
    ap.add_argument("--bind", default="127.0.0.1:0")
    ap.add_argument("--demo-rounds", type=int, default=50)
    ap.add_argument("--demo-rows", type=int, default=8)
    ap.add_argument("--deadline-ms", type=float, default=250.0)
    ap.add_argument("--device", default=None,
                    help="torch device of the demo or the replicas (default: CUDA, "
                         "raising without a card; 'cpu' runs the plain "
                         "PyTorch versions)")
    args = ap.parse_args()
    if args.replica:
        run_replica(arch=args.arch or "tleague-policy-s",
                    env_name=args.env_name, seed=args.seed,
                    max_batch=args.max_batch, bind=args.bind,
                    device=args.device)
        return
    if args.gateway:
        assert args.replica_endpoints, "--gateway needs --replica-endpoints"
        run_gateway(args.replica_endpoints, bind=args.bind,
                    router=args.router,
                    max_inflight_rows=args.max_inflight_rows)
        return
    if args.replicas > 0:
        serve_fleet(args.replicas, arch=args.arch or "tleague-policy-s",
                    env_name=args.env_name, seed=args.seed,
                    demo_rounds=args.demo_rounds, demo_rows=args.demo_rows,
                    deadline_ms=args.deadline_ms, device=args.device)
        return
    serve(args.arch or "gemma2-2b", smoke=args.smoke, batch=args.batch,
          prompt_len=args.prompt_len, new_tokens=args.new_tokens,
          sliding=args.sliding, temperature=args.temperature, seed=args.seed,
          device=args.device)


if __name__ == "__main__":
    main()
