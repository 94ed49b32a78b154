"""League training driver (the paper's full lifecycle, single-host scale);
counterpart of `repro.launch.train`, with every flag of its CLI plus
`--device` (CUDA by default; `--device cpu` runs the plain PyTorch
versions, as the CPU tests do).

Wires LeagueMgr + ModelPool + HyperMgr + GameMgr + Actors + Learner and runs
learning periods with freezes — the same modules the k8s deployment would
run as services (launch/k8s.py renders that spec).

Three execution modes:

  * **async (default with `--league-spec`)** — the event-driven
    `repro_torch.league.runtime`: every Actor and Learner on its own thread, a
    coordinator thread applying the spec's winrate-gated freeze decisions.
  * **sync (`--sync`, or no spec)** — the legacy lockstep nested loop with
    fixed `--periods x --steps` freezes; bit-deterministic under a fixed
    seed, kept as the determinism oracle for the async runtime.
  * **multiprocess (`--workers N`, or one `--role` per process)** — the
    thread seams as real process boundaries over the
    `repro_torch.distributed.transport` RPC layer (the paper's §3.4
    layout): `--workers N` starts one learner process per role plus N
    actor processes (fresh interpreters) from a parent coordinator;
    alternatively run each role yourself with `--role
    {coordinator,learner,actor,infserver,pool-replica} --connect
    host:port`. Add `--served` for a shared InfServer on the
    coordinator's card (`--sharded` lays it out over a (1, 1) mesh of that
    card: `launch/mesh.make_local_mesh`).
    Each role process prints its result, with its kernel launch counts,
    as one JSON line.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --env pommerman_lite \
      --arch tleague-policy-s --game-mgr sp_pfsp --periods 3 --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --env rps \
      --league-spec examples/league_specs/main_minimax.json --max-seconds 10
  PYTHONPATH=src python -m repro_torch.launch.train --env rps --workers 2 \
      --league-spec examples/league_specs/main_minimax.json --max-steps 4
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from repro_torch.actors import Actor
from repro_torch.checkpoint import save_league, save_pytree
from repro_torch.configs import get_arch
from repro_torch.core import GAME_MGRS, LeagueMgr
from repro_torch.envs import make_env
from repro_torch.infserver import InfServer
from repro_torch.launch import distributed as dist_defaults
from repro_torch.league import LeagueSpec, build_runtime, make_game_mgr
from repro_torch.league.runtime import role_params
from repro_torch.learners import DataServer, Learner, build_env_train_step
from repro_torch.optim import adamw
from repro_torch.utils import resolve_device


def run_league_training(*, env_name="pommerman_lite", arch="tleague-policy-s",
                        game_mgr="sp_pfsp", loss="ppo", num_envs=16,
                        unroll_len=16, periods=2, steps_per_period=16,
                        num_actors=1, num_exploiters=0, pbt=False,
                        lr=3e-4, seed=0, log_every=8, checkpoint_dir=None,
                        served=False, verbose=True, league_spec=None,
                        sampler="uniform", device=None):
    """`served=True` runs the SEED-style actor mode (ROADMAP next step):
    every Actor routes its policy forwards through ONE shared
    continuous-batching InfServer instead of per-actor jitted forwards —
    θ and each lineage's φ ride the same grouped batch as server routes.

    `league_spec` (a LeagueSpec) builds the population from role specs —
    role matchmaking and reset-on-freeze policies apply, while freezing
    stays on the fixed `periods x steps_per_period` schedule (the `--sync`
    determinism path). Without a spec, the legacy main+N-exploiters layout
    is used.

    `sampler` picks the replay strategy per `repro_torch.learners.samplers`;
    non-uniform samplers run each DataServer off-policy (blocking=False)
    so old rows stay sampleable.

    Everything runs on `device` (CUDA when None). Agent i's seed params
    come from `role_params`, as in the other modes; the actors' generators
    are seeded as `repro` seeds its actors' keys, though the two
    frameworks' random streams differ."""
    dev = resolve_device(device)
    env = make_env(env_name, device=dev)
    cfg = get_arch(arch)
    league = LeagueMgr(pbt=pbt, seed=seed)
    opt = adamw(lr, clip_norm=1.0)
    if league_spec is not None:
        total_actors = league_spec.num_actors_total
    else:
        total_actors = num_actors * (1 + num_exploiters)
    inf_server = None
    if served:
        # each rollout step submits one row per env-slot per actor; cap the
        # queue so a full actor sweep rides one grouped flush
        inf_server = InfServer(
            cfg, env.spec.num_actions, seed=seed + 7919, device=dev,
            max_batch=max(64, num_envs * env.spec.num_agents * total_actors))

    if league_spec is not None:
        role_rows = [(r.name, r.num_actors,
                      lambda payoff, s, r=r: make_game_mgr(r, payoff=payoff, seed=s),
                      dict(role=r.role, gate=None,           # fixed-period driver
                           reset_on_freeze=r.reset_policy))
                     for r in league_spec]
    else:
        ids = ["main"] + [f"exploiter:{i}" for i in range(num_exploiters)]
        role_rows = [(aid, num_actors,
                      lambda payoff, s, aid=aid: GAME_MGRS[
                          game_mgr if aid == "main" else "exploiter"](
                              payoff=payoff, seed=s),
                      {})
                     for aid in ids]

    agents = {}
    for i, (aid, n_act, gm_fn, extra) in enumerate(role_rows):
        params = role_params(cfg, seed, i, dev)
        gm = gm_fn(league.payoff, seed + i)
        league.add_learning_agent(aid, params, game_mgr=gm, **extra)
        actors = [Actor(env, cfg, league, agent_id=aid, num_envs=num_envs,
                        unroll_len=unroll_len, seed=seed * 1000 + i * 100 + a,
                        inf_server=inf_server, device=dev)
                  for a in range(n_act)]
        step = build_env_train_step(cfg, env.spec.num_actions, opt, loss=loss)
        learner = Learner(league, step, opt, params, agent_id=aid,
                          data_server=DataServer(
                              sampler=sampler,
                              blocking=(sampler == "uniform"), device=dev),
                          device=dev)
        agents[aid] = (actors, learner)

    history = []
    t0 = time.time()
    for period in range(periods):
        for it in range(steps_per_period):
            for aid, (actors, learner) in agents.items():
                for actor in actors:
                    traj, _ = actor.run_segment()
                    learner.data_server.put(traj)
                m = learner.learn(num_steps=len(actors))
                if verbose and it % log_every == 0 and m:
                    tp = learner.data_server.throughput()
                    print(f"[train] p{period} it{it} {aid} "
                          f"loss={float(m['loss']):.3f} "
                          f"ent={float(m['entropy']):.3f} "
                          f"rfps={tp['rfps']:.0f} cfps={tp['cfps']:.0f}")
                row = {"period": period, "it": it, "agent": aid}
                if "loss" in m:
                    row["loss"] = float(m["loss"])
                else:
                    # learn() ran zero steps (DataServer not ready yet):
                    # mark the row instead of recording a bogus loss=nan
                    row["skipped"] = True
                history.append(row)
        for aid, (_, learner) in agents.items():
            new_key = learner.end_learning_period()
            if verbose:
                print(f"[train] period {period} end: {aid} froze -> {new_key}")

    state = league.league_state()
    state["wall_s"] = time.time() - t0
    if checkpoint_dir:
        save_league(f"{checkpoint_dir}/league.json", state)
        for aid, (_, learner) in agents.items():
            save_pytree(f"{checkpoint_dir}/{aid.replace(':', '_')}.npz",
                        learner.params)
    return league, agents, history


def run_league_training_async(spec, *, env_name="pommerman_lite",
                              arch="tleague-policy-s", loss="ppo",
                              num_envs=16, unroll_len=16, lr=3e-4, seed=0,
                              served=False, pbt=False, max_seconds=None,
                              max_freezes_per_role=None,
                              max_steps_per_role=None, verbose=True,
                              sampler="uniform", device=None):
    """The event-driven league runtime: one thread per Actor and per
    Learner, a coordinator applying the spec's freeze gates. Returns
    (league, runtime, report); raises if any worker failed, so a normal
    return IS the clean-shutdown certificate."""
    runtime = build_runtime(spec, env_name=env_name, arch=arch, loss=loss,
                            num_envs=num_envs, unroll_len=unroll_len, lr=lr,
                            seed=seed, served=served, pbt=pbt,
                            sampler=sampler, device=device)
    report = runtime.run(max_seconds=max_seconds,
                         max_freezes_per_role=max_freezes_per_role,
                         max_steps_per_role=max_steps_per_role)
    if verbose:
        print(f"[train:async] {report['frames_total']} frames in "
              f"{report['wall_s']:.1f}s ({report['frames_per_s']:.0f} fps), "
              f"{report['league']['num_freezes']} freezes "
              f"(mean latency {report['freeze_latency_s_mean']}s)")
    return runtime.league, runtime, report


def _main_distributed(args, spec):
    """Dispatch the multiprocess modes (`--workers` / `--role`) onto
    `repro_torch.launch.distributed`. Worker roles read the coordinator
    endpoint from `--connect` or the `LEAGUE_MGR_EP` env var (the name the
    k8s renderer injects; a `tcp://` scheme prefix is accepted and
    stripped). Every role prints its result as one JSON line."""
    import os

    from repro_torch.launch import distributed as dist

    def emit(role, result):
        # one write per line: the roles share their parent's stdout pipe,
        # and under `python -u` print's text and newline are two writes
        # that another process's line can fall between
        sys.stdout.write(json.dumps({"process": role, **result}, default=str) + "\n")
        sys.stdout.flush()

    def endpoint():
        ep = args.connect or os.environ.get("LEAGUE_MGR_EP", "")
        assert ep, f"--role {args.role} needs --connect or $LEAGUE_MGR_EP"
        return ep.removeprefix("tcp://")

    pool_eps = (args.pool_endpoints.split(",") if args.pool_endpoints
                else None)
    if args.workers is not None:
        assert args.role is None, "--workers spawns its own --role children"
        assert spec is not None, "--workers needs --league-spec"
        report = dist.run_multiprocess(
            spec, workers=args.workers, env_name=args.env, arch=args.arch,
            loss=args.loss, num_envs=args.num_envs,
            unroll_len=args.unroll_len, lr=args.lr, seed=args.seed,
            served=args.served, sharded=args.sharded, pbt=args.pbt,
            max_seconds=args.max_seconds, max_steps_per_role=args.max_steps,
            heartbeat_timeout_s=args.heartbeat_timeout,
            max_actor_restarts=args.max_actor_restarts, device=args.device)
        emit("coordinator", report)
        assert report["clean_shutdown"], (
            f"worker exit codes: {report['worker_exit_codes']}")
    elif args.role == "coordinator":
        assert spec is not None, "--role coordinator needs --league-spec"
        report = dist.run_coordinator(
            spec, env_name=args.env, arch=args.arch, seed=args.seed,
            served=args.served, sharded=args.sharded, pbt=args.pbt,
            bind=args.bind, max_seconds=args.max_seconds,
            max_steps_per_role=args.max_steps,
            lease_ttl_s=(args.lease_ttl if args.lease_ttl > 0 else None),
            actor_stale_s=args.actor_stale, device=args.device)
        emit("coordinator", report)
    elif args.role == "learner":
        emit("learner", dist.run_learner(
            args.league_role, endpoint(), env_name=args.env, arch=args.arch,
            loss=args.loss, lr=args.lr, seed=args.seed,
            num_envs=args.num_envs, unroll_len=args.unroll_len,
            data_bind=args.bind, advertise=args.advertise,
            heartbeat_timeout_s=args.heartbeat_timeout,
            pool_endpoints=pool_eps, device=args.device))
    elif args.role == "actor":
        emit("actor", dist.run_actor(
            args.league_role, endpoint(), actor_index=args.actor_index,
            env_name=args.env, arch=args.arch, num_envs=args.num_envs,
            unroll_len=args.unroll_len, seed=args.seed, served=args.served,
            heartbeat_timeout_s=args.heartbeat_timeout,
            pool_endpoints=pool_eps, device=args.device))
    elif args.role == "pool-replica":
        emit("pool-replica", dist.run_pool_replica(
            endpoint(), replica_index=args.replica_index,
            sync_interval_s=args.sync_interval, bind=args.bind,
            advertise=args.advertise,
            heartbeat_timeout_s=args.heartbeat_timeout))
    elif args.role == "infserver":
        emit("infserver", dist.run_infserver(
            endpoint(), env_name=args.env, arch=args.arch, seed=args.seed,
            sharded=args.sharded, bind=args.bind, advertise=args.advertise,
            heartbeat_timeout_s=args.heartbeat_timeout, device=args.device))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--env", default="pommerman_lite")
    ap.add_argument("--arch", default="tleague-policy-s")
    ap.add_argument("--game-mgr", default="sp_pfsp", choices=sorted(GAME_MGRS))
    ap.add_argument("--loss", default="ppo", choices=["ppo", "vtrace"])
    ap.add_argument("--num-envs", type=int, default=16)
    ap.add_argument("--collector-slots", type=int, default=None,
                    help="env slots per collector (the collector plane's "
                         "name for --num-envs; overrides it when given)")
    ap.add_argument("--sampler", default="uniform",
                    choices=["uniform", "prioritized", "episode"],
                    help="replay sampling strategy "
                         "(repro_torch.learners.samplers); non-uniform samplers "
                         "run the DataServer off-policy")
    ap.add_argument("--unroll-len", type=int, default=16)
    ap.add_argument("--periods", type=int, default=2)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--actors", type=int, default=1)
    ap.add_argument("--exploiters", type=int, default=0)
    ap.add_argument("--pbt", action="store_true")
    ap.add_argument("--served", action="store_true",
                    help="route all actor inference through one shared "
                         "continuous-batching InfServer (SEED-style)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--league-spec", default=None,
                    help="LeagueSpec JSON (roles + gates); runs the async "
                         "event-driven runtime unless --sync is given")
    ap.add_argument("--sync", action="store_true",
                    help="force the legacy lockstep loop (fixed-period "
                         "freezes; bit-deterministic under --seed)")
    ap.add_argument("--max-seconds", type=float, default=None,
                    help="async runtime: wall-clock stop condition")
    ap.add_argument("--max-freezes", type=int, default=None,
                    help="async runtime: stop once every role froze this "
                         "many times")
    ap.add_argument("--max-steps", type=int, default=None,
                    help="multiprocess mode: stop once every role's learner "
                         "reported this many steps")
    ap.add_argument("--device", default=None,
                    help="torch device for every role (default: CUDA, "
                         "raising without a card; 'cpu' runs the plain "
                         "PyTorch versions); --workers passes it on")
    # -- multiprocess / distributed flags (repro_torch.launch.distributed) ---
    ap.add_argument("--workers", type=int, default=None,
                    help="spawn a multiprocess league: one learner process "
                         "per role plus N actor processes, this process "
                         "coordinating over the RPC transport")
    ap.add_argument("--role", default=None,
                    choices=["coordinator", "learner", "actor", "infserver",
                             "pool-replica"],
                    help="run exactly one league role in this process "
                         "(pair with --connect, or --bind for coordinator)")
    ap.add_argument("--league-role", default="main",
                    help="--role learner/actor: which LeagueSpec role this "
                         "process works for")
    ap.add_argument("--actor-index", type=int, default=0,
                    help="--role actor: index for seeding/telemetry")
    ap.add_argument("--connect", default=None,
                    help="coordinator endpoint host:port (worker roles); "
                         "defaults to $LEAGUE_MGR_EP")
    ap.add_argument("--bind", default="127.0.0.1:0",
                    help="listen address for the socket this role serves "
                         "(coordinator: league RPC; learner: its "
                         "DataServer; infserver: the serving RPC). Bind "
                         "0.0.0.0 for multi-host layouts — a wildcard "
                         "bind is advertised to peers as this hostname")
    ap.add_argument("--advertise", default=None,
                    help="--role learner/infserver: address to register "
                         "with the coordinator instead of the bound "
                         "socket (k8s: the Service DNS name, so replicas "
                         "load-balance and restarts keep the address)")
    ap.add_argument("--sharded", action="store_true",
                    help="with --served: shard the InfServer's grouped "
                         "forward over the local ('data','model') mesh")
    ap.add_argument("--heartbeat-timeout", type=float, default=30.0,
                    help="worker roles: seconds without a coordinator "
                         "heartbeat advance before this process treats "
                         "the coordinator as dead and shuts down cleanly")
    # -- robustness flags (leases / replicas / supervision) -------------------
    ap.add_argument("--pool-endpoints", default=None,
                    help="--role learner/actor: comma list of ModelPool "
                         "read endpoints (replicas first for actors, "
                         "coordinator first for learners); pulls fail over "
                         "across the list, writes stay on the coordinator")
    ap.add_argument("--replica-index", type=int, default=0,
                    help="--role pool-replica: index for telemetry and the "
                         "ctrl-plane endpoint name")
    ap.add_argument("--sync-interval", type=float, default=0.5,
                    help="--role pool-replica: seconds between primary "
                         "sync cycles")
    ap.add_argument("--lease-ttl", type=float,
                    default=dist_defaults.DEFAULT_LEASE_TTL_S,
                    help="coordinator: task-lease TTL in seconds; an "
                         "unreported task is re-issued after this long "
                         "without an actor beat extension (<=0 disables "
                         "the lease plane entirely)")
    ap.add_argument("--actor-stale", type=float,
                    default=dist_defaults.DEFAULT_ACTOR_STALE_S,
                    help="coordinator: seconds without an actor beat "
                         "before its leases are reaped immediately")
    ap.add_argument("--max-actor-restarts", type=int,
                    default=dist_defaults.DEFAULT_ACTOR_RESTARTS,
                    help="--workers mode: per-slot respawn budget for "
                         "crashed actor children")
    args = ap.parse_args()
    if args.collector_slots is not None:
        args.num_envs = args.collector_slots

    spec = LeagueSpec.from_json(args.league_spec) if args.league_spec else None
    if args.workers is not None or args.role is not None:
        _main_distributed(args, spec)
        return
    if spec is not None and not args.sync:
        league, _, report = run_league_training_async(
            spec, env_name=args.env, arch=args.arch, loss=args.loss,
            num_envs=args.num_envs, unroll_len=args.unroll_len, lr=args.lr,
            seed=args.seed, served=args.served, pbt=args.pbt,
            max_seconds=args.max_seconds, max_freezes_per_role=args.max_freezes,
            sampler=args.sampler, device=args.device)
        print(json.dumps(report, indent=1))
        return
    league, _, _ = run_league_training(
        env_name=args.env, arch=args.arch, game_mgr=args.game_mgr,
        loss=args.loss, num_envs=args.num_envs, unroll_len=args.unroll_len,
        periods=args.periods, steps_per_period=args.steps,
        num_actors=args.actors, num_exploiters=args.exploiters, pbt=args.pbt,
        lr=args.lr, seed=args.seed, checkpoint_dir=args.checkpoint_dir,
        served=args.served, league_spec=spec, sampler=args.sampler,
        device=args.device)
    print(json.dumps(league.league_state(), indent=1))


if __name__ == "__main__":
    main()
