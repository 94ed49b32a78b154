"""Cloud-native launcher: render the k8s spec for a distributed run (§3.4);
a copy of `repro.launch.k8s` with three changes: the rendered commands run
`repro_torch.launch.train` / `.serve` (and the heartbeat probe
`repro_torch.distributed.heartbeat`), the accelerator is
`nvidia.com/gpu: 1` in place of `google.com/tpu: 1`, and the accelerator
node pool is `gpu-h100` in place of `tpu-v5e`. Nothing else in the
rendering changes, so the inf-server block still carries `--sharded`,
which the port's InfServer raises on until ROADMAP queue 1 item 8.

The paper prepares one yml.jinja2 per training ("56 Learners, 8 InfServers,
each Learner 1 GPU, every 7 Learners + 1 InfServer co-located...") and runs
`render_template | kubectl apply -f -`. This module is that renderer,
dependency-free: the coordinator (LeagueMgr + ModelPool + ctrl plane),
Learners, InfServers as Services, Actors as a high-replica Deployment
(auto-restart on env crashes per the k8s imperative semantics),
nodeSelector co-location, all RL + league hyperparameters in the spec.

Every rendered command line is the REAL `repro_torch.launch.train` CLI — the
same flags a laptop run uses (README "Mesh-sharded serving +
multiprocess league"):

  * coordinator: `--role coordinator --league-spec <path> [--served]`
    — hosts LeagueMgr + the AUTHORITATIVE ModelPool behind the RPC
    transport (`repro_torch.distributed.transport`); all writes land here.
  * pool-replica: `--role pool-replica` — the paper's M_M ModelPool
    read replicas as their own Deployment: each follows the
    coordinator's pool via hash-gated delta pulls and serves the read
    protocol; actors pull through the replica Service first and fail
    over to the coordinator (`--pool-endpoints`).
  * learner:     `--role learner --league-role <role>` — finds the
    coordinator via the injected `LEAGUE_MGR_EP` env var.
  * actor:       `--role actor --league-role <role> [--served]`.
  * inf-server:  `--role infserver --sharded` — the mesh-sharded grouped
    θ+φ forward over the node's accelerator mesh.

Every pod carries liveness/readiness probes backed by the worker
heartbeat plane (`repro_torch.distributed.heartbeat`): roles that bind an RPC
socket (coordinator / learner / inf-server) get tcpSocket probes on it,
and the portless actor Deployment execs the heartbeat probe CLI
(`python -m repro_torch.distributed.heartbeat <coordinator> --timeout 5`) —
the same channel the workers themselves use to tell a slow coordinator
from a dead one (`--heartbeat-timeout`).

The single-host determinism fallback (no cluster) is the same image with
`--league-spec <path> --sync` — the bit-deterministic lockstep loop.
On a GPU cloud the Learner block becomes a JobSet over the node pool;
the rendered spec is what `kubectl apply` would take.

  PYTHONPATH=src python -m repro_torch.launch.k8s --learners 56 --inf-servers 8 \
      --actors-per-learner 16 | kubectl apply -f -   # (on a real cluster)
"""
from __future__ import annotations

import argparse

# the rendered restart-budget annotations mirror the in-process values so
# the two supervision layers agree: kubelet's crash-loop backoff takes over
# exactly where run_multiprocess's respawn budget and the RPC clients'
# retry deadline leave off
from repro_torch.distributed.transport import RetryPolicy
from repro_torch.launch.distributed import DEFAULT_ACTOR_RESTARTS

SERVICE_TMPL = """\
---
apiVersion: v1
kind: Service
metadata:
  name: {signature}-{role}
  labels: {{app: {signature}, role: {role}}}
spec:
  selector: {{app: {signature}, role: {role}}}
  ports: [{{port: {port}, targetPort: {port}}}]
---
apiVersion: apps/v1
kind: Deployment
metadata:
  name: {signature}-{role}
spec:
  replicas: {replicas}
  selector: {{matchLabels: {{app: {signature}, role: {role}}}}}
  template:
    metadata:
      labels: {{app: {signature}, role: {role}}}
{annotations}    spec:
      nodeSelector: {{pool: {node_pool}}}
      containers:
      - name: {role}
        image: {image}
        command: ["python", "-m", "{module}"]
        args: {args}
        resources:
          requests: {{cpu: "{cpus}"{accel}}}
          limits: {{cpu: "{cpus}"{accel}}}
{probes}        env:
        - {{name: LEAGUE_MGR_EP, value: "tcp://{signature}-coordinator:9003"}}
        - {{name: MODEL_POOL_EP, value: "tcp://{signature}-coordinator:9003"}}
"""

# roles that bind an RPC socket are probed on it (the accept loop IS the
# worker's liveness); portless roles (actors) exec the heartbeat probe
# CLI against the coordinator — an actor whose coordinator is gone or
# wedged exits by heartbeat timeout anyway, and the probe makes kubelet
# restart it promptly so the fleet reattaches when the coordinator
# Service comes back
_TCP_PROBES_TMPL = """\
        readinessProbe:
          tcpSocket: {{port: {port}}}
          initialDelaySeconds: 5
          periodSeconds: 10
          timeoutSeconds: 5
        livenessProbe:
          tcpSocket: {{port: {port}}}
          initialDelaySeconds: 20
          periodSeconds: 10
          timeoutSeconds: 5
          failureThreshold: 3
"""

# the serving-gateway fleet renders as a StatefulSet behind a HEADLESS
# Service: the gateway routes by lineage/occupancy across INDIVIDUAL
# replicas, so it needs the stable per-pod DNS names
# ({signature}-serve-replica-N.{signature}-serve-replica:port), not a
# load-balanced ClusterIP that would hide the fleet behind one VIP
STATEFULSET_TMPL = """\
---
apiVersion: v1
kind: Service
metadata:
  name: {signature}-{role}
  labels: {{app: {signature}, role: {role}}}
spec:
  clusterIP: None
  selector: {{app: {signature}, role: {role}}}
  ports: [{{port: {port}, targetPort: {port}}}]
---
apiVersion: apps/v1
kind: StatefulSet
metadata:
  name: {signature}-{role}
spec:
  serviceName: {signature}-{role}
  replicas: {replicas}
  selector: {{matchLabels: {{app: {signature}, role: {role}}}}}
  template:
    metadata:
      labels: {{app: {signature}, role: {role}}}
{annotations}    spec:
      nodeSelector: {{pool: {node_pool}}}
      containers:
      - name: {role}
        image: {image}
        command: ["python", "-m", "{module}"]
        args: {args}
        resources:
          requests: {{cpu: "{cpus}"{accel}}}
          limits: {{cpu: "{cpus}"{accel}}}
{probes}"""

# timeoutSeconds must cover interpreter startup + the probe's own
# --timeout 5 budget; k8s's 1s default would kill every slow-but-healthy
# probe run and restart the whole actor fleet
_EXEC_PROBE_TMPL = """\
        livenessProbe:
          exec:
            command: ["python", "-m", "repro_torch.distributed.heartbeat",
                      "{coordinator}:9003", "--timeout", "5"]
          initialDelaySeconds: 30
          periodSeconds: 15
          timeoutSeconds: 15
          failureThreshold: 4
"""


def render(*, signature="tleague", image="repro:latest", learners=8,
           inf_servers=2, actors_per_learner=16, pool_replicas=1,
           serving_replicas=0, actor_cpus=4,
           learner_accel="nvidia.com/gpu: 1",
           env="pommerman_lite", arch="tleague-policy-s",
           league_spec="/config/league_spec.json", league_role="main",
           served=True, lr=3e-4):
    """Render the full multiprocess league as k8s Services/Deployments.

    `league_spec` is the LeagueSpec JSON path inside the image (mount it
    via a ConfigMap); `league_role` is the role the rendered learner and
    actor blocks work for — render once per role for a multi-role league.
    `served=True` adds `--served` so actors route policy forwards through
    the sharded inf-server deployment (and only there: the coordinator
    must not also host one, or the two would race for the `inf/shared`
    endpoint). `learners` sizes the ACTOR fleet (learners ×
    actors_per_learner, the paper's co-location ratio); the learner
    Deployment itself is always replicas=1 per role — params are
    single-writer, and M_L data parallelism is inside the pjit step.

    `serving_replicas` > 0 renders the serving-gateway plane: a
    StatefulSet of standalone InfServer replicas (`repro_torch.launch.serve
    --replica`) behind a HEADLESS Service (stable per-pod DNS), plus a
    gateway Deployment (`--gateway`) that fronts the individual replica
    endpoints with lineage routing, occupancy spill, deadline-bucket
    SLO flushes and admission control — external inference consumers
    (the millions-of-users path) connect to the gateway Service on
    9010 with the plain `InfServerClient` protocol. This fleet is
    separate from the league-internal `inf_servers` deployment: league
    actors keep their co-located sharded servers; the gateway fleet
    serves policy queries to the outside.

    `pool_replicas` > 0 renders the paper's M_M ModelPool replica fleet:
    a read-replica Deployment that follows the coordinator's pool via
    hash-gated delta pulls. Actors read pool state with the replica
    Service FIRST and the coordinator as fallback (`--pool-endpoints
    replica,coordinator`); learners keep the coordinator first (their
    post-freeze adopt must see the minted key immediately) with the
    replica as fallback. Writes always land on the coordinator — the
    client pins them regardless of the read path."""
    common = dict(signature=signature, image=image)
    base = ["--env", env, "--arch", arch]
    serve_flag = ["--served"] if served else []

    def fmt(args: list) -> str:
        return "[" + ", ".join(f'"{a}"' for a in args) + "]"

    def tcp_probes(port: int) -> str:
        return _TCP_PROBES_TMPL.format(port=port)

    exec_probe = _EXEC_PROBE_TMPL.format(coordinator=f"{signature}-coordinator")

    # crash-loop budget annotations: kubelet's restartPolicy Always +
    # exponential backoff picks up where the in-process layers stop, and
    # these annotations record the handoff point so an operator reading
    # the pod spec sees the SAME numbers the code enforces
    pol = RetryPolicy()
    restart_annotations = (
        "      annotations:\n"
        f"        repro.dev/in-process-restart-budget: \"{DEFAULT_ACTOR_RESTARTS}\"\n"
        f"        repro.dev/rpc-retry-backoff: "
        f"\"base={pol.base_s}s cap={pol.cap_s}s deadline={pol.deadline_s}s\"\n")

    coord_ep = f"{signature}-coordinator:9003"
    replica_ep = f"{signature}-pool-replica:9008"
    actor_pool_eps = ([replica_ep, coord_ep] if pool_replicas > 0
                      else None)
    learner_pool_eps = ([coord_ep, replica_ep] if pool_replicas > 0
                        else None)

    blocks = []
    # the coordinator must NOT get --served when dedicated inf-server
    # deployments exist: both would register the single `inf/shared`
    # endpoint and early actors would cache whichever won the race —
    # usually the coordinator's unsharded CPU server
    coord_serve = serve_flag if inf_servers == 0 else []
    blocks.append(SERVICE_TMPL.format(
        role="coordinator", port=9003, replicas=1, node_pool="cpu-highmem",
        module="repro_torch.launch.train",
        args=fmt(["--role", "coordinator", "--league-spec", league_spec,
                  "--bind", "0.0.0.0:9003"] + base + coord_serve),
        cpus=8, accel="", probes=tcp_probes(9003), annotations="", **common))
    if pool_replicas > 0:
        # the M_M replica fleet: follows the coordinator's pool via delta
        # pulls, serves the read protocol to actors; restartPolicy Always
        # means a killed replica re-syncs and rejoins, and the actors'
        # failover client covers the gap from the coordinator directly
        blocks.append(SERVICE_TMPL.format(
            role="pool-replica", port=9008, replicas=pool_replicas,
            node_pool="cpu-highmem", module="repro_torch.launch.train",
            args=fmt(["--role", "pool-replica", "--bind", "0.0.0.0:9008",
                      "--advertise", replica_ep] + base),
            cpus=4, accel="", probes=tcp_probes(9008),
            annotations=restart_annotations, **common))
    # ONE learner process per role: the lineage's params are single-writer
    # (see LeagueMgr.end_learning_period) — M_L-way data parallelism lives
    # INSIDE the learner's pjit'd train step over its node's mesh, not in
    # pod replicas. Render once per role for a multi-role league.
    blocks.append(SERVICE_TMPL.format(
        role="learner", port=9005, replicas=1, node_pool="gpu-h100",
        module="repro_torch.launch.train",
        args=fmt(["--role", "learner", "--league-role", league_role,
                  "--lr", str(lr), "--bind", "0.0.0.0:9005",
                  "--advertise", f"{signature}-learner:9005"] + base
                 + (["--pool-endpoints", ",".join(learner_pool_eps)]
                    if learner_pool_eps else [])),
        cpus=16, accel=", " + learner_accel, probes=tcp_probes(9005),
        annotations="", **common))
    blocks.append(SERVICE_TMPL.format(
        role="inf-server", port=9006, replicas=inf_servers,
        node_pool="gpu-h100", module="repro_torch.launch.train",
        args=fmt(["--role", "infserver", "--sharded",
                  "--bind", "0.0.0.0:9006",
                  "--advertise", f"{signature}-inf-server:9006"] + base),
        cpus=8, accel=", " + learner_accel, probes=tcp_probes(9006),
        annotations="", **common))
    if serving_replicas > 0:
        # the serving-gateway plane: replica StatefulSet (headless, so
        # the gateway sees individual pods) + the gateway front door
        replica_port, gateway_port = 9009, 9010
        blocks.append(STATEFULSET_TMPL.format(
            role="serve-replica", port=replica_port,
            replicas=serving_replicas, node_pool="gpu-h100",
            module="repro_torch.launch.serve",
            args=fmt(["--replica", "--bind", f"0.0.0.0:{replica_port}",
                      "--arch", arch, "--env", env]),
            cpus=8, accel=", " + learner_accel,
            probes=tcp_probes(replica_port),
            annotations=restart_annotations, **common))
        replica_eps = ",".join(
            f"{signature}-serve-replica-{i}.{signature}-serve-replica:"
            f"{replica_port}" for i in range(serving_replicas))
        blocks.append(SERVICE_TMPL.format(
            role="gateway", port=gateway_port, replicas=1,
            node_pool="cpu-highmem", module="repro_torch.launch.serve",
            args=fmt(["--gateway", "--bind", f"0.0.0.0:{gateway_port}",
                      "--replica-endpoints", replica_eps,
                      "--router", "lineage"]),
            cpus=8, accel="", probes=tcp_probes(gateway_port),
            annotations=restart_annotations, **common))
    blocks.append(SERVICE_TMPL.format(
        role="actor", port=9007, replicas=learners * actors_per_learner,
        node_pool="cpu", module="repro_torch.launch.train",
        args=fmt(["--role", "actor", "--league-role", league_role]
                 + base + serve_flag
                 + (["--pool-endpoints", ",".join(actor_pool_eps)]
                    if actor_pool_eps else [])),
        cpus=actor_cpus, accel="", probes=exec_probe,
        annotations=restart_annotations, **common))
    return "".join(blocks)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--signature", default="tleague")
    ap.add_argument("--learners", type=int, default=8)
    ap.add_argument("--inf-servers", type=int, default=2)
    ap.add_argument("--actors-per-learner", type=int, default=16)
    ap.add_argument("--pool-replicas", type=int, default=1,
                    help="ModelPool read-replica Deployment size (0 "
                         "renders the legacy coordinator-only read path)")
    ap.add_argument("--serving-replicas", type=int, default=0,
                    help="serving-gateway fleet size: N standalone "
                         "InfServer replicas (StatefulSet, headless "
                         "Service) behind one gateway Deployment (0 "
                         "renders no gateway plane)")
    ap.add_argument("--env", default="pommerman_lite")
    ap.add_argument("--arch", default="tleague-policy-s")
    ap.add_argument("--league-spec", default="/config/league_spec.json")
    ap.add_argument("--league-role", default="main")
    ap.add_argument("--no-served", dest="served", action="store_false")
    args = ap.parse_args()
    print(render(signature=args.signature, learners=args.learners,
                 inf_servers=args.inf_servers,
                 actors_per_learner=args.actors_per_learner,
                 pool_replicas=args.pool_replicas,
                 serving_replicas=args.serving_replicas,
                 env=args.env, arch=args.arch, league_spec=args.league_spec,
                 league_role=args.league_role, served=args.served))


if __name__ == "__main__":
    main()
