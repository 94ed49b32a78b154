"""Distribution for the port; counterpart of `repro.distributed`: the RPC
transport the league's processes talk over, liveness, and the sharding
rules of the mesh (`sharding`, imported by its own name)."""
from repro_torch.distributed.heartbeat import (BeatRegistry, Heartbeat,
                                               HeartbeatMonitor, probe)
from repro_torch.distributed.transport import (
    CODEC, DataServerClient, FaultPlan, FaultRule, InfServerBackend,
    InfServerClient, LeagueMgrClient, ModelPoolClient, RemoteError,
    RetryableError, RetryPolicy, RpcClient, RpcServer, TransportError,
    serve_league)
