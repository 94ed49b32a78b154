"""The serving-gateway plane: route a replica fleet by lineage and
occupancy (see `docs/architecture.md`, "The nine planes"); counterpart of
`repro.serving`."""
from repro_torch.serving.gateway import (AdmissionRejected, DeadlineBuckets,
                                         GatewayBackend, GatewayTicket,
                                         ServingGateway)
from repro_torch.serving.router import (LeastLoadedRouter, LineageRouter,
                                        NoReplicas, ReplicaView,
                                        RoundRobinRouter, Router, ROUTERS,
                                        lineage_of, make_router)

__all__ = [
    "AdmissionRejected", "DeadlineBuckets", "GatewayBackend", "GatewayTicket",
    "ServingGateway", "LeastLoadedRouter", "LineageRouter", "NoReplicas",
    "ReplicaView", "RoundRobinRouter", "Router", "ROUTERS", "lineage_of",
    "make_router",
]
