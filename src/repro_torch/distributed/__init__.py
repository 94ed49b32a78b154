"""Distribution for the port; counterpart of `repro.distributed`. Only the
in-process heartbeat is here so far: the transport, the RPC heartbeat
monitor and sharding come with ROADMAP queue 1 items 7 and 8."""
from repro_torch.distributed.heartbeat import BeatRegistry, Heartbeat
