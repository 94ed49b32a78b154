"""Param and optimizer-state trees between `repro` (numpy leaves) and the
port (tensors)."""
from repro_torch.params.convert import from_reference, opt_state_from_reference, to_reference
