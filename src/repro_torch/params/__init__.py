"""Param trees between `repro` (numpy leaves) and the port (tensors)."""
from repro_torch.params.convert import from_reference, to_reference
