"""Param trees between `repro` (numpy leaves) and the port (tensors), and
the param plane: versioned, content-addressed parameter distribution
(`ParamManifest` per hosted tree, `NotModified` tags, changed-leaf deltas
and cross-key hash references, consumed through `CachedPuller`)."""
from repro_torch.params.cache import CachedPuller
from repro_torch.params.convert import from_reference, opt_state_from_reference, to_reference
from repro_torch.params.manifest import (NotModified, ParamDelta, ParamManifest,
                                         apply_delta, build_manifest,
                                         flatten_with_paths, leaf_hash)

__all__ = ["CachedPuller", "NotModified", "ParamDelta", "ParamManifest", "apply_delta",
           "build_manifest", "flatten_with_paths", "from_reference", "leaf_hash",
           "opt_state_from_reference", "to_reference"]
