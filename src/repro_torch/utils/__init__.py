"""Framework glue shared by the port's modules."""
from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import tree_global_norm, tree_leaves, tree_map, tree_stack
from repro_torch.utils.registry import Registry

__all__ = ["Registry", "resolve_device", "tree_global_norm", "tree_leaves", "tree_map",
           "tree_stack"]
