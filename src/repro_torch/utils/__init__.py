"""Framework glue shared by the port's modules."""
from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import (
    tree_add,
    tree_bytes,
    tree_cast,
    tree_copy,
    tree_count_params,
    tree_flatten_with_path,
    tree_global_norm,
    tree_leaves,
    tree_lerp,
    tree_map,
    tree_scale,
    tree_stack,
    tree_unflatten,
    tree_zeros_like,
)
from repro_torch.utils.registry import Registry

__all__ = ["Registry", "resolve_device", "tree_add", "tree_bytes", "tree_cast", "tree_copy",
           "tree_count_params", "tree_flatten_with_path", "tree_global_norm", "tree_leaves",
           "tree_lerp", "tree_map", "tree_scale", "tree_stack", "tree_unflatten",
           "tree_zeros_like"]
