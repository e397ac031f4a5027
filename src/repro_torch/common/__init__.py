"""Shared helpers: device choice, parameter trees and the task-vector
layout manifest.  The tree helpers are exported here as the JAX
package's ``repro.common`` exports them."""

from repro_torch.common import tree
from repro_torch.common.tree import (
    tree_size,
    tree_flatten_vector,
    tree_unflatten_vector,
    tree_zeros_like,
    tree_add,
    tree_sub,
    tree_scale,
    tree_dot,
    tree_norm,
    tree_cast,
)

__all__ = [
    "tree",
    "tree_size",
    "tree_flatten_vector",
    "tree_unflatten_vector",
    "tree_zeros_like",
    "tree_add",
    "tree_sub",
    "tree_scale",
    "tree_dot",
    "tree_norm",
    "tree_cast",
]
