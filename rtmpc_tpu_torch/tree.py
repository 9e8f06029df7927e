"""NamedTuple-of-tensors helpers: the port's stand-in for JAX pytrees.

Specs, solver states and rollout carries are (nested) NamedTuples whose
leaves are tensors.  ``tree_map`` walks them the way
``jax.tree_util.tree_map`` walks the JAX package's pytrees.
"""

from __future__ import annotations

import torch

__all__ = ["tree_map", "tree_to"]


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leaf-wise over one or more NamedTuples of the same
    structure; ``None`` leaves stay ``None``."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *leaves)
                            for leaves in zip(tree, *rest)))
    raise TypeError(f"tree_map: unsupported node {type(tree).__name__}")


def tree_to(tree, device):
    """Copy of ``tree`` with every tensor moved to ``device``."""
    return tree_map(lambda a: a.to(device), tree)
