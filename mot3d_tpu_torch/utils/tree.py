"""Maps over nested containers of arrays: the port's stand-in for
`jax.tree_util` where a batch, its draws or a step's outputs travel as
NamedTuples, tuples, lists and dicts of numpy arrays or tensors."""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch


def tree_map(fn: Callable, tree: Any) -> Any:
    """Map `fn` over the array leaves of nested NamedTuples, tuples, lists
    and dicts (numpy arrays and tensors are leaves; other values stay)."""
    if isinstance(tree, (np.ndarray, torch.Tensor)):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return tree


def leaves(tree: Any) -> list:
    """The array leaves of `tree`, in `tree_map`'s order."""
    out = []
    tree_map(out.append, tree)
    return out


def as_tensor(x) -> torch.Tensor:
    """A tensor as it is; a numpy array as a tensor on the CPU (sharing its
    memory when it is contiguous)."""
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))
