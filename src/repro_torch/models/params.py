"""Parameter trees shared by the models: nested dicts of tensors, walked in
sorted-key order (JAX's flattening order), and the JAX package's trees
carried across."""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

Params = Dict[str, Any]


def tree_map(fn, tree: Params, prefix: str = "") -> Params:
    """``fn(dotted name, leaf)`` on every leaf of a nested dict, keys sorted
    (the JAX tree's flattening order)."""
    return {k: tree_map(fn, tree[k], f"{prefix}{k}.") if isinstance(tree[k], dict)
            else fn(prefix + k, tree[k]) for k in sorted(tree)}


def from_numpy(tree: Params, shapes: Params, device: torch.device, dtype: torch.dtype) -> Params:
    """The JAX package's parameter tree (numpy or JAX arrays, bfloat16 ones
    included) as the port's: the same leaves, on ``device``, in ``dtype``.
    Raises unless ``tree`` has exactly the leaves and shapes of ``shapes``
    (a tree of shape tuples)."""

    def walk(t, s, prefix):
        if set(t) != set(s):
            raise ValueError(f"parameter tree {prefix or 'root'} has keys {sorted(t)}, want "
                             f"{sorted(s)}")
        out = {}
        for k in sorted(s):
            if isinstance(s[k], dict):
                out[k] = walk(t[k], s[k], f"{prefix}{k}.")
                continue
            a = np.asarray(t[k])
            x = (torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
                 if a.dtype.name == "bfloat16" else torch.from_numpy(np.array(a)))
            if tuple(x.shape) != tuple(s[k]):
                raise ValueError(f"{prefix}{k}: shape {tuple(x.shape)}, want {s[k]}")
            out[k] = x.to(device=device, dtype=dtype)
        return out

    return walk(tree, shapes, "")
