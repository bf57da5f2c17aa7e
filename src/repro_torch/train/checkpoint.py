"""Async, atomic checkpoints (port of ``repro/train/checkpoint.py``), in
the reference's on-disk format, so that each package reads the other's:

    <dir>/step_00000100.tmp/...   -- written here first
    <dir>/step_00000100/          -- atomic rename on completion
        manifest.json             -- {"step", "leaves": [{"key", "file", "shape", "dtype"}]}
        arr_00000.npy ...         -- one .npy a leaf (full, unsharded)

Leaves are in JAX's flattening order and carry the key strings that
``jax.tree_util.keystr`` gives them: a :class:`~repro_torch.train.
train_loop.TrainState`'s children are (params, opt_state, step) and read
``[<flat index 0>]`` .. ``[<flat index 2>]``, and a dict's keys come sorted
and read ``['name']``.  The keys are built here, with
no JAX import.  ``restore`` matches leaves by key and raises on a shape
mismatch.

  * **atomic**: a crash mid-write never corrupts the latest checkpoint
    (readers see only renamed directories);
  * **async**: ``save_async`` copies every leaf to host memory before it
    returns (a copy, not a view that the next step's in-place update would
    overwrite) and writes in a background thread;
  * **self-pruning**: the newest ``keep`` checkpoints stay.

bfloat16 leaves are refused: numpy has no bfloat16 without the package
that JAX brings (``ml_dtypes``), which the port does not need.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

Tree = Any

_STEP_RE = re.compile(r"^step_(\d+)$")


def _flatten_with_paths(tree: Tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(key string, leaf)] in JAX's flattening order."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        out = []
        for i, f in enumerate(dataclasses.fields(tree)):
            out += _flatten_with_paths(getattr(tree, f.name), f"{prefix}[<flat index {i}>]")
        return out
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flatten_with_paths(tree[k], f"{prefix}[{k!r}]")]
    return [(prefix, tree)]


def _unflatten_like(tree: Tree, leaves) -> Tree:
    """``tree``'s structure with its leaves taken in order from the iterator
    ``leaves``."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(*(_unflatten_like(getattr(tree, f.name), leaves)
                            for f in dataclasses.fields(tree)))
    if isinstance(tree, dict):
        return {k: _unflatten_like(tree[k], leaves) for k in sorted(tree)}
    return next(leaves)


def _host(leaf) -> np.ndarray:
    """A leaf as a numpy array that owns its data (a copy of a tensor on any
    device)."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError("bfloat16 leaves cannot be written as .npy without ml_dtypes")
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


def save(dirpath: str, step: int, tree: Tree, keep: int = 3) -> str:
    """Synchronous atomic save.  Returns the final checkpoint path."""
    host = [(k, _host(v)) for k, v in _flatten_with_paths(tree)]
    return _write(dirpath, step, host, keep)


def save_async(dirpath: str, step: int, tree: Tree, keep: int = 3) -> threading.Thread:
    """Device -> host copy now; the disk write in a daemon thread."""
    host = [(k, _host(v)) for k, v in _flatten_with_paths(tree)]  # blocks on the copy only
    t = threading.Thread(target=_write, args=(dirpath, step, host, keep), daemon=True)
    t.start()
    return t


def _write(dirpath: str, step: int, host_leaves, keep: int) -> str:
    os.makedirs(dirpath, exist_ok=True)
    final = os.path.join(dirpath, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": []}
    for i, (key, arr) in enumerate(host_leaves):
        fname = f"arr_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append(
            {"key": key, "file": fname, "shape": list(arr.shape), "dtype": str(arr.dtype)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    _prune(dirpath, keep)
    return final


def _prune(dirpath: str, keep: int) -> None:
    steps = sorted(list_steps(dirpath))
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(dirpath, f"step_{s:08d}"), ignore_errors=True)


def list_steps(dirpath: str) -> List[int]:
    if not os.path.isdir(dirpath):
        return []
    out = []
    for name in os.listdir(dirpath):
        m = _STEP_RE.match(name)
        if m and os.path.exists(os.path.join(dirpath, name, "manifest.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(dirpath: str) -> Optional[int]:
    steps = list_steps(dirpath)
    return steps[-1] if steps else None


def restore(dirpath: str, like: Tree, step: Optional[int] = None) -> Tuple[Tree, int]:
    """Restore into the structure of ``like`` (the latest step unless
    ``step``): each leaf the saved array, in its saved dtype, as a tensor on
    the device of ``like``'s leaf.  Partially written (.tmp) checkpoints are
    invisible by construction.  Raises KeyError for a leaf the checkpoint
    lacks and ValueError for a shape mismatch."""
    if step is None:
        step = latest_step(dirpath)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {dirpath}")
    path = os.path.join(dirpath, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    by_key = {leaf["key"]: leaf for leaf in manifest["leaves"]}
    leaves = []
    for key, ref in _flatten_with_paths(like):
        arr = np.load(os.path.join(path, by_key[key]["file"]))
        if list(arr.shape) != list(ref.shape):
            raise ValueError(f"shape mismatch for {key}: {arr.shape} vs {tuple(ref.shape)}")
        device = ref.device if isinstance(ref, torch.Tensor) else "cpu"
        leaves.append(torch.from_numpy(arr).to(device))
    return _unflatten_like(like, iter(leaves)), step
