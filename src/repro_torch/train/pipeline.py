"""GPipe-style pipeline parallelism over a ``pipe`` mesh axis (port of
``repro/train/pipeline.py``).

Layers are split into S contiguous stages (one a pipe shard); a global
batch is cut into M microbatches that flow through the stages with
``ppermute`` hand-offs.  Schedule: plain GPipe (fill, steady state, drain:
S + M - 1 ticks); bubble fraction (S - 1) / (S + M - 1).

On the port's one-process mesh (``core/distributed.py``) the reference's
``shard_map`` body, which each shard runs on its own, becomes one loop over
the ticks that runs every stage in turn, each on its stage's device:

* shard i holds layers [i per, (i + 1) per) of the stacked (n_layers, ...)
  tree, per = n_layers // S (:func:`stage_params`; trailing layers past
  S per are dropped, as the reference's ``dynamic_slice`` drops them);
* at tick t stage i works on microbatch t - i and hands its output to
  stage i + 1, which files it in its queue slot for that microbatch;
* the stage body runs under ``torch.utils.checkpoint`` (the reference's
  ``jax.checkpoint``), so the backward recomputes each stage's forward
  from its saved input: GPipe's activation recomputation;
* gradients come from autograd through the tick loop, as the reference's
  come from ``jax.grad`` through the scan.

**Inactive ticks are skipped.**  The reference runs the stage body on
every tick and selects with ``where``; in a tick where its stage has no
microbatch it hands a stale input on, which lands in a queue slot that was
read already or is written again before it is read.  Here such a stage
computes and sends nothing, so the output is the same and each stage runs
its layers M times forward (twice with the recompute) and M times backward.
"""
from __future__ import annotations

from typing import Any, Callable, List, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import distributed
from repro_torch.train.optimizer import tree_leaves, tree_map

Tree = Any


def stage_params(params_stacked: Tree, stage: int, n_stages: int) -> Tree:
    """The stacked (n_layers, ...) layer tree cut to stage ``stage``'s
    (n_layers // n_stages, ...) block (views)."""

    def slc(x):
        per = x.shape[0] // n_stages
        return x.narrow(0, stage * per, per)

    return tree_map(slc, params_stacked)


def _unstack(tree: Tree) -> List[Tree]:
    """A stacked (L, ...) tree as L trees of (...) views: each leaf split
    once (``unbind``, whose gradient is one ``stack``)."""
    parts = tree_map(lambda x: x.unbind(0), tree)
    n = tree_leaves(tree)[0].shape[0]
    return [tree_map(lambda p, i=i: p[i], parts) for i in range(n)]


def gpipe_apply(layer_fn: Callable[[torch.Tensor, Tree], torch.Tensor], params_stacked: Tree,
                x: torch.Tensor, n_stages: int, devices: Sequence[torch.device]) -> torch.Tensor:
    """Run the pipeline over the stages' ``devices`` (one a stage);
    ``x`` is (M, mb, ...) microbatched activations.  Returns the final
    activations (M, mb, ...) on stage 0's device: the reference's closing
    ``psum`` of the last stage's output and zeros is that output."""
    if len(devices) != n_stages:
        raise ValueError(f"{len(devices)} devices for {n_stages} stages")
    m = x.shape[0]
    copies = {}  # the parameters on each stage's device (stages on one device share them)
    for d in devices:
        if d not in copies:
            copies[d] = tree_map(lambda t, d=d: distributed.move(t, d), params_stacked)
    layers = [_unstack(stage_params(copies[d], i, n_stages)) for i, d in enumerate(devices)]

    def stage_body(i: int, h: torch.Tensor) -> torch.Tensor:
        for layer in layers[i]:
            h = layer_fn(h, layer)
        return h

    # queue[i][j]: stage i's input for microbatch j; stage 0's is x, the
    # others' are filed by the hand-off before they are read.
    queue: List[List[Any]] = [list(distributed.move(x, devices[0]).unbind(0))]
    queue += [[None] * m for _ in range(1, n_stages)]
    out: List[Any] = [None] * m
    perm = [(i, i + 1) for i in range(n_stages - 1)]
    for t in range(n_stages + m - 1):
        sent = []
        for i in range(n_stages):
            j = t - i
            if not 0 <= j < m:
                sent.append(None)
                continue
            with distributed._on(devices[i]):
                h = checkpoint(stage_body, i, queue[i][j], use_reentrant=False)
            sent.append(h)
            if i == n_stages - 1:
                out[j] = h
        for src, dst in perm:
            if sent[src] is not None:
                queue[dst][t - src] = distributed.move(sent[src], devices[dst])
    return distributed.move(torch.stack(out), devices[0])


def build_gpipe_fn(mesh: distributed.Mesh, layer_fn: Callable[[torch.Tensor, Tree], torch.Tensor],
                   n_stages: int, axis: str = "pipe", batch_axes: Tuple[str, ...] = ()):
    """``fn(params_stacked, x)``: the pipeline over ``axis`` of ``mesh``.
    The parameters are replicated over the stages (each slices its block);
    with ``batch_axes`` the microbatches' rows (``x``'s axis 1) are split
    over those axes and each of their shards runs its own pipeline on its
    row of the mesh (the reference's ``in_specs``), the outputs joined
    back in order."""
    if mesh.shape[axis] != n_stages:
        raise ValueError(f"{n_stages} stages on a {axis} axis of {mesh.shape[axis]}")
    batch_axes = tuple(batch_axes)

    def fn(params_stacked: Tree, x: torch.Tensor) -> torch.Tensor:
        n = distributed.flat_axis_size(mesh, batch_axes)
        if x.shape[1] % n:
            raise ValueError(f"{x.shape[1]} rows a microbatch not divisible by {n} shards")
        rows = x.shape[1] // n
        outs = []
        for shard in range(n):
            coords, rest = {}, shard
            for name in reversed(batch_axes):
                rest, coords[name] = divmod(rest, mesh.shape[name])
            devices = distributed.shard_devices(mesh, (axis,), at=coords)
            outs.append(gpipe_apply(layer_fn, params_stacked, x.narrow(1, shard * rows, rows),
                                    n_stages, devices))
        return distributed.all_gather(outs, axis=1)

    return fn


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_stages + n_micro - 1)
