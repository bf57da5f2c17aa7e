"""Gradient compression: int8 all-reduce with error feedback (port of
``repro/train/compression.py``).

Data-parallel gradient all-reduce moves 4 bytes a parameter a step in f32.
The reference's explicit data-parallel reduction, kept here op for op:

  1. add the local error-feedback residual to the local gradient,
  2. quantize to int8 with a per-leaf (per-tensor) scale = max|g| / 127,
  3. all-reduce the int8 payload (``psum``, as int32),
  4. dequantize; the residual keeps what quantization dropped (error
     feedback makes the scheme convergent: Karimireddy et al. 2019).

The scale is itself max-reduced first (one float a leaf) so that every
shard quantizes on the same grid, which the integer sum needs.

On the port's one-process mesh (``core/distributed.py``) the reference's
``shard_map`` body becomes a function of per-shard lists, as
``distributed.psum`` and ``ppermute`` are: shard s's gradient tree is
``grads[s]``, on its shard's device.  The leaves go one at a time, so the
temporaries are one leaf's size a shard.
"""
from __future__ import annotations

from typing import Any, List, Sequence, Tuple, Union

import torch

from repro_torch.core import distributed
from repro_torch.train.optimizer import tree_leaves, tree_map

Tree = Any


def quantize_leaf(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """round(g / scale) (half to even, as ``jnp.round``) clipped to
    [-127, 127], as int8."""
    q = torch.round(g.float() / scale)
    return torch.clamp(q, -127, 127).to(torch.int8)


def dequantize_leaf(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def residual_leaf(g32: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``g32 - dequantize_leaf(q, scale)`` rounded once, as XLA's fused
    multiply-add rounds the reference's: in f64 the product (8 bits times
    24) is exact, and so is the difference (where q != 0, |g32| >= scale / 2
    and |g32 - q scale| <= scale / 2: some 26 bits)."""
    return (g32.double() - q.double() * scale.double()).float()


def compressed_psum(grads: Sequence[Tree], residual: Sequence[Tree], mesh: distributed.Mesh,
                    axis: Union[str, Sequence[str]]) -> Tuple[List[Tree], List[Tree]]:
    """The mean over the shards of ``axis`` of the gradient trees
    ``grads`` (one a shard, in flat order), int8-compressed with error
    feedback: returns (the mean-reduced gradients, the new residual), one
    tree a shard each.  The mean is computed once, on shard 0's device,
    and every shard's tree holds it on its own device."""
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    n = distributed.flat_axis_size(mesh, axes)
    if len(grads) != n or len(residual) != n:
        raise ValueError(f"{len(grads)} gradient and {len(residual)} residual trees for {n} "
                         f"shards of {axes}")
    devices = [tree_leaves(g)[0].device for g in grads]

    def one(gs, rs):
        g32 = [g.float() + r for g, r in zip(gs, rs)]
        amax = distributed.pmax([x.abs().max() for x in g32])  # the shared grid
        scale = torch.clamp_min(amax, 1e-12) / 127.0
        scales = distributed.replicate(scale, devices)
        q = [quantize_leaf(x, s) for x, s in zip(g32, scales)]
        new_r = [residual_leaf(x, qs, s) for x, qs, s in zip(g32, q, scales)]  # error feedback
        summed = distributed.psum([qs.to(torch.int32) for qs in q])
        return distributed.replicate(dequantize_leaf(summed, scale) / n, devices), new_r

    flat_g = [tree_leaves(g) for g in grads]
    flat_r = [tree_leaves(r) for r in residual]
    out = [one([f[j] for f in flat_g], [f[j] for f in flat_r]) for j in range(len(flat_g[0]))]

    def unflatten(s: int, which: int) -> Tree:
        it = iter(leaf[which][s] for leaf in out)
        return tree_map(lambda _: next(it), grads[s])

    return [unflatten(s, 0) for s in range(n)], [unflatten(s, 1) for s in range(n)]


def init_residual(params: Tree) -> Tree:
    """Zero f32 residuals shaped as ``params``' leaves, on their devices."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def wire_bytes(params: Tree, compressed: bool) -> int:
    """Bytes a data-parallel all-reduce hop for reporting (f32 vs int8
    payload), the reference's count: 1 byte a parameter when compressed,
    though the payload is summed as int32 (4 bytes)."""
    n = sum(leaf.numel() for leaf in tree_leaves(params))
    return n * (1 if compressed else 4)
