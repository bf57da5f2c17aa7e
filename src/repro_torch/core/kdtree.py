"""k-d tree ANN over dimensionality-reduced vectors (port of
``repro/core/kdtree.py``; paper §2, third method).

Lucene's BKD point index supports at most 8 dimensions, so the paper reduces
300-d embeddings (PCA or PPA -> PCA -> PPA) and indexes the reduced points.
Search is exact L2 in the reduced space; the recall loss the paper reports
comes from the reduction, not the tree.

Two backends:

* ``tree`` - the array-encoded balanced k-d tree, built on the host (numpy)
  and searched on the index's device by a batched lock-step DFS with
  plane-distance pruning (:func:`tree_search`): every query runs the
  reference's per-query loop, one step of each a round.
* ``scan`` - a scan of the lifted reduced points on K1 f32
  (:func:`repro_torch.kernels.fused_topk.ops.scan_l2_topk`): the same
  neighbours, up to the rounding of near-ties.

Both return squared-L2 distances negated, so that bigger is better.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from repro_torch.core import bruteforce, pca
from repro_torch.core.executables import capture
from repro_torch.core.types import KdTreeConfig, KdTreeIndex
from repro_torch.kernels.common import stable_topk

# DFS rounds between two checks of the stacks on the host: a check is a
# device sync, and rounds past a query's end change nothing.
_ROUNDS_PER_CHECK = 32


# --------------------------------------------------------------------------
# Host-side tree construction (numpy; a copy of the reference's, so that the
# arrays are bit-identical for the same points)
# --------------------------------------------------------------------------


def _build_arrays(points: np.ndarray, leaf_size: int):
    """Balanced implicit k-d tree: internal node i has children 2i+1 / 2i+2;
    leaves are contiguous slots of ``perm``.  Splits on the widest dimension
    at the median (Lucene BKD's split heuristic)."""
    n, dims = points.shape
    n_leaves = max(1, 1 << math.ceil(math.log2(max(1, math.ceil(n / leaf_size)))))
    depth = int(math.log2(n_leaves))
    n_internal = n_leaves - 1
    split_dim = np.zeros((max(n_internal, 1),), np.int32)
    split_val = np.zeros((max(n_internal, 1),), np.float32)
    cap = n_leaves * leaf_size
    if cap < n:
        leaf_size = math.ceil(n / n_leaves)
        cap = n_leaves * leaf_size
    perm = np.full((n_leaves, leaf_size), -1, np.int32)

    def rec(node: int, ids: np.ndarray, level: int):
        if level == depth:  # leaf
            leaf = node - n_internal
            perm[leaf, : len(ids)] = ids
            return
        pts = points[ids]
        dim = int(np.argmax(pts.max(axis=0) - pts.min(axis=0))) if len(ids) else 0
        order = ids[np.argsort(points[ids, dim], kind="stable")] if len(ids) else ids
        half = len(order) // 2
        val = float(points[order[half], dim]) if len(order) else 0.0
        split_dim[node] = dim
        split_val[node] = val
        rec(2 * node + 1, order[:half], level + 1)
        rec(2 * node + 2, order[half:], level + 1)

    rec(0, np.arange(n, dtype=np.int32), 0)
    return split_dim, split_val, perm, depth


def build(vectors: torch.Tensor, config: KdTreeConfig, keep_vectors: bool = True,
          normalized: bool = False) -> KdTreeIndex:
    """Build through :class:`repro_torch.core.builder.BuildPipeline`
    (ReductionTransform -> KdTreePostings -> rerank store) on the device
    ``vectors`` lie on."""
    from repro_torch.core import builder

    bp = builder.make_build_pipeline(config, "exact" if keep_vectors else "none")
    return bp.build_local(vectors, normalized=normalized)


def reduce_queries(index: KdTreeIndex, queries: torch.Tensor,
                   normalized: bool = False) -> torch.Tensor:
    q = queries if normalized else bruteforce.l2_normalize(queries)
    return pca.apply_reduction(index.reduction, q).to(torch.float32)


# --------------------------------------------------------------------------
# Backend (a): the tree, every query's DFS in lock step
# --------------------------------------------------------------------------


def tree_search(index: KdTreeIndex, q_reduced: torch.Tensor,
                k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each query's top-``k`` by the reference's DFS (``_tree_knn_single``),
    all queries in lock step on the index's device.  A round pops each
    query's stack once: the entry is pruned when its squared plane distance
    exceeds the query's k-th best; an internal node pushes its far child
    (with the plane distance) and then its near one (with 0); a leaf merges
    its points' distances after the current best, ties to the lower
    position (``lax.top_k``'s order).  A query whose stack is empty idles.
    On the card the rounds between two checks run as one captured CUDA
    graph (the reference's loop is one compiled program too): launched one
    by one, a round's ~70 small operations cost the host ~1.4 ms.
    Returns (-d2 ascending in d2, ids), each (B, k)."""
    reduced, perm = index.reduced, index.perm
    if perm is None:
        raise ValueError("the index has no tree arrays (build it with backend='tree')")
    dev = reduced.device
    n_leaves, leaf_size = perm.shape
    n_internal = n_leaves - 1
    stack_cap = 2 * int(math.log2(n_leaves)) + 4
    split_dim, split_val = index.split_dim.long(), index.split_val
    q = q_reduced.to(torch.float32)
    b = q.shape[0]
    rows = torch.arange(b, device=dev)
    best_d = torch.full((b, k), torch.inf, dtype=torch.float32, device=dev)
    best_i = torch.full((b, k), -1, dtype=torch.int32, device=dev)
    stack_node = torch.zeros((b, stack_cap), dtype=torch.long, device=dev)
    stack_pd2 = torch.zeros((b, stack_cap), dtype=torch.float32, device=dev)
    sp = torch.ones((b,), dtype=torch.long, device=dev)  # the root, plane distance 0

    def round_():  # updates the state tensors in place (a graph replays on them)
        active = sp > 0
        top = (sp - 1).clamp_min(0)
        node, pd2 = stack_node[rows, top], stack_pd2[rows, top]
        visit = active & ~(pd2 > best_d.amax(dim=-1))
        sp.sub_(active.long())
        # internal node: push far (with its plane distance), then near
        inner = visit & (node < n_internal)
        at = node.clamp(0, max(n_internal - 1, 0))
        diff = q[rows, split_dim[at]] - split_val[at]
        left = diff < 0
        near = torch.where(left, 2 * node + 1, 2 * node + 2)
        far = torch.where(left, 2 * node + 2, 2 * node + 1)
        for off, child, dist in ((0, far, diff * diff), (1, near, torch.zeros_like(diff))):
            pos = (sp + off).clamp_max(stack_cap - 1)
            stack_node[rows, pos] = torch.where(inner, child, stack_node[rows, pos])
            stack_pd2[rows, pos] = torch.where(inner, dist, stack_pd2[rows, pos])
        sp.add_(2 * inner.long())
        # leaf: merge its points after the current best
        leaf = visit & (node >= n_internal)
        ids = perm[(node - n_internal).clamp(0, n_leaves - 1)]  # (B, leaf_size)
        pts = reduced[ids.clamp_min(0).long()]  # (B, leaf_size, dims)
        d2 = ((pts - q[:, None, :]) ** 2).sum(dim=-1)
        d2 = torch.where(ids >= 0, d2, torch.inf)
        all_d = torch.cat([best_d, d2], dim=1)
        all_i = torch.cat([best_i, ids], dim=1)
        neg, pos = stable_topk(-all_d, k)
        best_d.copy_(torch.where(leaf[:, None], -neg, best_d))
        best_i.copy_(torch.where(leaf[:, None], torch.gather(all_i, 1, pos.long()), best_i))

    def rounds():
        for _ in range(_ROUNDS_PER_CHECK):
            round_()

    if dev.type == "cuda":
        # the first round runs for real before the capture, as CUDA graphs require
        graph, _ = capture(dev, round_, rounds)
        rounds = graph.replay
    while bool((sp > 0).any()):
        rounds()
    d, order = torch.sort(best_d, dim=-1, stable=True)
    return -d, torch.gather(best_i, 1, order)


# --------------------------------------------------------------------------
# Backend (b): the scan of the lifted reduced points on K1 f32
# --------------------------------------------------------------------------


def scan_search(index: KdTreeIndex, q_reduced: torch.Tensor,
                k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact reduced-space L2 top-k through
    :class:`repro_torch.core.pipeline.KdScanMatcher`."""
    from repro_torch.core import pipeline as pl

    return pl.KdScanMatcher()(index, q_reduced, k)


def search(index: KdTreeIndex, queries: torch.Tensor, k: int = 10, depth: int = 100,
           backend: str = "scan", rerank: bool = False,
           normalized: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    from repro_torch.core import pipeline as pl

    q = queries if normalized else bruteforce.l2_normalize(queries)
    qr = reduce_queries(index, q, normalized=True)
    matcher = pl.KdTreeMatcher() if backend == "tree" else pl.KdScanMatcher()
    d_s, d_i = matcher(index, qr, depth)
    if not rerank:
        return d_s[:, :k], d_i[:, :k]
    return pl.default_reranker(index)(index, q, d_i, k)
