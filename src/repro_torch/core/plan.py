"""Composable query plans over the match stage (port of ``repro/core/plan.py``).

Three pieces, each usable on its own:

* :func:`combine_by_id`: given (B, M) candidate ids with one value each,
  combine the entries that share a doc id (sum or max), keep each doc's
  first entry, and re-reduce to the top k.  Fusion and multi-vector
  aggregation are this one operation with different values.
* :func:`fuse` / :class:`FusionStage`: merge the top-k lists of several
  sub-plans on global doc ids.  ``rrf`` scores an entry w_p / (rrf_k +
  rank_p) from its rank (scale-free); ``wsum`` sums w_p * score_p (for
  sub-plans whose scores are commensurable).
* :func:`aggregate_by_doc` / :class:`MultiVectorPlan`: multi-vector docs.
  The index holds one row per vector, ``doc_map`` sends vector ids to doc
  ids, and the depth-level candidates aggregate per doc (``max`` = max-sim,
  ``sum``) before the final top-k.

A leaf :class:`QueryPlan` wraps any ``search(queries) -> (scores, ids)``
callable that returns global doc ids.  The combine is plain torch on the
results' device (the reference computes it in XLA; it has no kernel):
O(M^2) a query, where M is a few top-k lists, not the corpus.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence, Tuple

import torch

from repro_torch.kernels.common import stable_topk

__all__ = [
    "combine_by_id",
    "fuse",
    "aggregate_by_doc",
    "QueryPlan",
    "FusionStage",
    "MultiVectorPlan",
]

DEFAULT_RRF_K = 60.0


def combine_by_id(
    ids: torch.Tensor, vals: torch.Tensor, k: int, agg: str = "sum"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Combine (B, M) per-entry values by doc id, then take the top k.

    Entries with id -1 are padding: they add nothing and never surface.  A
    doc's combined value sits on its first entry; its later entries are
    pinned to -inf, so each doc comes back at most once.  Ties keep the
    lower entry (``lax.top_k``'s order); empty slots are (-inf, -1)."""
    ids = torch.as_tensor(ids)
    vals = torch.as_tensor(vals, device=ids.device).to(torch.float32)
    m = ids.shape[1]
    valid = ids >= 0
    same = (ids[:, :, None] == ids[:, None, :]) & valid[:, :, None] & valid[:, None, :]
    if agg == "sum":
        total = torch.where(same, vals[:, None, :], 0.0).sum(-1)
    elif agg == "max":
        total = torch.where(same, vals[:, None, :], -torch.inf).amax(-1)
    else:
        raise ValueError(f"unknown agg {agg!r} (expected 'sum' or 'max')")
    earlier = torch.ones((m, m), dtype=torch.bool, device=ids.device).tril(-1)
    is_dup = (same & earlier).any(-1)
    total = torch.where(valid & ~is_dup, total, -torch.inf)
    top_s, pos = stable_topk(total, min(k, m))
    top_i = torch.gather(ids, 1, pos.long())
    return top_s, torch.where(top_s == -torch.inf, torch.full_like(top_i, -1), top_i)


def fuse(
    results: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    k: int,
    method: str = "rrf",
    weights: Optional[Sequence[float]] = None,
    rrf_k: float = DEFAULT_RRF_K,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fuse (scores, ids) result lists (each (B, k_p), in rank order) into
    one (B, k) list on shared doc ids.

    rrf:  score(doc) = sum_p w_p / (rrf_k + rank_p(doc)), ranks from 1, f32.
    wsum: score(doc) = sum_p w_p * score_p(doc).
    A doc missing from a sub-plan's list gets no term from it."""
    if not results:
        raise ValueError("fuse() needs at least one sub-result")
    if weights is None:
        weights = [1.0] * len(results)
    all_ids, all_vals = [], []
    for (s, i), w in zip(results, weights):
        if method == "rrf":
            ranks = torch.arange(1, i.shape[1] + 1, dtype=torch.float32, device=i.device)
            v = (w / (rrf_k + ranks))[None, :].expand(i.shape)
        elif method == "wsum":
            v = w * s.to(torch.float32)
        else:
            raise ValueError(f"unknown fusion method {method!r}")
        all_ids.append(i)
        all_vals.append(torch.where(i >= 0, v, 0.0))
    return combine_by_id(torch.cat(all_ids, dim=1), torch.cat(all_vals, dim=1), k, agg="sum")


def aggregate_by_doc(
    scores: torch.Tensor, vec_ids: torch.Tensor, doc_map, k: int, agg: str = "max",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-vector aggregation: (B, D) vector-level candidates mapped
    through ``doc_map`` ((N_vec,) ints, vector id -> doc id) and combined per
    doc, ``max`` (max-sim) or ``sum``.  It runs on the depth-level
    candidates, so a doc whose best vector ranks below k can still win."""
    doc_map = torch.as_tensor(doc_map, device=vec_ids.device)
    doc_ids = torch.where(vec_ids >= 0, doc_map[vec_ids.clamp_min(0).long()].to(vec_ids.dtype),
                          torch.full_like(vec_ids, -1))
    return combine_by_id(doc_ids, scores, k, agg=agg)


@dataclasses.dataclass(frozen=True)
class QueryPlan:
    """Leaf plan: any ``search(queries) -> (scores, ids)`` callable that
    returns global doc ids (a bound ``AnnIndex.search``, ...), and the weight
    its results carry in an enclosing :class:`FusionStage`.  ``search_at(
    queries, k)``, when given, returns at least ``k`` candidates."""

    search: Callable[[Any], Tuple[torch.Tensor, torch.Tensor]]
    weight: float = 1.0
    label: str = ""
    search_at: Optional[Callable[[Any, int], Tuple[torch.Tensor, torch.Tensor]]] = None

    def run(self, queries) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.search(queries)

    def run_at(self, queries, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Run with at least ``k`` candidates, for enclosing plans that find
        mid-merge that they need a deeper list (:class:`MultiVectorPlan`).
        Without ``search_at`` it runs the fixed-depth ``search``: callers
        see the width unchanged and stop asking."""
        if self.search_at is None:
            return self.search(queries)
        return self.search_at(queries, k)


@dataclasses.dataclass(frozen=True)
class FusionStage:
    """Fusion node: run every sub-plan on the same queries and merge their
    top-k lists with :func:`fuse`."""

    plans: Tuple[Any, ...]
    k: int = 10
    method: str = "rrf"
    rrf_k: float = DEFAULT_RRF_K

    def run(self, queries) -> Tuple[torch.Tensor, torch.Tensor]:
        results = [p.run(queries) for p in self.plans]
        weights = [getattr(p, "weight", 1.0) for p in self.plans]
        return fuse(results, self.k, method=self.method, weights=weights, rrf_k=self.rrf_k)


@dataclasses.dataclass(frozen=True)
class MultiVectorPlan:
    """Multi-vector node: run the inner plan in vector-id space, then
    aggregate to doc ids with :func:`aggregate_by_doc`.

    Aggregation folds a doc's vectors into one entry, so a k_sub-deep
    vector list can fill fewer than k docs.  While the list is short and the
    inner plan has ``run_at``, the inner search runs again at twice the
    depth, until k docs fill, the vectors run out, or the inner plan stops
    returning deeper lists."""

    inner: Any
    doc_map: Any
    k: int = 10
    agg: str = "max"

    def run(self, queries) -> Tuple[torch.Tensor, torch.Tensor]:
        s, i = self.inner.run(queries)
        top_s, top_i = aggregate_by_doc(s, i, self.doc_map, self.k, agg=self.agg)
        run_at = getattr(self.inner, "run_at", None)
        if run_at is None:
            return top_s, top_i
        n_vec = len(self.doc_map)
        k_sub = i.shape[1]
        while k_sub < n_vec and (top_i.shape[1] < self.k
                                 or int((top_i >= 0).sum(1).min()) < self.k):
            k_sub = min(2 * k_sub, n_vec)
            s, i = run_at(queries, k_sub)
            top_s, top_i = aggregate_by_doc(s, i, self.doc_map, self.k, agg=self.agg)
            if i.shape[1] < k_sub:
                break  # the inner plan cannot go deeper
        return top_s, top_i
