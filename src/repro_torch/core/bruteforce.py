"""Exact cosine top-k: the paper's ground truth by brute force (port of
``repro/core/bruteforce.py``).

``exact_topk`` streams the store through the fused top-k kernel (K1 f32);
``exact_topk_tiled`` is the reference's plain running-merge form, a corpus
tile at a time, which bounds the scores held to O(B x (tile + k)).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.common import f32_matmul, stable_topk


def l2_normalize(x: torch.Tensor, eps: float = 1e-12, dim: int = -1) -> torch.Tensor:
    """Unit-normalize so the inner product is the cosine."""
    n = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / torch.clamp_min(n, eps)


def exact_topk(
    corpus: torch.Tensor, queries: torch.Tensor, k: int, normalized: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact cosine top-k, (scores (B, k), ids (B, k)), streamed through the
    fused top-k kernel in f32: the (B, N) score matrix never exists."""
    from repro_torch.kernels.fused_topk import ops

    c = corpus if normalized else l2_normalize(corpus)
    q = queries if normalized else l2_normalize(queries)
    return ops.cosine_topk(c.contiguous(), q.contiguous(), k)


def _merge_topk(
    scores_a: torch.Tensor, ids_a: torch.Tensor, scores_b: torch.Tensor, ids_b: torch.Tensor,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The best k of the union of two (B, *) candidate sets, ties to the
    lower position (``a`` before ``b``), as ``lax.top_k``."""
    s = torch.cat([scores_a, scores_b], dim=-1)
    i = torch.cat([ids_a, ids_b], dim=-1)
    top_s, pos = stable_topk(s, k)
    return top_s, torch.gather(i, -1, pos.long())


def exact_topk_tiled(
    corpus: torch.Tensor, queries: torch.Tensor, k: int, tile: int = 4096,
    normalized: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact cosine top-k over corpus tiles with a running merge: each
    tile's f32 product, its top ``min(k, tile)`` and a merge into the best
    k so far.  The last tile is padded to ``tile`` with -inf scores at ids
    past N, as the reference pads its corpus; empty slots are (-inf, -1)."""
    n = corpus.shape[0]
    b = queries.shape[0]
    c = corpus if normalized else l2_normalize(corpus)
    q = queries if normalized else l2_normalize(queries)
    best_s = torch.full((b, k), -torch.inf, dtype=torch.float32, device=q.device)
    best_i = torch.full((b, k), -1, dtype=torch.int32, device=q.device)
    for start in range(0, n, tile):
        s = f32_matmul(q, c[start:start + tile].T)
        s = torch.nn.functional.pad(s, (0, tile - s.shape[1]), value=-torch.inf)
        ids = torch.arange(start, start + tile, dtype=torch.int32, device=q.device)
        local_s, pos = stable_topk(s, min(k, tile))
        best_s, best_i = _merge_topk(best_s, best_i, local_s, ids[pos.long()], k)
    return best_s, best_i


def gathered_scores(
    queries: torch.Tensor, cand: torch.Tensor, cand_ids: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, d) cosine of gathered candidate rows ``cand`` (B, d, dim),
    widened to f32, against the unit queries, times the int8 store's
    per-candidate ``scale`` (B, d) when given; id -1 (padding) masked to
    -inf.  Every rerank (monolithic, segmented, packed) scores through this
    one function."""
    scores = torch.einsum("bd,bcd->bc", queries, cand.to(torch.float32))
    if scale is not None:
        scores = scores * scale
    return torch.where(cand_ids >= 0, scores, torch.full_like(scores, -torch.inf))


def top_candidates(
    scores: torch.Tensor, cand_ids: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top ``k`` of (B, d) candidate scores by a stable sort, so ties
    keep the lower candidate position, like ``lax.top_k``."""
    top_s, pos = torch.sort(scores, dim=-1, descending=True, stable=True)
    return top_s[:, :k], torch.gather(cand_ids, 1, pos[:, :k])


def rerank_gathered(
    queries: torch.Tensor, cand: torch.Tensor, cand_ids: torch.Tensor, k: int,
    scale: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top ``k`` of the gathered candidates by :func:`gathered_scores`."""
    return top_candidates(gathered_scores(queries, cand, cand_ids, scale), cand_ids, k)


def rerank_exact(
    vectors: torch.Tensor, queries: torch.Tensor, cand_ids: torch.Tensor, k: int,
    normalized: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather the depth-d candidates' original vectors, exact cosine, keep
    the top k (:func:`rerank_gathered`).  ``cand_ids`` is (B, d), id -1 =
    padding."""
    v = vectors if normalized else l2_normalize(vectors)
    q = queries if normalized else l2_normalize(queries)
    return rerank_gathered(q, v[cand_ids.clamp_min(0).long()], cand_ids, k)
