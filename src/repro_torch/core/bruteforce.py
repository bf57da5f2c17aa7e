"""Exact cosine top-k: the paper's ground truth by brute force (port of
``repro/core/bruteforce.py``)."""
from __future__ import annotations

from typing import Tuple

import torch


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


def rerank_exact(
    vectors: torch.Tensor, queries: torch.Tensor, cand_ids: torch.Tensor, k: int,
    normalized: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather the depth-d candidates' original vectors, exact cosine, keep
    the top k.  ``cand_ids`` is (B, d), id -1 = padding.  Ties keep the
    lower candidate position (a stable sort), like ``lax.top_k``."""
    v = vectors if normalized else l2_normalize(vectors)
    q = queries if normalized else l2_normalize(queries)
    cand = v[cand_ids.clamp_min(0).long()]  # (B, d, dim)
    scores = torch.einsum("bd,bcd->bc", q, cand)
    scores = torch.where(cand_ids >= 0, scores, torch.full_like(scores, -torch.inf))
    top_s, pos = torch.sort(scores, dim=-1, descending=True, stable=True)
    return top_s[:, :k], torch.gather(cand_ids, 1, pos[:, :k])
