"""Kernel-backed exact cosine top-k (port of
``repro/kernels/cosine_score/ops.py``)."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.common import stable_topk
from repro_torch.kernels.cosine_score.kernel import cosine_scores


def cosine_topk(q: torch.Tensor, docs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact cosine top-``k`` of raw f32 queries against raw f32 documents:
    both sides normalized by ``max(norm, 1e-12)`` (the documents through
    :func:`cosine_scores`' epilogue), then (scores f32, ids int32) in
    ``lax.top_k`` order, ties to the lowest id."""
    qn = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-12)
    inv = 1.0 / torch.clamp(torch.linalg.vector_norm(docs, dim=-1), min=1e-12)
    return stable_topk(cosine_scores(qn, docs, inv), k)
