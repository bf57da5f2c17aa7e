"""Evaluation metrics: the paper's R@(k,d) (port of ``repro/core/eval.py``)."""
from __future__ import annotations

from typing import Optional

import torch


def recall_at(
    truth_ids: torch.Tensor, retrieved_ids: torch.Tensor,
    filter_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """R@(k,d): fraction of the true top-k (truth_ids (B, k)) present among
    the retrieved top-d (retrieved_ids (B, d)), averaged over queries.  -1
    ids are padding, out of both the hit count and the denominator; truth
    entries masked out by ``filter_mask`` ((N,) or (B, N), nonzero = keep)
    are treated the same way."""
    valid = truth_ids >= 0
    if filter_mask is not None:
        safe = truth_ids.clamp_min(0).long()
        bits = filter_mask[safe] if filter_mask.dim() == 1 else torch.gather(filter_mask, 1, safe)
        valid = valid & (bits != 0)
    hits = (truth_ids[:, :, None] == retrieved_ids[:, None, :]) & valid[:, :, None]
    n_valid = valid.sum(-1).clamp_min(1)
    return (hits.any(-1).sum(-1) / n_valid).mean()


def recall_curve(truth_ids: torch.Tensor, retrieved_ids: torch.Tensor, depths) -> dict:
    """R@(k,d) for several retrieval depths d from one deep retrieval."""
    return {d: float(recall_at(truth_ids, retrieved_ids[:, :d])) for d in depths}


def overlap(a_ids: torch.Tensor, b_ids: torch.Tensor) -> torch.Tensor:
    """Mean fraction of shared ids between two (B, k) result sets; -1
    padding in ``a_ids`` is excluded."""
    valid = a_ids >= 0
    hits = (a_ids[:, :, None] == b_ids[:, None, :]) & valid[:, :, None]
    n_valid = valid.sum(-1).clamp_min(1)
    return (hits.any(-1).sum(-1) / n_valid).mean()
