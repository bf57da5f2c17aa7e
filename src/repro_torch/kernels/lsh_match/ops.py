"""Kernel-backed LSH top-k (port of ``repro/kernels/lsh_match/ops.py``)."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.common import stable_topk
from repro_torch.kernels.lsh_match.kernel import lsh_match_scores


def lsh_topk(index, sig_q: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-``k`` documents of an :class:`repro_torch.core.types.LshIndex`
    by collision count: (scores f32, ids int32) in ``lax.top_k`` order, ties
    (constant among integer counts) to the lowest id.  The (B, N) counts
    are whole in memory, and ``stable_topk`` sorts every whole row of them."""
    return stable_topk(lsh_match_scores(sig_q, index.sig).to(torch.float32), k)
