"""Plain PyTorch version of the cosine score matrix (port of
``repro/kernels/cosine_score/ref.py``): what :func:`..kernel.cosine_scores`
runs for tensors on the CPU, and what the card's kernel is held against."""
from __future__ import annotations

import torch

from repro_torch.kernels.common import f32_matmul


def cosine_scores_ref(q: torch.Tensor, docs: torch.Tensor, inv_norm: torch.Tensor) -> torch.Tensor:
    """(B, N) f32 ``(q @ docs.T) * inv_norm``, the product in full f32."""
    return f32_matmul(q, docs.T) * inv_norm[None, :]
