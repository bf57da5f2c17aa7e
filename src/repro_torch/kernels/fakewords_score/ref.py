"""Plain PyTorch versions of the fake-words score matrix (port of
``repro/kernels/fakewords_score/ref.py``): what :func:`..kernel.score_matmul`
runs for tensors on the CPU, and what the card's kernel is held against."""
from __future__ import annotations

import torch

from repro_torch.kernels.common import f32_matmul


def score_matmul_ref(q: torch.Tensor, docs: torch.Tensor,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, N) ``q @ docs.T``: int8 operands summed exactly (in float64,
    exact far past any int8 x int8 sum of T < 2**37 terms) and cast to
    ``out_dtype`` like the reference's int32 -> f32; bf16 operands widened
    to f32 (exact products) and accumulated in full f32."""
    if q.dtype == torch.int8:
        return (q.double() @ docs.double().T).to(torch.int32).to(out_dtype)
    return f32_matmul(q, docs.T)


def classic_scores_ref(q_tf: torch.Tensor, scored: torch.Tensor,
                       keep: torch.Tensor) -> torch.Tensor:
    """End-to-end classic-similarity scores (mirrors ``core.fakewords``):
    the keep-masked query rounded to bf16 against the bf16 ``scored``."""
    return f32_matmul((q_tf * keep).to(torch.bfloat16), scored.T)
