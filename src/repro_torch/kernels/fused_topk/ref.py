"""Plain PyTorch versions of the fused streaming top-k (the computation the
CUDA kernel replaces; these DO materialize the (B, N) score matrix).

``fused_topk_ref`` is what :func:`..kernel.fused_topk` runs for tensors on
the CPU, and what the kernel is held against on the card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

LSH_SENTINEL = 0xFFFFFFFF
_INT_DTYPES = (torch.int8, torch.int16, torch.int32, torch.int64)


def _lsh_bits(x: torch.Tensor) -> torch.Tensor:
    """uint32 signatures as int32 bits (the sentinel becomes -1)."""
    return x.view(torch.int32) if x.dtype == torch.uint32 else x


def scores_ref(q: torch.Tensor, docs: torch.Tensor, mode: str = "gemm") -> torch.Tensor:
    """Dense (B, N) float32 scores.

    gemm: integer operands sum exactly (in float64, exact far past any
    int8 x int8 sum this package makes, then cast like the reference's
    int32 -> f32); float operands (bf16 widened to f32: exact products)
    accumulate in full float32 -- on the card with TF32 switched off for this
    product only (the caller's setting is restored), so the ground truth
    stays fp32.  lsh: sentinel-aware collision counts."""
    if mode == "lsh":
        qb, db = _lsh_bits(q), _lsh_bits(docs)
        eq = (qb[:, None, :] == db[None, :, :]) & (qb[:, None, :] != -1)
        return eq.sum(-1, dtype=torch.int32).float()
    if q.dtype in _INT_DTYPES:
        return (q.double() @ docs.double().T).float()
    if not q.is_cuda:
        return q.float() @ docs.float().T
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return q.float() @ docs.float().T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def apply_filt(scores: torch.Tensor, filt: Optional[torch.Tensor]) -> torch.Tensor:
    """Mask a dense (B, N) score matrix with a keep bitmap ((N,) shared or
    (B, N) per query; nonzero = keep).  ``filt=None`` is the identity."""
    if filt is None:
        return scores
    f = filt if filt.dim() == 2 else filt[None, :]
    return torch.where(f != 0, scores, torch.full_like(scores, -torch.inf))


def fused_topk_ref(
    q: torch.Tensor, docs: torch.Tensor, depth: int, mode: str = "gemm",
    filt: Optional[torch.Tensor] = None, n_docs: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense scores + a stable descending sort: the top ``depth`` with ties
    to the lowest doc id (``lax.top_k`` order; ``torch.topk`` promises no
    tie order).  Rows >= ``n_docs`` never rank; -inf slots get id -1."""
    if n_docs is not None and n_docs < docs.shape[0]:
        docs = docs[:n_docs]
        filt = None if filt is None else filt[..., :n_docs]
    scores = apply_filt(scores_ref(q, docs, mode), filt)
    s, i = torch.sort(scores, dim=-1, descending=True, stable=True)
    s, i = s[:, :depth], i[:, :depth].to(torch.int32)
    return s, torch.where(s == -torch.inf, torch.full_like(i, -1), i)
