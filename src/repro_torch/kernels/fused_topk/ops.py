"""Search hot paths on the fused top-k kernel (port of
``repro/kernels/fused_topk/ops.py``).

Each wrapper prepares the query operand exactly like its ``core/`` path
(df-prune keep-mask folded into the query, [u; -u] int8 lift for dot mode)
and streams the stored index through :func:`.kernel.fused_topk`, or a
packed int8 / int4 store through :func:`.kernel.fused_topk_quantized`;
:func:`.kernel.fused_topk_gathered` (blockmax stage 2) is re-exported here,
as the reference's ops module does.
``repro_torch.core`` modules are imported lazily to avoid an import cycle.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.fused_topk.kernel import fused_topk_gathered  # noqa: F401
from repro_torch.kernels.fused_topk.kernel import (
    fused_topk,
    fused_topk_gathered_quantized,
    fused_topk_quantized,
)


def gather_filt(
    filt: Optional[torch.Tensor], row_ids: torch.Tensor, n_docs: int
) -> Optional[torch.Tensor]:
    """A per-doc keep bitmap ((N,) shared or (B, N) per query) gathered into
    the (B, R) bitmap aligned with ``row_ids`` that the gathered kernels
    take.  Ids outside [0, n_docs) read a doc in range; the kernels' own
    range check masks those rows."""
    if filt is None:
        return None
    safe = row_ids.long().clamp(0, n_docs - 1)
    return filt[safe] if filt.dim() == 1 else torch.gather(filt, 1, safe)


def classic_topk(
    index, q_tf: torch.Tensor, depth: int, df_max_ratio: float = 1.0,
    filt: Optional[torch.Tensor] = None, num_docs: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """ClassicSimilarity top-depth: bf16 query against the bf16 ``scored``
    matrix, f32 accumulate.  ``num_docs`` as in ``fakewords.classic_query``
    (the df prune's collection size)."""
    from repro_torch.core import fakewords

    qv = fakewords.classic_query(index, q_tf, df_max_ratio, num_docs=num_docs)
    return fused_topk(qv, index.scored, depth, filt=filt)


def dot_topk(
    index, q_tf: torch.Tensor, depth: int, df_max_ratio: float = 1.0,
    filt: Optional[torch.Tensor] = None, num_docs: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Integer-dot top-depth: int8 [u; -u] query against the int8 tf."""
    from repro_torch.core import fakewords

    qv = fakewords.dot_query(index, q_tf, df_max_ratio, dtype=torch.int8, num_docs=num_docs)
    return fused_topk(qv, index.tf, depth, filt=filt)


def cosine_topk(
    corpus: torch.Tensor, queries: torch.Tensor, depth: int,
    filt: Optional[torch.Tensor] = None, n_docs: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact-cosine top-depth in f32 (operands must be unit-normalized)."""
    return fused_topk(queries, corpus, depth, filt=filt, n_docs=n_docs)


def lsh_topk(
    sig_q: torch.Tensor, sig_d: torch.Tensor, depth: int,
    filt: Optional[torch.Tensor] = None, n_docs: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """MinHash collision-count top-depth."""
    return fused_topk(sig_q, sig_d, depth, mode="lsh", filt=filt, n_docs=n_docs)


def lift_l2(points: torch.Tensor) -> torch.Tensor:
    """``[d; -||d||^2]``, the doc side of :func:`scan_l2_topk`, made once at
    index build time (lifting at every search would copy the whole index)."""
    d2 = (points * points).sum(dim=-1)  # (N,)
    return torch.cat([points, -d2[:, None]], dim=-1).contiguous()


def scan_l2_topk(
    lifted: torch.Tensor, q_reduced: torch.Tensor, depth: int,
    filt: Optional[torch.Tensor] = None, n_docs: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact reduced-space L2 top-depth (the k-d tree's scan backend) on K1
    f32: -||q - d||^2 + ||q||^2 = 2 q.d - ||d||^2 is a plain product after
    the lift q' = [2q; 1], d' = [d; -||d||^2] (``lifted``, from
    :func:`lift_l2`), so the (B, N) distance matrix never exists."""
    qa = torch.cat([2.0 * q_reduced, torch.ones_like(q_reduced[:, :1])], dim=-1)
    return fused_topk(qa.contiguous(), lifted, depth, filt=filt, n_docs=n_docs)


def postings_topk(
    pq, qv: torch.Tensor, depth: int, filt: Optional[torch.Tensor] = None,
    n_docs: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-depth over a packed :class:`repro_torch.core.types.
    QuantizedPostings` store, dequantized in the score stage (K4).  ``qv``
    is the mode's float query operand."""
    return fused_topk_quantized(qv, pq.q, pq.scale, depth, pq.bits, pq.group, filt=filt,
                                n_docs=n_docs)


def postings_topk_gathered(
    pq, qv: torch.Tensor, row_ids: torch.Tensor, depth: int, n_docs: int,
    filt: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-depth over the rows ``row_ids`` (B, R) of a packed store
    (quantized blockmax stage 2, K5).  The whole store and the ids go to the
    kernel, which reads each row by id; only the per-doc ``filt`` ((N,) |
    (B, N)) is gathered here, into the (B, R) bitmap of the rows."""
    return fused_topk_gathered_quantized(qv, pq.q, pq.scale, row_ids, depth, n_docs, pq.bits,
                                         pq.group, filt=gather_filt(filt, row_ids, n_docs))
