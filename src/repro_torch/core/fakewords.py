"""Fake-words ANN encoding (paper §2, after Amato et al. 2016); port of
``repro/core/fakewords.py``.

A unit vector w becomes a bag of synthetic terms where feature i's term
appears round(Q * w_i) times; negative features are sign-split into 2m
terms.  The posting lists are a dense (N, 2m) int8 term-frequency matrix.

  * ClassicSimilarity: score(q,d) = sum_t tf_q(t) * sqrt(tf_d(t)) * idf(t)^2
    * norm(d), idf(t) = 1 + ln(N/(df(t)+1)), norm(d) = 1/sqrt(doc_len(d)).
  * High-df term filtering at search time = zeroing pruned query columns.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import bruteforce
from repro_torch.core.types import FakeWordsConfig, FakeWordsIndex
from repro_torch.kernels.fused_topk import ref as fused_ref


def encode(vectors: torch.Tensor, quantization: int, dtype=torch.int8) -> torch.Tensor:
    """Sign-split quantized term frequencies: (N, m) floats -> (N, 2m) ints.
    Columns [0, m) = round(Q * relu(w)); [m, 2m) = round(Q * relu(-w))
    (round half to even, like ``jnp.round``)."""
    pos = torch.round(quantization * torch.clamp_min(vectors, 0.0))
    neg = torch.round(quantization * torch.clamp_min(-vectors, 0.0))
    return torch.cat([pos, neg], dim=-1).to(dtype)


def encode_queries(
    queries: torch.Tensor, config: FakeWordsConfig, normalized: bool = False
) -> torch.Tensor:
    q = queries if normalized else bruteforce.l2_normalize(queries)
    return encode(q, config.quantization, torch.int32)


def doc_stats(tf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(df int32, idf f32, norm f32) of a term-frequency matrix,
    Lucene-style: the statistics the build computes."""
    from repro_torch.core import builder

    df = builder.live_df(tf)
    return df, builder.idf_from_df(df, tf.shape[0]), builder.doc_norm(tf)


def build(vectors: torch.Tensor, config: FakeWordsConfig, keep_vectors: bool = True,
          normalized: bool = False) -> FakeWordsIndex:
    """Thin wrapper over :class:`repro_torch.core.builder.BuildPipeline`
    (TfTransform -> FakeWordsPostings -> rerank store), on the device of
    ``vectors``."""
    from repro_torch.core import builder

    bp = builder.make_build_pipeline(config, "exact" if keep_vectors else "none")
    return bp.build_local(vectors, normalized=normalized)


def df_prune_mask(df: torch.Tensor, num_docs: int, df_max_ratio: float) -> torch.Tensor:
    """Boolean keep-mask over terms (True = keep): the paper's search-time
    high-frequency term filtering."""
    if df_max_ratio >= 1.0:
        return torch.ones_like(df, dtype=torch.bool)
    return df <= int(df_max_ratio * num_docs)


def classic_query(
    index: FakeWordsIndex, q_tf: torch.Tensor, df_max_ratio: float = 1.0,
    num_docs: Optional[int] = None,
) -> torch.Tensor:
    """bf16 classic-mode query operand with the df-prune keep-mask folded in
    (for the bf16 ``scored`` matrix and for its packed ``pq`` store alike).
    ``num_docs`` overrides the prune threshold's collection size: a segment
    of a ``SegmentedAnnIndex`` masks against the collection's live count
    (its ``df`` already holds the collection's df), not its own rows."""
    if index.scored is None and index.pq is None:
        raise ValueError("index was built with scoring='dot'")
    n = index.num_docs if num_docs is None else num_docs
    keep = df_prune_mask(index.df, n, df_max_ratio)
    return (q_tf * keep).to(torch.bfloat16)


def signed_query(q_tf: torch.Tensor, dtype=torch.int32) -> torch.Tensor:
    """Signed quantized query u = q+ - q- (B, m) from the sign-split (B, 2m)."""
    m = q_tf.shape[-1] // 2
    return (q_tf[:, :m].to(torch.int32) - q_tf[:, m:].to(torch.int32)).to(dtype)


def dot_query(
    index: FakeWordsIndex, q_tf: torch.Tensor, df_max_ratio: float = 1.0,
    dtype=torch.int32, num_docs: Optional[int] = None,
) -> torch.Tensor:
    """Dot-mode query operand: the [u; -u] lift with the keep-mask folded in
    (int8 for the kernel).  ``num_docs`` as in :func:`classic_query`."""
    n = index.num_docs if num_docs is None else num_docs
    keep = df_prune_mask(index.df, n, df_max_ratio)
    u = signed_query(q_tf)
    return (torch.cat([u, -u], dim=-1) * keep).to(dtype)


def classic_scores(
    index: FakeWordsIndex, q_tf: torch.Tensor, df_max_ratio: float = 1.0
) -> torch.Tensor:
    """Dense ClassicSimilarity scores for all docs: (B, N) float32."""
    return fused_ref.scores_ref(classic_query(index, q_tf, df_max_ratio), index.scored)


def dot_scores(
    index: FakeWordsIndex, q_tf: torch.Tensor, df_max_ratio: float = 1.0
) -> torch.Tensor:
    """Dense integer-dot scores <T_d, [u; -u]>: (B, N) float32, exact."""
    return fused_ref.scores_ref(dot_query(index, q_tf, df_max_ratio), index.tf)


def search(
    index: FakeWordsIndex, q_tf: torch.Tensor, queries: Optional[torch.Tensor], k: int = 10,
    depth: int = 100, scoring: str = "classic", rerank: bool = False, df_max_ratio: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-phase search: match depth-d candidates on the fake-words index
    (K1, or its plain version on the CPU), optionally rerank to k against
    the stored originals (``queries`` unit-normalized).  Thin wrapper over
    :class:`repro_torch.core.pipeline.FakeWordsMatcher` + the exact rerank;
    routing follows the tensors' device."""
    from repro_torch.core import pipeline as pl

    matcher = pl.FakeWordsMatcher(scoring=scoring, df_max_ratio=df_max_ratio)
    return pl.match_rerank(matcher, index, q_tf, queries, k, depth, rerank)
