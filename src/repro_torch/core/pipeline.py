"""Staged retrieval pipeline (port of ``repro/core/pipeline.py``):

    encode query -> match candidates [-> blockmax prune] -> optional rerank
                                                          (fp32 or int8 store)

Stages are frozen dataclasses taking the index as an explicit argument.
Every matcher streams through a fused top-k kernel (over packed int8 / int4
postings when the index carries ``pq``): on a CUDA index the CUDA kernel, on
a CPU index its plain version.

Filtered search: every matcher takes ``filt``, a per-doc keep bitmap ((N,)
shared or (B, N) per query), and passes it to its kernel, which masks the
docs inside its score pass (masked slots are (-inf, -1)); the k-d tree's DFS
masks its candidates after the search; the graph's traversal keeps masked
nodes traversable and never emits them.  :class:`FilterMask` wraps a matcher
with a mask of its own.  The caller's mask (bool, uint8 or int32; a tensor
or a numpy array; nonzero = keep) becomes a contiguous bool tensor on the
index's device once, in :func:`as_filter`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple, Union

import torch

from repro_torch.core import blockmax, bruteforce, fakewords, graph, kdtree, lexical_lsh
from repro_torch.core.types import (
    BruteForceConfig,
    FakeWordsConfig,
    GraphConfig,
    KdTreeConfig,
    LexicalLshConfig,
    SearchParams,
)
from repro_torch.kernels.common import stable_topk
from repro_torch.kernels.fused_topk import ops as fused

AnyConfig = Union[FakeWordsConfig, LexicalLshConfig, KdTreeConfig, BruteForceConfig, GraphConfig]


# --------------------------------------------------------------------------
# Query encoders
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TfRowEncoder:
    """Fake words: sign-split quantized term-frequency row (B, 2m) int32."""

    config: FakeWordsConfig

    def __call__(self, index, q_norm: torch.Tensor) -> torch.Tensor:
        return fakewords.encode_queries(q_norm, self.config, normalized=True)


@dataclasses.dataclass(frozen=True)
class MinHashEncoder:
    """Lexical LSH: MinHash signature (B, h*b) uint32."""

    config: LexicalLshConfig

    def __call__(self, index, q_norm: torch.Tensor) -> torch.Tensor:
        return lexical_lsh.encode(q_norm, self.config)


@dataclasses.dataclass(frozen=True)
class ReducedPointEncoder:
    """k-d tree: project through the reduction fitted at build time."""

    def __call__(self, index, q_norm: torch.Tensor) -> torch.Tensor:
        return kdtree.reduce_queries(index, q_norm, normalized=True)


@dataclasses.dataclass(frozen=True)
class IdentityEncoder:
    """Brute force and the graph: the unit-normalized query itself."""

    def __call__(self, index, q_norm: torch.Tensor) -> torch.Tensor:
        return q_norm


# --------------------------------------------------------------------------
# Filters
# --------------------------------------------------------------------------


def as_filter(mask, n_docs: int, batch: int, device) -> Optional[torch.Tensor]:
    """A caller's keep bitmap (bool, uint8 or int32; tensor or numpy array;
    nonzero = keep) as the contiguous bool tensor on ``device`` that the
    kernels take (a contiguous bool tensor there already is taken as it
    is: a (B, N) mask can be large).  It must be (n_docs,) or (batch,
    n_docs); None passes."""
    if mask is None:
        return None
    m = torch.as_tensor(mask, device=device)
    if tuple(m.shape) not in ((n_docs,), (batch, n_docs)):
        raise ValueError(f"filter mask must be ({n_docs},) or ({batch}, {n_docs}), "
                         f"got {tuple(m.shape)}")
    return (m if m.dtype == torch.bool else m != 0).contiguous()


def lookup_filt_bits(mask: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The keep bits of a per-doc bitmap ((N,) shared or (B, N) per query)
    at the candidate ids (B, d); id -1 slots read doc 0 (callers AND with
    ``ids >= 0``)."""
    safe = ids.clamp_min(0).long()
    bits = mask[safe] if mask.dim() == 1 else torch.gather(mask, 1, safe)
    return bits != 0


def mask_and_topk(
    s: torch.Tensor, i: torch.Tensor, keep: torch.Tensor, depth: int, n: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The mask-then-re-reduce tail of every post-hoc candidate filter: kept
    slots keep the inner stage's (score, id), dropped ones become (-inf,
    -1), and the survivors re-reduce to the top ``min(depth, n)``.  Equal
    scores keep the inner stage's order (a stable sort, as ``lax.top_k``)."""
    s = torch.where(keep, s, torch.full_like(s, -torch.inf))
    i = torch.where(keep, i, torch.full_like(i, -1))
    top_s, pos = stable_topk(s, min(depth, n))
    return top_s, torch.gather(i, 1, pos.long())


# --------------------------------------------------------------------------
# Matchers
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FakeWordsMatcher:
    """Classic (tf-idf, bf16 x bf16 -> f32) or dot (int8 x int8 -> int32)
    scoring over the stored matrix, df-prune keep-mask folded into the
    query; over a packed ``pq`` store both modes take a bf16 query.
    ``df_num_docs`` (when set) is the collection size the keep-mask
    thresholds against instead of the index's own row count: a segmented
    index scores every segment under the collection's statistics."""

    scoring: str = "classic"
    df_max_ratio: float = 1.0
    df_num_docs: Optional[int] = None

    def quantized_query(self, index, q_tf: torch.Tensor) -> torch.Tensor:
        """bf16 query operand of the packed-postings path: the store is
        dequantized to the query dtype in the score stage, so the query is
        float (the dot mode's [u; -u] lift is exact in bf16)."""
        if self.scoring == "classic":
            return fakewords.classic_query(index, q_tf, self.df_max_ratio,
                                           num_docs=self.df_num_docs)
        return fakewords.dot_query(index, q_tf, self.df_max_ratio, dtype=torch.bfloat16,
                                   num_docs=self.df_num_docs)

    def __call__(
        self, index, q_tf: torch.Tensor, depth: int, filt: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        d = min(depth, index.num_docs)
        if index.pq is not None:
            return fused.postings_topk(index.pq, self.quantized_query(index, q_tf), d, filt=filt)
        topk = fused.classic_topk if self.scoring == "classic" else fused.dot_topk
        return topk(index, q_tf, d, self.df_max_ratio, filt=filt, num_docs=self.df_num_docs)


@dataclasses.dataclass(frozen=True)
class LshMatcher:
    """MinHash signature-collision counting (K1's lsh mode)."""

    def __call__(
        self, index, sig_q: torch.Tensor, depth: int, filt: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        d = min(depth, index.num_docs)
        return fused.lsh_topk(sig_q, index.sig, d, filt=filt)


@dataclasses.dataclass(frozen=True)
class KdScanMatcher:
    """Exact L2 in the reduced space on K1 f32, through the [2q; 1] x
    [d; -||d||^2] lift (the index's ``lifted``, or lifted here when a
    loaded index lacks it)."""

    def __call__(
        self, index, q_reduced: torch.Tensor, depth: int, filt: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        lifted = index.lifted if index.lifted is not None else fused.lift_l2(index.reduced)
        return fused.scan_l2_topk(lifted, q_reduced, min(depth, index.num_docs), filt=filt)


@dataclasses.dataclass(frozen=True)
class KdTreeMatcher:
    """The batched k-d tree DFS (the paper's data structure), plain torch on
    the index's device.  The DFS cannot take a bitmap into its visit order,
    so ``filt`` masks its depth candidates after the search (a best-effort
    post-filter, as in the reference: with a selective mask fewer than
    ``depth`` kept docs come back; the scan backend is the exact filtered
    path)."""

    def __call__(
        self, index, q_reduced: torch.Tensor, depth: int, filt: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        n = index.num_docs
        s, i = kdtree.tree_search(index, q_reduced, min(depth, n))
        if filt is None:
            return s, i
        keep = (i >= 0) & lookup_filt_bits(filt, i)
        return mask_and_topk(s, i, keep, depth, n)


@dataclasses.dataclass(frozen=True)
class CosineMatcher:
    """Exact cosine over the stored unit vectors (brute-force oracle), or
    over their packed int8 / int4 postings (``pq``) with the f32 query."""

    def __call__(
        self, index, q_norm: torch.Tensor, depth: int, filt: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        d = min(depth, index.num_docs)
        if index.pq is not None:
            return fused.postings_topk(index.pq, q_norm.contiguous(), d, filt=filt)
        return fused.cosine_topk(index.vectors, q_norm.contiguous(), d, filt=filt)


@dataclasses.dataclass(frozen=True)
class GraphMatcher:
    """Batched beam search over the proximity graph
    (:func:`repro_torch.core.graph.search_graph`): a query scores about
    ``iters * beam * total_degree`` rows on K3, whatever N.  ``filt``
    (liveDocs and any predicate) is consulted inside the traversal: masked
    nodes stay traversable and are never emitted.  On the card the
    traversal is one CUDA graph per shape and index.  It has no blockmax
    stage: ``AnnIndex`` refuses ``blockmax_keep`` for it."""

    ef: int = 64
    beam: int = 4
    iters: int = 32

    def __call__(
        self, index, q_norm: torch.Tensor, depth: int, filt: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        d = min(depth, index.num_docs)
        return graph.search_graph(index.vectors, index.neighbors, index.entry, q_norm, d,
                                  ef=self.ef, beam=self.beam, iters=self.iters,
                                  n_docs=index.num_docs, filt=filt)


@dataclasses.dataclass(frozen=True)
class BlockMaxMatcher:
    """Two-stage blockmax pruning as a matcher stage: block-bound pass ->
    keep ``n_keep`` blocks -> exact scoring of their rows through the
    gathered fused top-k kernel.  The mode (classic / dot / lsh) travels
    with ``bm``; ``filt`` masks stage 2 (:func:`blockmax.pruned_topk`)."""

    n_keep: int
    bm: blockmax.BlockMaxIndex

    def __call__(
        self, index, q_rep: torch.Tensor, depth: int, filt: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        return blockmax.pruned_topk(index, self.bm, q_rep, self.n_keep, depth, filt=filt)


@dataclasses.dataclass(frozen=True)
class FilterMask:
    """Per-doc predicate masking as a match-stage wrapper: Lucene's liveDocs
    generalised to any keep bitmap.  Masked docs come back as (-inf, -1)
    inside the match stage, never filtered out of its output, so ``depth``
    keeps its meaning.  Two ways, chosen per call:

      * ``native=True``: the mask goes into the inner matcher's kernel (its
        ``filt`` operand): one pass, exact at any selectivity.
      * ``native=False`` (default): depth inflation.  The inner matcher
        returns ``min(depth + extra, n)`` unfiltered candidates, which are
        masked and re-reduced to the top ``depth`` (:func:`mask_and_topk`).
        When at most ``extra`` of them are masked, every one of the best
        ``depth`` kept docs is among them.  On the card ``depth + extra``
        must stay within the kernel's depth limit (the call raises past it).

    Equal scores keep the inner matcher's lowest-id order.  ``mask`` is
    (N,) or (B, N), bool / uint8 / int32, tensor or numpy (nonzero = keep);
    it is converted by :func:`as_filter`."""

    inner: Any
    extra: int = 0

    def __call__(
        self, index, q_rep: torch.Tensor, depth: int, mask, native: bool = False,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        n = index.num_docs
        filt = as_filter(mask, n, q_rep.shape[0], index.device)
        if native:
            return self.inner(index, q_rep, min(depth, n), filt=filt)
        s, i = self.inner(index, q_rep, min(depth + self.extra, n))
        keep = (i >= 0) & lookup_filt_bits(filt, i)
        return mask_and_topk(s, i, keep, depth, n)


# The deletes-only name of the wrapper this generalises.
LiveDocsMatcher = FilterMask


# --------------------------------------------------------------------------
# Rerankers
# --------------------------------------------------------------------------


def candidate_scores(
    index, queries: torch.Tensor, cand_ids: torch.Tensor, quantized: bool = False
) -> torch.Tensor:
    """(B, d) cosine of each candidate against its unit query; id -1 =
    padding, masked to -inf.  ``quantized`` reads the int8 store
    (``index.vq``: the gather moves ~4x fewer bytes, then one per-doc
    multiply) instead of the fp32 originals."""
    safe = cand_ids.clamp_min(0).long()
    if quantized:
        if index.vq is None:
            raise ValueError("quantized rerank requires the index to carry an int8 store "
                             "(build with rerank_store='int8')")
        # (B, d, dim) int8 gather, one per-doc multiply
        return bruteforce.gathered_scores(queries, index.vq.q[safe], cand_ids,
                                          scale=index.vq.scale[safe])
    if index.vectors is None:
        raise ValueError("rerank requires the index to keep original vectors "
                         "(build with rerank_store='exact')")
    return bruteforce.gathered_scores(queries, index.vectors[safe], cand_ids)


@dataclasses.dataclass(frozen=True)
class ExactCosineReranker:
    """Gather the depth-d candidates' original vectors, exact cosine, top-k
    (id -1 = padding, masked to -inf)."""

    def __call__(
        self, index, queries: torch.Tensor, cand_ids: torch.Tensor, k: int
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        if index.vectors is None:
            raise ValueError("rerank requires the index to keep original vectors "
                             "(build with rerank_store='exact')")
        return bruteforce.rerank_exact(index.vectors, queries, cand_ids, k, normalized=True)


@dataclasses.dataclass(frozen=True)
class QuantizedCosineReranker:
    """Rerank from the int8 + per-doc-scale store: the ties of
    :class:`ExactCosineReranker`, a score error of at most
    ``||q||_1 * scale / 2`` per candidate, ~4x fewer gather bytes."""

    def __call__(
        self, index, queries: torch.Tensor, cand_ids: torch.Tensor, k: int
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        scores = candidate_scores(index, queries, cand_ids, quantized=True)
        return bruteforce.top_candidates(scores, cand_ids, k)


def default_reranker(index):
    """Exact rerank when the fp32 originals are stored, else the int8 store."""
    if index.vectors is None and index.vq is not None:
        return QuantizedCosineReranker()
    return ExactCosineReranker()


# --------------------------------------------------------------------------
# The pipeline
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SearchPipeline:
    """encode -> match [-> blockmax prune] -> optional rerank."""

    encoder: Any
    matcher: Any
    reranker: Any = ExactCosineReranker()

    def search(
        self, index, queries: torch.Tensor, params: SearchParams = SearchParams(),
        filt=None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """End-to-end staged search.  ``filt`` is a per-doc keep bitmap ((N,)
        or (B, N); bool, uint8 or int32, tensor or numpy; nonzero = keep),
        applied inside the match stage's score pass; the rerank only
        rescores the survivors, so a masked doc never comes back."""
        filt = as_filter(filt, index.num_docs, queries.shape[0], index.device)
        q_norm = bruteforce.l2_normalize(queries)
        q_rep = self.encoder(index, q_norm)
        d_s, d_i = self.matcher(index, q_rep, params.depth, filt=filt)
        if not params.rerank:
            return d_s[:, : params.k], d_i[:, : params.k]
        return self.reranker(index, q_norm, d_i, params.k)


def match_rerank(
    matcher,
    index,
    q_rep: torch.Tensor,
    queries: Optional[torch.Tensor],
    k: int,
    depth: int,
    rerank: bool,
    reranker=None,
    filt: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Match + optional rerank from an already-encoded query: the shared
    tail of the serving layer's search (``queries`` unit-normalized when
    reranking).  ``reranker`` defaults to the store the index carries (fp32
    originals, else the int8 store).  ``filt`` (a bool keep bitmap on the
    index's device, as :func:`as_filter` makes it) masks inside the match
    stage; the rerank only rescores the survivors.  Unlike the
    reference's, it takes no ``bm``: a :class:`BlockMaxMatcher` carries its
    own blockmax structure."""
    d_s, d_i = matcher(index, q_rep, depth, filt=filt)
    if not rerank:
        return d_s[:, :k], d_i[:, :k]
    if queries is None:
        raise ValueError("rerank needs the unit-normalized queries")
    if reranker is None:
        reranker = default_reranker(index)
    return reranker(index, queries, d_i, k)


def make_encoder(config: AnyConfig):
    if isinstance(config, FakeWordsConfig):
        return TfRowEncoder(config)
    if isinstance(config, LexicalLshConfig):
        return MinHashEncoder(config)
    if isinstance(config, KdTreeConfig):
        return ReducedPointEncoder()
    if isinstance(config, (BruteForceConfig, GraphConfig)):
        return IdentityEncoder()
    raise TypeError(f"unknown config {type(config)}")


def make_matcher(config: AnyConfig):
    if isinstance(config, FakeWordsConfig):
        return FakeWordsMatcher(scoring=config.scoring, df_max_ratio=config.df_max_ratio)
    if isinstance(config, LexicalLshConfig):
        return LshMatcher()
    if isinstance(config, KdTreeConfig):
        return KdTreeMatcher() if config.backend == "tree" else KdScanMatcher()
    if isinstance(config, BruteForceConfig):
        return CosineMatcher()
    if isinstance(config, GraphConfig):
        return GraphMatcher(ef=config.ef, beam=config.beam, iters=config.search_iters)
    raise TypeError(f"unknown config {type(config)}")


def build_pipeline(config: AnyConfig) -> SearchPipeline:
    return SearchPipeline(encoder=make_encoder(config), matcher=make_matcher(config))
