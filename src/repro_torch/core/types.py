"""Typed configuration and index containers (port of ``repro/core/types.py``).

The configs and containers of every encoding (fake words, lexical LSH, the
k-d tree, brute force and the proximity graph), with the quantized stores of the read path (int8/int4 primary postings, the
int8 rerank store) and the per-document metadata of filtered search.
Configs are frozen dataclasses; index containers hold tensors on one device.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Iterable, Mapping, Optional, Tuple

import torch

_EPOCHS = itertools.count(1)


def next_epoch() -> int:
    """Process-unique, monotonically increasing index epoch: the identity of
    a searchable snapshot.  Every ``SegmentedAnnIndex`` a writer's refresh
    makes visible gets a new one (an unchanged refresh keeps the old), so a
    result cache keyed on it never serves another snapshot's results."""
    return next(_EPOCHS)


@dataclasses.dataclass(frozen=True)
class FakeWordsConfig:
    """Fake-words encoding (Amato et al. 2016, as used in the paper).

    quantization: Q; tf(tau_i, d) = round(Q * w_i) for the sign-split feature.
    df_max_ratio: query terms with df > df_max_ratio * N are dropped; 1.0 = off.
    scoring: "classic" (Lucene ClassicSimilarity) or "dot" (quantized inner
        product).
    store_dtype: dtype of the stored term-frequency matrix: int8 (the
        kernel's integer operand), given as ``torch.int8`` or ``"int8"`` (as
        the reference's ``config.json`` writes it).
    signed_store: the reference's half-width signed dot store; refused, as
        the reference's search of such an index raises.
    """

    quantization: int = 50
    df_max_ratio: float = 1.0
    scoring: str = "classic"
    store_dtype: Any = torch.int8
    signed_store: bool = False

    def __post_init__(self) -> None:
        if not (1 <= self.quantization <= 127):
            raise ValueError(f"quantization must be in [1,127], got {self.quantization}")
        if self.scoring not in ("classic", "dot"):
            raise ValueError(f"scoring must be 'classic' or 'dot', got {self.scoring}")
        if self.signed_store:
            raise NotImplementedError(
                "signed_store is not ported: the reference's own search raises on it "
                "(ROADMAP.md §C, reference caveats)"
            )
        if self.store_dtype not in (torch.int8, "int8"):
            raise ValueError(f"store_dtype must be int8, got {self.store_dtype!r}")
        object.__setattr__(self, "store_dtype", torch.int8)


@dataclasses.dataclass(frozen=True)
class LexicalLshConfig:
    """Lexical LSH encoding (paper §2).

    Each feature is rounded to ``decimals`` decimal places and tagged with
    its feature index (``2_0.4``), optionally aggregated into ``ngram``-grams,
    then MinHashed with ``hashes`` hash functions into ``buckets`` buckets
    (Lucene's MinHashFilter).  The paper's settings: (b=300, h=1) and
    (b=50, h=30), with n in {1, 2}.
    """

    buckets: int = 300
    hashes: int = 1
    ngram: int = 1
    decimals: int = 1
    seed: int = 0x5EED

    def __post_init__(self) -> None:
        if self.ngram not in (1, 2, 3):
            raise ValueError("ngram in {1,2,3} supported")
        if self.buckets < 1 or self.hashes < 1:
            raise ValueError("buckets and hashes must be >= 1")


@dataclasses.dataclass(frozen=True)
class KdTreeConfig:
    """k-d tree over dimensionality-reduced vectors (paper §2, third method).

    Lucene's BKD point index handles at most 8 dimensions, so the 300-d
    embeddings are first reduced with PCA or PPA -> PCA -> PPA
    (:mod:`repro_torch.core.pca`).  ``backend``:
      * "tree" - the array-encoded balanced k-d tree, searched by a batched
                 lock-step DFS (:func:`repro_torch.core.kdtree.tree_search`);
      * "scan" - a scan of the reduced points on K1 f32 (the [2q; 1] x
                 [d; -||d||^2] lift): the same neighbours, exact L2 in the
                 reduced space.
    """

    dims: int = 8
    reduction: str = "pca"  # "pca" | "ppa-pca-ppa"
    ppa_remove: int = 3  # top components removed by PPA (d/100 per Mu et al.)
    backend: str = "scan"  # "tree" | "scan"
    leaf_size: int = 32

    def __post_init__(self) -> None:
        if self.dims > 8:
            raise ValueError("Lucene BKD supports at most 8 dims (paper constraint)")
        if self.reduction not in ("pca", "ppa-pca-ppa"):
            raise ValueError(f"unknown reduction {self.reduction}")
        if self.backend not in ("tree", "scan"):
            raise ValueError(f"unknown backend {self.backend}")


@dataclasses.dataclass(frozen=True)
class BruteForceConfig:
    """Exact cosine scan over the stored unit vectors (the ground truth as a
    method)."""


@dataclasses.dataclass(frozen=True)
class GraphConfig:
    """Flat navigable-graph encoding (user-facing method name ``"hnsw"``).

    A single-layer Vamana-style proximity graph, not a literal multi-layer
    HNSW: fixed-degree int32 adjacency and a fixed-iteration batched beam
    search keep every shape static (:mod:`repro_torch.core.graph`).  A
    query scores about ``entries + iters * beam * total_degree`` rows,
    sublinear in N.

    degree:          forward edges per node (alpha-pruned nearest-out).
    reverse_degree:  extra slots filled with reverse edges; total fixed
                     degree = degree + reverse_degree; absent edges are -1.
    ef_construction: exact-kNN candidate pool size per node at build time.
    alpha:           Vamana robust-prune slack (1.0 = pure greedy prune).
    ef:              search-time candidate list size.
    beam:            nodes expanded per traversal iteration.
    iters:           traversal iterations; 0 derives ``ceil(2 * ef / beam)``.
    entries:         entry points seeding the search (medoid + strided).
    build_tile:      the reference's doc tile of its exact-kNN pass; the
                     port's pools run on K1, which tiles on its own, so it
                     only round-trips through ``config.json``.
    """

    degree: int = 16
    reverse_degree: int = 16
    ef_construction: int = 64
    alpha: float = 1.2
    ef: int = 64
    beam: int = 4
    iters: int = 0
    entries: int = 4
    build_tile: int = 2048

    def __post_init__(self) -> None:
        if self.degree < 1:
            raise ValueError(f"degree must be >= 1, got {self.degree}")
        if self.reverse_degree < 0:
            raise ValueError("reverse_degree must be >= 0")
        if self.ef_construction < self.degree:
            raise ValueError(
                f"ef_construction {self.ef_construction} < degree {self.degree}")
        if self.alpha < 1.0:
            raise ValueError(f"alpha must be >= 1.0, got {self.alpha}")
        if self.ef < 1 or self.beam < 1 or self.entries < 1:
            raise ValueError("ef, beam and entries must be >= 1")
        if self.iters < 0:
            raise ValueError("iters must be >= 0 (0 = derive from ef/beam)")
        if self.build_tile < 1:
            raise ValueError("build_tile must be >= 1")

    @property
    def total_degree(self) -> int:
        return self.degree + self.reverse_degree

    @property
    def search_iters(self) -> int:
        if self.iters:
            return self.iters
        return max(1, -(-2 * self.ef // self.beam))


@dataclasses.dataclass(frozen=True)
class SearchParams:
    """Retrieve ``depth`` candidates, optionally exact-rerank them to ``k``."""

    k: int = 10
    depth: int = 100
    rerank: bool = False


@dataclasses.dataclass(frozen=True)
class DocMetadata:
    """Per-document structured metadata, the predicate source of filtered
    search.

    values:      (N, F) int32; column f holds field ``field_names[f]``,
                 integer-coded by the caller (categorical codes, bucketed
                 timestamps, ...).
    field_names: the F field names.

    The ``*_mask`` helpers return (N,) bool keep bitmaps on the values'
    device, the ``filt`` operand of ``AnnIndex.search``; predicates compose
    with ``&`` / ``|`` on the bitmaps.
    """

    values: torch.Tensor
    field_names: Tuple[str, ...]

    @classmethod
    def from_fields(cls, fields: Mapping[str, Any], device=None) -> "DocMetadata":
        """Build from a ``{field_name: (N,) ints}`` mapping (numpy arrays or
        tensors; insertion order fixes the column order)."""
        names = tuple(fields.keys())
        cols = [torch.as_tensor(fields[n], device=device).to(torch.int32) for n in names]
        return cls(values=torch.stack(cols, dim=1), field_names=names)

    @property
    def num_docs(self) -> int:
        return self.values.shape[0]

    def _col(self, field: str) -> torch.Tensor:
        return self.values[:, self.field_names.index(field)]

    def eq_mask(self, field: str, value: int) -> torch.Tensor:
        """(N,) bool: field == value."""
        return self._col(field) == value

    def in_mask(self, field: str, values: Iterable[int]) -> torch.Tensor:
        """(N,) bool: field in values (a small value set)."""
        col = self._col(field)
        out = torch.zeros(col.shape, dtype=torch.bool, device=col.device)
        for v in values:
            out |= col == v
        return out

    def range_mask(
        self, field: str, lo: Optional[int] = None, hi: Optional[int] = None
    ) -> torch.Tensor:
        """(N,) bool: lo <= field < hi (either bound optional)."""
        col = self._col(field)
        out = torch.ones(col.shape, dtype=torch.bool, device=col.device)
        if lo is not None:
            out &= col >= lo
        if hi is not None:
            out &= col < hi
        return out

    def nbytes(self) -> int:
        return self.values.numel() * self.values.element_size()


@dataclasses.dataclass(frozen=True)
class QuantizedStore:
    """int8 symmetric per-doc quantized rerank store.

    q:     (N, dim) int8, q[d] = round(v[d] / scale[d]).
    scale: (N,) float32, max_i |v[d, i]| / 127.

    A unit query's rerank score error is at most ``||q||_1 * scale[d] / 2``;
    the rerank gather moves ~4x fewer bytes than the fp32 originals.
    """

    q: torch.Tensor
    scale: torch.Tensor

    @property
    def num_docs(self) -> int:
        return self.q.shape[0]

    def nbytes(self) -> int:
        return _nbytes(self.q, self.scale)


@dataclasses.dataclass(frozen=True)
class QuantizedPostings:
    """Packed int8/int4 primary postings + dequantization scales.

    bits == 8 (per-doc scale):
      q:     (N, T) int8, round(mat[d, t] / scale[d]).
      scale: (N, 1) float32, max_t |mat[d, t]| / 127.  It factors out of
             the dot: scores are (query @ q.T) * scale, one multiply per
             (query, doc) after the sum.
    bits == 4 (one scale per ``group`` columns):
      q:     (N, Tg/2) uint8, column pairs packed low | high << 4, with
             Tg = round_up(T, group); nibble = clip(round(mat / gs), -8, 7)
             + 8, so the zero pad columns encode as nibble 8 and dequantize
             to 0.
      scale: (N, Tg/group) float32, max |group| / 7.

    ``cols`` is the logical column count T.
    """

    q: torch.Tensor
    scale: torch.Tensor
    bits: int
    group: int = 0
    cols: int = 0

    @property
    def num_docs(self) -> int:
        return self.q.shape[0]

    def nbytes(self) -> int:
        return _nbytes(self.q, self.scale)


def _nbytes(*parts) -> int:
    """Bytes of the given tensors and of the containers that count their
    own (quantized stores, reduction models); None skipped."""
    return sum(p.numel() * p.element_size() if isinstance(p, torch.Tensor) else p.nbytes()
               for p in parts if p is not None)


@dataclasses.dataclass(frozen=True)
class FakeWordsIndex:
    """Sign-split quantized term-frequency index.

    tf:      (N, 2m) integer term frequencies (round(Q*relu(w)) | round(Q*relu(-w))),
             or None when ``pq`` holds the dot-mode int4 store.
    idf:     (2m,) float32, 1 + ln(N / (df + 1)).
    norm:    (N,) float32, 1 / sqrt(doc_len).
    df:      (2m,) int32 document frequency per fake term.
    scored:  (N, 2m) bfloat16 sqrt(tf) * idf^2 * norm (classic mode), or None
             (dot mode, or classic with the matrix stored quantized in ``pq``).
    vectors: (N, dim) float32 unit originals for exact rerank, or None.
    vq:      int8 :class:`QuantizedStore` rerank store, or None.
    pq:      :class:`QuantizedPostings`, or None: classic packs ``scored``
             (then dropped); dot int4 packs ``tf`` (then dropped); dot int8
             needs none, the int8 ``tf`` is its own int8 store.
    """

    tf: Optional[torch.Tensor]
    idf: torch.Tensor
    norm: torch.Tensor
    df: torch.Tensor
    scored: Optional[torch.Tensor] = None
    vectors: Optional[torch.Tensor] = None
    vq: Optional[QuantizedStore] = None
    pq: Optional[QuantizedPostings] = None

    @property
    def num_docs(self) -> int:
        return self.norm.shape[0]

    @property
    def device(self) -> torch.device:
        return self.norm.device

    def nbytes(self) -> int:
        return _nbytes(self.tf, self.idf, self.norm, self.df, self.scored, self.vectors,
                       self.vq, self.pq)


@dataclasses.dataclass(frozen=True)
class LshIndex:
    """MinHash signature index.

    sig:     (N, h*b) uint32 signatures; 0xFFFFFFFF marks empty buckets.
    vectors: (N, dim) float32 unit originals for exact rerank, or None.
    vq:      int8 :class:`QuantizedStore` rerank store, or None.
    """

    sig: torch.Tensor
    vectors: Optional[torch.Tensor] = None
    vq: Optional[QuantizedStore] = None

    @property
    def num_docs(self) -> int:
        return self.sig.shape[0]

    @property
    def device(self) -> torch.device:
        return self.sig.device

    def nbytes(self) -> int:
        return _nbytes(self.sig, self.vectors, self.vq)


@dataclasses.dataclass(frozen=True)
class KdTreeIndex:
    """Reduced-space index.

    reduced:   (N, dims) float32 reduced points (the BKD tree's points).
    reduction: the fitted reduction model (``pca.PcaModel`` or
               ``pca.PpaPcaPpaModel``) that projects the queries.
    split_*:   the array-encoded balanced k-d tree (backend "tree"):
               ``split_dim`` (n_internal,) int32, ``split_val``
               (n_internal,) float32; ``perm`` (n_leaves, leaf_size) int32
               maps leaf slots to doc ids (-1 = padding).
    lifted:    (N, dims + 1) float32 ``[d; -||d||^2]``, the scan's K1 f32
               operand, made at build time.
    vectors:   (N, dim) float32 unit originals for exact rerank, or None.
    vq:        int8 :class:`QuantizedStore` rerank store, or None.
    """

    reduced: torch.Tensor
    reduction: Any
    split_dim: Optional[torch.Tensor] = None
    split_val: Optional[torch.Tensor] = None
    perm: Optional[torch.Tensor] = None
    lifted: Optional[torch.Tensor] = None
    vectors: Optional[torch.Tensor] = None
    vq: Optional[QuantizedStore] = None

    @property
    def num_docs(self) -> int:
        return self.reduced.shape[0]

    @property
    def device(self) -> torch.device:
        return self.reduced.device

    def nbytes(self) -> int:
        return _nbytes(self.reduced, self.reduction, self.split_dim, self.split_val, self.perm,
                       self.lifted, self.vectors, self.vq)


@dataclasses.dataclass(frozen=True)
class FlatIndex:
    """Brute-force index: the unit-normalized float32 vectors (N, dim) are
    the match operand, unless ``pq`` holds int8/int4 packed postings; then
    ``vectors`` is kept only if the rerank store keeps it.  ``vq`` is the
    int8 rerank store, or None."""

    vectors: Optional[torch.Tensor]
    vq: Optional[QuantizedStore] = None
    pq: Optional[QuantizedPostings] = None

    @property
    def num_docs(self) -> int:
        return (self.vectors if self.vectors is not None else self.pq.q).shape[0]

    @property
    def device(self) -> torch.device:
        return (self.vectors if self.vectors is not None else self.pq.q).device

    def nbytes(self) -> int:
        return _nbytes(self.vectors, self.vq, self.pq)


@dataclasses.dataclass(frozen=True)
class GraphIndex:
    """Flat proximity-graph index.

    vectors:   (N, dim) float32 unit rows: the match operand (each
               neighbour block is scored exactly from it by K3) and the
               rerank store, so graph scores are exact cosines and only
               the set of visited rows is approximate.
    neighbors: (N, degree + reverse_degree) int32 adjacency; -1 = no edge.
    entry:     (entries,) int32 entry points: the medoid (the row whose dot
               with the corpus mean is largest), then strided rows.
    vq:        int8 :class:`QuantizedStore` rerank store, or None.
    """

    vectors: torch.Tensor
    neighbors: torch.Tensor
    entry: torch.Tensor
    vq: Optional[QuantizedStore] = None

    @property
    def num_docs(self) -> int:
        return self.vectors.shape[0]

    @property
    def total_degree(self) -> int:
        return self.neighbors.shape[1]

    @property
    def device(self) -> torch.device:
        return self.vectors.device

    def nbytes(self) -> int:
        return _nbytes(self.vectors, self.neighbors, self.entry, self.vq)
