"""Staged index construction (port of ``repro/core/builder.py``):

    normalize rows -> transform vectors (tf rows / MinHash signatures /
                                         reduced points + model / identity)
                   -> assemble postings (index container + global stats,
                                         optionally packed int8 / int4;
                                         the k-d tree's lift and tree arrays;
                                         the graph's adjacency)
                   -> attach rerank store (fp32 originals / int8 + scale / none)

Each stage is a frozen dataclass; :class:`BuildPipeline` runs them on the
device of the vectors it is given.  The quantized arrays are bit-equal to
the reference's: ``torch.round`` rounds half to even like ``jnp.round``,
and every division stays a division.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Union

import torch

from repro_torch.core import bruteforce, fakewords, graph, kdtree, lexical_lsh, pca
from repro_torch.core.types import (
    BruteForceConfig,
    DocMetadata,
    FakeWordsConfig,
    FakeWordsIndex,
    FlatIndex,
    GraphConfig,
    GraphIndex,
    KdTreeConfig,
    KdTreeIndex,
    LexicalLshConfig,
    LshIndex,
    QuantizedPostings,
    QuantizedStore,
)
from repro_torch.kernels import common
from repro_torch.kernels.fused_topk import ops as fused

AnyConfig = Union[FakeWordsConfig, LexicalLshConfig, KdTreeConfig, BruteForceConfig, GraphConfig]

RERANK_STORES = ("exact", "int8", "none")
PRIMARY_POSTINGS = ("fp32", "int8", "int4")
POSTINGS_GROUPS = (32, 64)

_QUANT_POSTINGS_MSG = (
    "quantized primary postings support fake-words (classic/dot) and brute "
    "force; the LSH signature store is categorical (uint32 MinHash buckets: "
    "scaling them is meaningless) and the kd-tree reduced store is already ~8 "
    "f32 columns with a mixed-magnitude L2-lift column; use rerank_store='int8' "
    "for their memory knob"
)


# --------------------------------------------------------------------------
# Vector transforms
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TfTransform:
    """Fake words: sign-split quantized term-frequency rows."""

    config: FakeWordsConfig

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        return fakewords.encode(v, self.config.quantization, self.config.store_dtype)


@dataclasses.dataclass(frozen=True)
class MinHashTransform:
    """Lexical LSH: MinHash signatures (row-local)."""

    config: LexicalLshConfig

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        return lexical_lsh.encode(v, self.config)


@dataclasses.dataclass(frozen=True)
class ReductionTransform:
    """k-d tree: fit PCA or PPA -> PCA -> PPA and project the rows.  Returns
    (reduced f32 rows, fitted model): the model lands in the index, and the
    queries project through it at search time."""

    config: KdTreeConfig

    def __call__(self, v: torch.Tensor):
        model, reduced = pca.fit_reduction(v, self.config.dims, self.config.reduction,
                                           self.config.ppa_remove)
        return reduced.to(torch.float32), model


@dataclasses.dataclass(frozen=True)
class IdentityTransform:
    """Brute force and the graph: the unit-normalized rows themselves."""

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        return v


# --------------------------------------------------------------------------
# Primary-postings quantization
# --------------------------------------------------------------------------


def quantize_postings(mat: torch.Tensor, bits: int = 8, group: int = 32) -> QuantizedPostings:
    """Quantize a posting matrix row by row.

    bits=8: per-doc scale = max|row| / 127, q = round(mat / scale) int8.
    bits=4: the columns are zero-padded to a multiple of ``group``; per-group
    scale = max|group| / 7, nibble = clip(round(v / scale), -8, 7) + 8, and
    column pairs packed low | high << 4 into one uint8.  Zero pad columns
    encode as nibble 8 and dequantize to exactly 0; the per-element error is
    at most scale / 2."""
    m = mat.to(torch.float32)
    n, t = m.shape
    if bits == 8:
        amax = m.abs().amax(dim=-1, keepdim=True)
        scale = torch.clamp_min(amax, 1e-12) / 127.0
        q = torch.round(m / scale).to(torch.int8)
        return QuantizedPostings(q=q, scale=scale, bits=8, group=0, cols=t)
    if bits != 4:
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    tg = common.round_up(t, group)
    if tg != t:
        m = torch.nn.functional.pad(m, (0, tg - t))
    grouped = m.reshape(n, tg // group, group)
    amax = grouped.abs().amax(dim=-1)
    scale = torch.clamp_min(amax, 1e-12) / 7.0  # (n, tg / group)
    nib = torch.clamp(torch.round(grouped / scale[:, :, None]), -8, 7) + 8
    nib = nib.reshape(n, tg).to(torch.uint8)
    packed = nib[:, 0::2] | (nib[:, 1::2] << 4)
    return QuantizedPostings(q=packed, scale=scale, bits=4, group=group, cols=t)


def dequantize_postings(pq: QuantizedPostings, dtype=torch.float32) -> torch.Tensor:
    """The (N, cols) posting matrix in ``dtype``, in the canonical dequant
    order (f32 value * scale, then one cast).  It materializes the whole
    matrix: for bounds, tests and error analysis, never the read path."""
    if pq.bits == 8:
        return (pq.q.to(torch.float32) * pq.scale).to(dtype)
    return common.dequant_int4(pq.q, pq.scale, pq.group, dtype)[:, : pq.cols]


@dataclasses.dataclass(frozen=True)
class PostingsQuantizer:
    """Build stage that packs the method's match-stage matrix (classic
    ``scored``, dot ``tf``, brute-force vectors) into
    :class:`QuantizedPostings`."""

    bits: int = 8
    group: int = 32

    def __call__(self, mat: torch.Tensor) -> QuantizedPostings:
        return quantize_postings(mat, self.bits, self.group)


# --------------------------------------------------------------------------
# Postings assembly
# --------------------------------------------------------------------------


def live_df(tf: torch.Tensor, live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-term document frequency over the (optionally live-masked) rows."""
    present = tf > 0
    if live is not None:
        present = present & live[:, None]
    return present.sum(0, dtype=torch.int32)


def idf_from_df(df: torch.Tensor, n_total: int) -> torch.Tensor:
    """Lucene ClassicSimilarity idf = 1 + ln(N / (df + 1)), float32."""
    return 1.0 + torch.log(n_total / (df.to(torch.float32) + 1.0))


def classic_scored(tf: torch.Tensor, idf: torch.Tensor, norm: torch.Tensor) -> torch.Tensor:
    """Per-(doc, term) classic scoring matrix sqrt(tf_d) * idf^2 * norm_d in
    bf16, so query scoring is one product."""
    tf_f = tf.to(torch.float32)
    return (torch.sqrt(tf_f) * (idf**2)[None, :] * norm[:, None]).to(torch.bfloat16)


@dataclasses.dataclass(frozen=True)
class FakeWordsPostings:
    """df / idf / norm statistics + the precomputed classic scoring matrix.

    With a ``quantizer`` the match-stage store is packed after the
    statistics: classic packs ``scored`` and drops it (``tf`` stays); dot
    int8 is a no-op (the int8 ``tf`` is the int8 store); dot int4 packs
    ``tf`` and drops it."""

    config: FakeWordsConfig
    quantizer: Optional[PostingsQuantizer] = None

    def __call__(self, tf: torch.Tensor, v: torch.Tensor, store: dict,
                 n_total: int) -> FakeWordsIndex:
        df = live_df(tf)
        idf = idf_from_df(df, n_total)
        doc_len = tf.to(torch.float32).sum(-1)
        norm = torch.rsqrt(torch.clamp_min(doc_len, 1.0))
        scored = pq = None
        if self.config.scoring == "classic":
            scored = classic_scored(tf, idf, norm)
            if self.quantizer is not None:
                pq, scored = self.quantizer(scored), None
        elif self.quantizer is not None and self.quantizer.bits == 4:
            pq, tf = self.quantizer(tf), None
        return FakeWordsIndex(tf=tf, idf=idf, norm=norm, df=df, scored=scored, pq=pq, **store)


@dataclasses.dataclass(frozen=True)
class LshPostings:
    """Signatures carry their own statistics: pure container assembly."""

    def __call__(self, sig: torch.Tensor, v: torch.Tensor, store: dict,
                 n_total: int) -> LshIndex:
        return LshIndex(sig=sig, **store)


@dataclasses.dataclass(frozen=True)
class KdTreePostings:
    """Reduced points + the scan's lifted operand; with backend "tree" also
    the tree arrays, built on the host (numpy) and moved to the points'
    device."""

    config: KdTreeConfig

    def __call__(self, rep, v: torch.Tensor, store: dict, n_total: int) -> KdTreeIndex:
        reduced, model = rep
        tree = {}
        if self.config.backend == "tree":
            sd, sv, pm, _ = kdtree._build_arrays(reduced.cpu().numpy(), self.config.leaf_size)
            tree = {name: torch.from_numpy(a).to(reduced.device)
                    for name, a in (("split_dim", sd), ("split_val", sv), ("perm", pm))}
        return KdTreeIndex(reduced=reduced, reduction=model, lifted=fused.lift_l2(reduced),
                           **tree, **store)


@dataclasses.dataclass(frozen=True)
class FlatPostings:
    """Brute force: the normalized rows are the match operand and are kept
    whatever the rerank store, unless a ``quantizer`` packs them into int8 /
    int4 postings; then they are kept only if the rerank store keeps them."""

    quantizer: Optional[PostingsQuantizer] = None

    def __call__(self, rep: torch.Tensor, v: torch.Tensor, store: dict,
                 n_total: int) -> FlatIndex:
        if self.quantizer is None:
            return FlatIndex(vectors=v, vq=store["vq"])
        return FlatIndex(vectors=store["vectors"], vq=store["vq"], pq=self.quantizer(v))


@dataclasses.dataclass(frozen=True)
class GraphPostings:
    """Proximity graph: exact-kNN pools (K1 f32) -> Vamana robust prune ->
    reverse-edge fill -> fixed-degree int32 adjacency + entry points
    (:func:`repro_torch.core.graph.build_graph`).  The unit rows are the
    match operand (K3 scores each neighbour block from them), so they are
    kept whatever the rerank store, as in :class:`FlatPostings`."""

    config: GraphConfig

    def __call__(self, rep: torch.Tensor, v: torch.Tensor, store: dict,
                 n_total: int) -> GraphIndex:
        neighbors, entry = graph.build_graph(v, self.config)
        return GraphIndex(vectors=v, neighbors=neighbors, entry=entry, vq=store["vq"])


# --------------------------------------------------------------------------
# Metadata stage
# --------------------------------------------------------------------------


def build_metadata(metadata, n_docs: int, device=None) -> Optional[DocMetadata]:
    """The build-time ``metadata=`` argument as a :class:`DocMetadata` on
    ``device``: ``None`` passes through, a ``{field: (N,) ints}`` mapping
    stacks into the (N, F) matrix, a DocMetadata is validated (and moved)."""
    if metadata is None:
        return None
    if isinstance(metadata, DocMetadata):
        md = metadata if device is None else dataclasses.replace(
            metadata, values=metadata.values.to(device))
    else:
        md = DocMetadata.from_fields(metadata, device=device)
    if md.num_docs != n_docs:
        raise ValueError(f"metadata has {md.num_docs} rows but the corpus has {n_docs}")
    return md


# --------------------------------------------------------------------------
# Rerank stores
# --------------------------------------------------------------------------


def quantize_store(v: torch.Tensor) -> QuantizedStore:
    """Symmetric per-doc int8 quantization: scale = max|v_row| / 127,
    q = round(v / scale)."""
    amax = v.to(torch.float32).abs().amax(dim=-1)
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.round(v / scale[:, None]).to(torch.int8)
    return QuantizedStore(q=q, scale=scale.to(torch.float32))


@dataclasses.dataclass(frozen=True)
class ExactRerankStore:
    """Keep the fp32 unit-normalized originals."""

    def __call__(self, v: torch.Tensor) -> dict:
        return {"vectors": v, "vq": None}


@dataclasses.dataclass(frozen=True)
class QuantizedRerankStore:
    """int8 + per-doc scale instead of the fp32 originals: ~4x fewer rerank
    gather bytes at a bounded score error."""

    def __call__(self, v: torch.Tensor) -> dict:
        return {"vectors": None, "vq": quantize_store(v)}


@dataclasses.dataclass(frozen=True)
class NoRerankStore:
    """No rerank operand (rerank=True will fail)."""

    def __call__(self, v: torch.Tensor) -> dict:
        return {"vectors": None, "vq": None}


_STORES = {"exact": ExactRerankStore(), "int8": QuantizedRerankStore(),
           "none": NoRerankStore()}


# --------------------------------------------------------------------------
# The pipeline
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BuildPipeline:
    """normalize -> transform -> postings -> rerank store."""

    config: AnyConfig
    transform: Any
    postings: Any
    store: Any = ExactRerankStore()

    def build_local(self, vectors: torch.Tensor, normalized: bool = False):
        """Build on the device ``vectors`` lies on."""
        v = vectors if normalized else bruteforce.l2_normalize(vectors)
        return self.postings(self.transform(v), v, self.store(v), v.shape[0])


def make_build_pipeline(
    config: AnyConfig,
    rerank_store: str = "exact",
    primary_postings: str = "fp32",
    postings_group: int = 32,
) -> BuildPipeline:
    """Every method is a stage configuration.  ``rerank_store``: "exact" |
    "int8" | "none"; ``primary_postings``: "fp32" (the match operand as
    built) | "int8" (per-doc scale) | "int4" (one scale per
    ``postings_group`` columns, 32 or 64)."""
    if rerank_store not in RERANK_STORES:
        raise ValueError(f"rerank_store must be one of {RERANK_STORES}, got {rerank_store!r}")
    if primary_postings not in PRIMARY_POSTINGS:
        raise ValueError(
            f"primary_postings must be one of {PRIMARY_POSTINGS}, got {primary_postings!r}")
    store = _STORES[rerank_store]
    quantizer = None
    if primary_postings != "fp32":
        if isinstance(config, (LexicalLshConfig, KdTreeConfig, GraphConfig)):
            raise ValueError(_QUANT_POSTINGS_MSG)
        if postings_group not in POSTINGS_GROUPS:
            raise ValueError(
                f"postings_group must be one of {POSTINGS_GROUPS}, got {postings_group}")
        quantizer = PostingsQuantizer(bits=8 if primary_postings == "int8" else 4,
                                      group=postings_group)
    if isinstance(config, FakeWordsConfig):
        return BuildPipeline(config, TfTransform(config), FakeWordsPostings(config, quantizer),
                             store)
    if isinstance(config, LexicalLshConfig):
        return BuildPipeline(config, MinHashTransform(config), LshPostings(), store)
    if isinstance(config, KdTreeConfig):
        return BuildPipeline(config, ReductionTransform(config), KdTreePostings(config), store)
    if isinstance(config, BruteForceConfig):
        return BuildPipeline(config, IdentityTransform(), FlatPostings(quantizer), store)
    if isinstance(config, GraphConfig):
        return BuildPipeline(config, IdentityTransform(), GraphPostings(config), store)
    raise TypeError(f"unknown config {type(config)}")
