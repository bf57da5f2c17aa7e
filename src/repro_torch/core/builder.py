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

Every transform and postings stage takes ``axes`` / ``n_total``: with
``axes`` set, the rows come as a list of the shards' blocks (one a shard,
in flat order, each on its shard's device; :mod:`repro_torch.core.
distributed`), the row-local work runs shard by shard, and the global
statistics (fake-words df, the reduction's moments) are ``psum``-ed, so
:meth:`BuildPipeline.build_sharded` returns a
:class:`repro_torch.core.distributed.ShardedIndex` whose leaves equal
:meth:`BuildPipeline.build_local`'s bit for bit (the reduction within f32
tolerance).  No stage holds the whole corpus on a shard, except the
graph's prune, which reads the gathered rows as the reference's does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Union

import torch

from repro_torch.core import bruteforce, distributed, fakewords, graph, kdtree, lexical_lsh, pca
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

_TREE_BUILD_MSG = (
    "kd-tree 'tree' backend builds host-side (numpy) and cannot shard on documents; use "
    "backend='scan' (identical results, docs/DESIGN.md §3)"
)


def _per_shard(fn, *args, axes=None):
    """``fn(*args)``, or with ``axes`` on each shard's parts (every arg a
    list, one entry a shard) through :func:`distributed.shard_map`."""
    if axes is None:
        return fn(*args)
    return distributed.shard_map(fn, [a.device for a in args[0]], *args)


# --------------------------------------------------------------------------
# Vector transforms
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TfTransform:
    """Fake words: sign-split quantized term-frequency rows."""

    config: FakeWordsConfig

    def __call__(self, v, axes=None, n_total=None):
        return _per_shard(lambda x: fakewords.encode(x, self.config.quantization,
                                                     self.config.store_dtype), v, axes=axes)


@dataclasses.dataclass(frozen=True)
class MinHashTransform:
    """Lexical LSH: MinHash signatures (row-local)."""

    config: LexicalLshConfig

    def __call__(self, v, axes=None, n_total=None):
        return _per_shard(lambda x: lexical_lsh.encode(x, self.config), v, axes=axes)


@dataclasses.dataclass(frozen=True)
class ReductionTransform:
    """k-d tree: fit PCA or PPA -> PCA -> PPA and project the rows.  Returns
    (reduced f32 rows, fitted model): the model lands in the index, and the
    queries project through it at search time.  With ``axes`` the fit runs
    from the shards' summed moments (one model, on shard 0's device) and
    the reduced rows are a list."""

    config: KdTreeConfig

    def __call__(self, v, axes=None, n_total=None):
        model, reduced = pca.fit_reduction(v, self.config.dims, self.config.reduction,
                                           self.config.ppa_remove, axes=axes, n_total=n_total)
        if axes is None:
            return reduced.to(torch.float32), model
        return [r.to(torch.float32) for r in reduced], model


@dataclasses.dataclass(frozen=True)
class IdentityTransform:
    """Brute force and the graph: the unit-normalized rows themselves."""

    def __call__(self, v, axes=None, n_total=None):
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


def doc_norm(tf: torch.Tensor) -> torch.Tensor:
    """Lucene length norm 1 / sqrt(doc_len) per row (doc_len floored at 1)."""
    return torch.rsqrt(torch.clamp_min(tf.to(torch.float32).sum(-1), 1.0))


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

    def __call__(self, tf, v, store, n_total: int, axes=None):
        if axes is None:
            df = live_df(tf)
            return self.assemble(tf, store, df, idf_from_df(df, n_total))
        # df is the one global statistic: an integer sum over the shards,
        # so idf and scored match a monolithic build bit for bit.  Shards
        # on one device share one df and one idf.
        df = distributed.psum(_per_shard(live_df, tf, axes=axes))
        devices = [t.device for t in tf]
        return _per_shard(self.assemble, tf, store, distributed.replicate(df, devices),
                          distributed.replicate(idf_from_df(df, n_total), devices), axes=axes)

    def assemble(self, tf: torch.Tensor, store: dict, df: torch.Tensor,
                 idf: torch.Tensor) -> FakeWordsIndex:
        """The index over ``tf``'s rows under the collection's df / idf."""
        norm = doc_norm(tf)
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

    def __call__(self, sig, v, store, n_total: int, axes=None):
        return _per_shard(lambda s, st: LshIndex(sig=s, **st), sig, store, axes=axes)


@dataclasses.dataclass(frozen=True)
class KdTreePostings:
    """Reduced points + the scan's lifted operand; with backend "tree" also
    the tree arrays, built on the host (numpy) and moved to the points'
    device."""

    config: KdTreeConfig

    def __call__(self, rep, v, store, n_total: int, axes=None):
        reduced, model = rep
        if axes is not None:
            if self.config.backend == "tree":
                raise ValueError(_TREE_BUILD_MSG)
            models = distributed.replicate(model, [r.device for r in reduced])
            return _per_shard(lambda r, m, st: KdTreeIndex(
                reduced=r, reduction=m, lifted=fused.lift_l2(r), **st),
                reduced, models, store, axes=axes)
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

    def __call__(self, rep, v, store, n_total: int, axes=None):
        return _per_shard(self.assemble, v, store, axes=axes)

    def assemble(self, v: torch.Tensor, store: dict) -> FlatIndex:
        if self.quantizer is None:
            return FlatIndex(vectors=v, vq=store["vq"])
        return FlatIndex(vectors=store["vectors"], vq=store["vq"], pq=self.quantizer(v))


@dataclasses.dataclass(frozen=True)
class GraphPostings:
    """Proximity graph: exact-kNN pools (K1 f32) -> Vamana robust prune ->
    reverse-edge fill -> fixed-degree int32 adjacency + entry points
    (:func:`repro_torch.core.graph.build_graph`).  The unit rows are the
    match operand (K3 scores each neighbour block from them), so they are
    kept whatever the rerank store, as in :class:`FlatPostings`.  With
    ``axes`` the pools circulate the shards' row blocks around the ring
    (:func:`repro_torch.core.graph.build_graph_sharded`)."""

    config: GraphConfig

    def __call__(self, rep, v, store, n_total: int, axes=None):
        if axes is None:
            neighbors, entry = graph.build_graph(v, self.config)
            return GraphIndex(vectors=v, neighbors=neighbors, entry=entry, vq=store["vq"])
        neighbors, entries = graph.build_graph_sharded(v, self.config, axes=axes,
                                                       n_total=n_total)
        return _per_shard(lambda x, nb, e, st: GraphIndex(vectors=x, neighbors=nb, entry=e,
                                                          vq=st["vq"]),
                          v, neighbors, entries, store, axes=axes)


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

    def _assemble(self, v, n_total: int, axes=None):
        store = _per_shard(self.store, v, axes=axes)
        return self.postings(self.transform(v, axes=axes, n_total=n_total), v, store, n_total,
                             axes=axes)

    def build_local(self, vectors: torch.Tensor, normalized: bool = False):
        """Build on the device ``vectors`` lies on."""
        v = vectors if normalized else bruteforce.l2_normalize(vectors)
        return self._assemble(v, v.shape[0])

    def build_sharded(self, mesh, vectors, axes: Sequence[str] = ("data",),
                      normalized: bool = False) -> "distributed.ShardedIndex":
        """Row-parallel build over ``mesh``: ``vectors`` (numpy or a tensor
        on any device) is split by rows over ``axes``, each block copied
        once to its shard's device (a view where it lies there already);
        every doc leaf is computed from its shard's rows, and df and the
        reduction's moments travel through ``psum``.  The shard count must
        divide N."""
        axes = tuple(axes)
        if isinstance(self.config, KdTreeConfig) and self.config.backend == "tree":
            raise ValueError(_TREE_BUILD_MSG)
        n = vectors.shape[0]
        n_shards = distributed.flat_axis_size(mesh, axes)
        if n % n_shards:
            raise ValueError(f"corpus size {n} not divisible by {n_shards} shards")
        blocks = distributed.shard_rows(mesh, vectors, axes)
        v = blocks if normalized else _per_shard(bruteforce.l2_normalize, blocks, axes=axes)
        del blocks
        return distributed.ShardedIndex(tuple(self._assemble(v, n, axes=axes)), mesh, axes)

    def build(self, vectors, mesh=None, axes: Sequence[str] = ("data",),
              normalized: bool = False):
        """Local when ``mesh`` is None, else sharded."""
        if mesh is None:
            return self.build_local(vectors, normalized=normalized)
        return self.build_sharded(mesh, vectors, axes, normalized=normalized)


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
