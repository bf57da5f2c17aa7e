"""AnnIndex facade (port of ``repro/core/index.py``):

    idx = AnnIndex.build(vectors, FakeWordsConfig(quantization=50))  # on "cuda"
    scores, ids = idx.search(queries, k=10, depth=100, rerank=True)

``metadata=`` at build time stores per-document fields (:class:`repro_torch.
core.types.DocMetadata`); keep bitmaps built from them (``idx.metadata.
eq_mask("cat", 7)``, ...) go to ``search(filt=)``, which masks the match
stage's kernels.

``AnnIndex.build(x, GraphConfig())`` builds the proximity graph ("hnsw",
:mod:`repro_torch.core.graph`), searched by a batched beam traversal.

``blockmax_keep`` (with ``blockmax_block_size``) turns on two-stage blockmax
pruning for fake-words and LSH indexes: only the ``blockmax_keep`` blocks
with the best upper bounds are scored (:mod:`repro_torch.core.blockmax`).
``primary_postings`` / ``rerank_store`` / ``memory_budget_bytes`` choose the
quantized read path (int8 / int4 postings, the int8 rerank store).

``AnnIndex.build(x, cfg, mesh=make_mesh((4,), ("data",)))`` builds the index
split over the mesh's shards (:mod:`repro_torch.core.distributed`): its
``index`` is then a :class:`repro_torch.core.distributed.ShardedIndex`, and
``search`` fans each query out to the shards and merges their lists.

Persistence: :meth:`AnnIndex.save` / :meth:`AnnIndex.load` write and read
the reference's single-index format (``FORMAT_VERSION`` 1: ``config.json``
with the method config and serving knobs, ``index.npz`` with every array
under its dotted name, bf16 as a uint16 view), so an index saved by either
package loads in the other; the metadata rides along (its field names in
``config.json``, its values in the npz as ``metadata.values``).
:func:`index_from_numpy` is the one reader: it takes the arrays and dtypes
of such a save.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import bruteforce, builder, distributed
from repro_torch.core import memory_budget as mb
from repro_torch.core import pca
from repro_torch.core import pipeline as pl
from repro_torch.core.blockmax import BlockMaxIndex, build_blockmax
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
    SearchParams,
    next_epoch,
)

# The single-index persistence format, the reference's (``repro/core/
# index.py``).  Segmented commit points (``segments_N.json``, format 2) are
# :mod:`repro_torch.core.segments`'s.
FORMAT_VERSION = 1

AnyConfig = Union[FakeWordsConfig, LexicalLshConfig, KdTreeConfig, BruteForceConfig, GraphConfig]
AnyIndex = Union[FakeWordsIndex, LshIndex, KdTreeIndex, FlatIndex, GraphIndex]

_METHOD_BY_INDEX = {FakeWordsIndex: "fake-words", LshIndex: "lexical-lsh",
                    KdTreeIndex: "kd-tree", FlatIndex: "bruteforce", GraphIndex: "hnsw"}
_CONFIG_BY_METHOD = {"fake-words": FakeWordsConfig, "lexical-lsh": LexicalLshConfig,
                     "kd-tree": KdTreeConfig, "bruteforce": BruteForceConfig,
                     "hnsw": GraphConfig}


def _check_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA device is available")
    return dev


@dataclasses.dataclass
class AnnIndex:
    """One retrieval architecture for the ported encodings: owns the method
    config, the index container and its staged search pipeline.
    ``blockmax_keep`` / ``blockmax_block_size`` switch on blockmax pruning
    (fake-words and LSH indexes); ``bm`` is built from the index when not
    given.  ``quantized_rerank`` reranks from the int8 store (``index.vq``)
    instead of the fp32 originals; None = auto: quantized iff the index
    carries the int8 store and no originals.  ``metadata`` holds per-doc
    fields, the source of the keep bitmaps that ``search(filt=)`` takes.

    ``epoch`` is the process-unique snapshot identity
    (:func:`repro_torch.core.types.next_epoch`), set at construction when
    not given: the serving layer folds it into its result-cache key, so
    swapping a service's index can never serve another index's cached
    results.  Not persisted: a loaded copy is a distinct snapshot.

    ``index`` may be a :class:`repro_torch.core.distributed.ShardedIndex`
    (``build(mesh=)``): the encoders read its replicated leaves from shard
    0, ``search`` runs :func:`repro_torch.core.distributed.
    make_sharded_search`, ``bm`` holds the shards' own block bounds, and
    ``save`` writes the gathered monolithic index."""

    config: AnyConfig
    index: AnyIndex
    blockmax_keep: Optional[int] = None
    blockmax_block_size: int = 256
    bm: Optional[BlockMaxIndex] = None
    quantized_rerank: Optional[bool] = None
    metadata: Optional[DocMetadata] = None
    epoch: Optional[int] = None

    def __post_init__(self):
        if self.epoch is None:
            self.epoch = next_epoch()
        self.pipeline: pl.SearchPipeline = pl.build_pipeline(self.config)
        local = distributed.first_shard(self.index)
        if self.quantized_rerank is None:
            reranker = pl.default_reranker(local)
        elif self.quantized_rerank:
            if local.vq is None:
                raise ValueError("quantized_rerank=True but the index has no int8 store "
                                 "(build with rerank_store='int8')")
            reranker = pl.QuantizedCosineReranker()
        else:
            reranker = pl.ExactCosineReranker()
        self.quantized_rerank = isinstance(reranker, pl.QuantizedCosineReranker)
        self.pipeline = dataclasses.replace(self.pipeline, reranker=reranker)
        if self.blockmax_keep is None:
            return
        if self.bm is None:
            if not isinstance(local, (FakeWordsIndex, LshIndex)):
                raise ValueError(f"blockmax pruning is not supported for {self.method}")
            if isinstance(self.index, distributed.ShardedIndex):
                self.bm = distributed.build_blockmax_sharded(
                    self.index.mesh, self.index, self.index.axes, self.blockmax_block_size)
            else:
                self.bm = build_blockmax(self.index, self.blockmax_block_size)
        if not isinstance(self.index, distributed.ShardedIndex):
            self.pipeline = dataclasses.replace(
                self.pipeline, matcher=pl.BlockMaxMatcher(self.blockmax_keep, self.bm))

    @classmethod
    def build(
        cls,
        vectors,
        config: AnyConfig,
        keep_vectors: bool = True,
        blockmax_keep: Optional[int] = None,
        blockmax_block_size: int = 256,
        rerank_store: Optional[str] = None,
        primary_postings: Optional[str] = None,
        postings_group: int = 32,
        memory_budget_bytes: Optional[int] = None,
        metadata=None,
        normalized: bool = False,
        device="cuda",
        mesh: Optional[distributed.Mesh] = None,
        shard_axes=("data",),
    ) -> "AnnIndex":
        """Build through :class:`repro_torch.core.builder.BuildPipeline` on
        ``device``.  ``vectors``: (N, dim) numpy array or tensor (moved to
        ``device``).  Raises when ``device`` is a CUDA device and none is
        available.

        ``rerank_store``: "exact" (fp32 originals), "int8" (quantized store
        + per-doc scale, reranked from it) or "none"; unset, it is "exact"
        if ``keep_vectors`` else "none".  ``primary_postings``: "fp32"
        (default) | "int8" | "int4", the packed match-stage store,
        dequantized in the score stage; ``postings_group`` is the int4
        scale group (32 or 64).  ``memory_budget_bytes`` picks postings x
        rerank store x blockmax keep-fraction from the recall-ordered
        frontier (:mod:`repro_torch.core.memory_budget`); knobs given with
        it are pinned, and it fills only the unset ones.  ``metadata``: per-doc
        fields for filtered search, a ``{field: (N,) ints}`` mapping or a
        :class:`DocMetadata`, held on ``device``.  ``normalized=True`` marks
        the rows as unit-normalized already: a segment merge rebuilds from
        stored unit rows, and normalizing them again could move their last
        bit and break the segmented index's parity with a monolithic
        build.

        ``mesh`` (:func:`repro_torch.core.distributed.make_mesh`) builds row
        by row over the mesh's ``shard_axes`` instead: each shard's rows go
        once to its own device (``device`` is then the metadata's only) and
        the index is a :class:`repro_torch.core.distributed.ShardedIndex`,
        equal leaf for leaf to the monolithic build.  The shard count must
        divide N."""
        if mesh is None:
            dev = _check_device(device)
            v = torch.as_tensor(vectors, device=dev)
        else:  # build_sharded moves each shard's rows to its own device
            dev = distributed.shard_devices(mesh, shard_axes)[0]
            v = torch.as_tensor(vectors)
        if memory_budget_bytes is not None:
            n, dim = v.shape
            plan = mb.plan_for_budget(
                config, n, dim, memory_budget_bytes, primary_postings=primary_postings,
                rerank_store=rerank_store if rerank_store is not None
                else (None if keep_vectors else "none"),
                group=postings_group)
            primary_postings, rerank_store = plan["primary_postings"], plan["rerank_store"]
            if (blockmax_keep is None and plan["keep_frac"] < 1.0
                    and isinstance(config, (FakeWordsConfig, LexicalLshConfig))):
                blockmax_keep = max(1, int(plan["keep_frac"] * -(-n // blockmax_block_size)))
        if rerank_store is None:
            rerank_store = "exact" if keep_vectors else "none"
        bp = builder.make_build_pipeline(config, rerank_store, primary_postings or "fp32",
                                         postings_group)
        return cls(config=config, index=bp.build(v, mesh, shard_axes, normalized=normalized),
                   blockmax_keep=blockmax_keep,
                   blockmax_block_size=blockmax_block_size,
                   quantized_rerank=rerank_store == "int8",
                   metadata=builder.build_metadata(metadata, v.shape[0], dev))

    @property
    def method(self) -> str:
        return _METHOD_BY_INDEX[type(distributed.first_shard(self.index))]

    @property
    def device(self) -> torch.device:
        return self.index.device

    @property
    def num_docs(self) -> int:
        return self.index.num_docs

    def nbytes(self) -> int:
        return self.index.nbytes()

    def encode_queries(self, queries) -> torch.Tensor:
        """The method's query representation (tf row / signature / reduced
        point / unit query), on the index's device; a sharded index's
        encoder reads shard 0's replicated leaves."""
        q = bruteforce.l2_normalize(torch.as_tensor(queries, device=self.device))
        return self.pipeline.encoder(distributed.first_shard(self.index), q)

    def matcher_for(self, bm: Optional[BlockMaxIndex] = None, keep: Optional[int] = None):
        """The effective match stage: blockmax pruning when a block-bound
        structure and a keep count are given (at most ``bm.num_blocks``
        blocks), else the method's own matcher.  The serving layer calls it
        with its own overrides."""
        if bm is not None and keep is not None:
            return pl.BlockMaxMatcher(min(keep, bm.num_blocks), bm)
        return pl.make_matcher(self.config)

    def search(
        self,
        queries,
        k: int = 10,
        depth: int = 100,
        rerank: bool = False,
        params: Optional[SearchParams] = None,
        filt=None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """encode -> match [-> prune] -> optional rerank.  ``params`` takes
        precedence over ``k`` / ``depth`` / ``rerank``.  ``queries`` (B, dim)
        numpy or tensor; it is moved to the index's device.  ``filt`` ((N,)
        or (B, N); bool, uint8 or int32, tensor or numpy; nonzero = keep)
        restricts the match stage to the bitmap's docs in the same kernel
        pass; typically built from ``self.metadata``.  A mask of another
        shape raises ValueError."""
        p = params if params is not None else SearchParams(k=k, depth=depth, rerank=rerank)
        q = torch.as_tensor(queries, device=self.device)
        if isinstance(self.index, distributed.ShardedIndex):
            return self._sharded_search(q, p, filt)
        return self.pipeline.search(self.index, q, p, filt=filt)

    def rerank_store(self) -> str:
        """The store the rerank reads: "int8", "exact" or "none"."""
        if self.quantized_rerank:
            return "int8"
        return "exact" if distributed.first_shard(self.index).vectors is not None else "none"

    def _sharded_search(self, q: torch.Tensor, p: SearchParams, filt):
        """Fan-out and merge over the shards (a shared (N,) ``filt`` only)."""
        pq = getattr(distributed.first_shard(self.index), "pq", None)
        search = distributed.make_sharded_search(
            self.index.mesh, self.config, self.index.axes, k=p.k, depth=p.depth,
            rerank=p.rerank, blockmax_keep=self.blockmax_keep, rerank_store=self.rerank_store(),
            postings_bits=0 if pq is None else pq.bits, filtered=filt is not None)
        qn = bruteforce.l2_normalize(q)
        args = (self.index,) + ((self.bm,) if self.blockmax_keep is not None else ()) + (
            self.pipeline.encoder(distributed.first_shard(self.index), qn), qn)
        return search(*args, *(() if filt is None else (filt,)))

    # ----------------------------------------------------------------------
    # Persistence: npz (every array) + JSON (config + serving knobs)
    # ----------------------------------------------------------------------

    def save(self, path: str) -> None:
        """Write the index to ``path/`` (``config.json`` + ``index.npz``) in
        the reference's format 1.  The blockmax bounds are not written: load
        rebuilds them from the arrays.  ``use_kernel``, a knob the port does
        not have, is written as null (the reference's default routing)."""
        os.makedirs(path, exist_ok=True)
        packed, dtypes = {}, {}
        index = self.index
        if isinstance(index, distributed.ShardedIndex):
            index = distributed.gather(index)
        for name, t in _named_arrays(index).items():
            packed[name], dtypes[name] = _to_numpy(t)
        meta = {
            "format_version": FORMAT_VERSION,
            "method": self.method,
            "config": _config_to_json(self.config),
            "dtypes": dtypes,
            "use_kernel": None,
            "blockmax_keep": self.blockmax_keep,
            "blockmax_block_size": self.blockmax_block_size,
            "quantized_rerank": self.quantized_rerank,
        }
        pq = getattr(index, "pq", None)
        if pq is not None:  # the packed store's static metadata
            meta["pq"] = {"bits": pq.bits, "group": pq.group, "cols": pq.cols}
        if self.metadata is not None:  # field names in the JSON, values in the npz
            meta["metadata"] = {"field_names": list(self.metadata.field_names)}
            packed["metadata.values"] = self.metadata.values.cpu().numpy()
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(meta, f, indent=2)
        np.savez_compressed(os.path.join(path, "index.npz"), **packed)

    @classmethod
    def load(cls, path: str, device="cuda", **overrides) -> "AnnIndex":
        """Read a save of either package onto ``device`` (raises when it is
        a CUDA device and none is available).  ``overrides`` replace the
        saved serving knobs (``blockmax_keep``, ``blockmax_block_size``,
        ``quantized_rerank``).  A format other than 1 raises ValueError, and
        so does a segmented commit point, which
        :meth:`repro_torch.core.segments.SegmentedAnnIndex.load` opens."""
        meta_path = os.path.join(path, "config.json")
        if not os.path.exists(meta_path):
            from repro_torch.core import segments

            if segments.find_commits(path):
                raise ValueError(
                    f"{path!r} holds a segmented commit point (segments_N.json), not a "
                    "single-index save; open it with SegmentedAnnIndex.load / "
                    "IndexWriter.open (repro_torch.core.segments)")
        with open(meta_path) as f:
            meta = json.load(f)
        version = meta.get("format_version", 1)
        if version != FORMAT_VERSION:
            raise ValueError(
                f"index at {path!r} has format_version {version}, but this build reads "
                f"format_version {FORMAT_VERSION}"
                + (" — it was written by a newer version of the code; upgrade to load it"
                   if version > FORMAT_VERSION else ""))
        with np.load(os.path.join(path, "index.npz")) as z:
            arrays = {name: z[name] for name in z.files}
        knobs = {"blockmax_keep": meta.get("blockmax_keep"),
                 "blockmax_block_size": meta.get("blockmax_block_size", 256),
                 "quantized_rerank": meta.get("quantized_rerank")}
        knobs.update(overrides)
        return index_from_numpy(meta["method"], meta["config"], arrays, meta["dtypes"],
                                device=device, pq=meta.get("pq"),
                                metadata=meta.get("metadata"), **knobs)


# --------------------------------------------------------------------------
# (De)serialization helpers
# --------------------------------------------------------------------------


def _named_arrays(obj, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Dotted name -> tensor over a (nested) index dataclass; None fields and
    static ints (a packed store's bits / group / cols) are left out."""
    out: Dict[str, torch.Tensor] = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            out[prefix + f.name] = v
        elif dataclasses.is_dataclass(v):
            out.update(_named_arrays(v, f"{prefix}{f.name}."))
    return out


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """npz-safe host copy and its dtype name; bfloat16 (no numpy dtype) goes
    as a uint16 view."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, a.dtype.name


def _config_to_json(config: AnyConfig) -> dict:
    d = dataclasses.asdict(config)
    if isinstance(config, FakeWordsConfig):  # the numpy name, as the reference writes it
        d["store_dtype"] = str(config.store_dtype).removeprefix("torch.")
    return d


def _tensor(a: np.ndarray, dtype_name: str, device: torch.device) -> torch.Tensor:
    """npz array -> tensor; bfloat16 arrives as a uint16 view."""
    if dtype_name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16).to(device)
    if a.dtype.name != dtype_name:
        raise ValueError(f"array dtype {a.dtype.name} does not match the recorded {dtype_name}")
    return torch.from_numpy(np.array(a)).to(device)


_STORE_ARRAYS = ("vq.q", "vq.scale", "pq.q", "pq.scale")
_REDUCTION_ARRAYS = {
    "pca": ("reduction.mean", "reduction.components"),
    "ppa-pca-ppa": ("reduction.ppa1.mean", "reduction.ppa1.top", "reduction.pca.mean",
                    "reduction.pca.components", "reduction.ppa2.mean", "reduction.ppa2.top"),
}
_ARRAYS_BY_METHOD = {
    "fake-words": ("tf", "idf", "norm", "df", "scored", "vectors") + _STORE_ARRAYS,
    "lexical-lsh": ("sig", "vectors", "vq.q", "vq.scale"),
    "kd-tree": ("reduced", "split_dim", "split_val", "perm", "lifted", "vectors", "vq.q",
                "vq.scale") + sum(_REDUCTION_ARRAYS.values(), ()),
    "bruteforce": ("vectors",) + _STORE_ARRAYS,
    "hnsw": ("vectors", "neighbors", "entry", "vq.q", "vq.scale"),
}


def _reduction(kind: str, t: Dict[str, torch.Tensor]):
    """The fitted reduction model of a k-d tree index from its arrays."""
    if kind == "pca":
        return pca.PcaModel(mean=t["reduction.mean"], components=t["reduction.components"])
    return pca.PpaPcaPpaModel(
        ppa1=pca.PpaModel(mean=t["reduction.ppa1.mean"], top=t["reduction.ppa1.top"]),
        pca=pca.PcaModel(mean=t["reduction.pca.mean"],
                         components=t["reduction.pca.components"]),
        ppa2=pca.PpaModel(mean=t["reduction.ppa2.mean"], top=t["reduction.ppa2.top"]))


def index_from_numpy(
    method: str,
    config: dict,
    arrays: Dict[str, np.ndarray],
    dtypes: Dict[str, str],
    device="cuda",
    blockmax_keep: Optional[int] = None,
    blockmax_block_size: int = 256,
    pq: Optional[dict] = None,
    quantized_rerank: Optional[bool] = None,
    metadata: Optional[dict] = None,
) -> AnnIndex:
    """The port's index from the reference's persisted form: ``method`` and
    ``config`` as in ``config.json``, ``arrays`` the ``index.npz`` members
    (dotted names), ``dtypes`` their recorded dtype names, and the knobs as
    ``config.json`` records them: ``blockmax_keep`` / ``blockmax_block_size``
    (the block bounds are rebuilt from the arrays, as the reference's
    ``load`` does), ``pq`` (the packed store's {"bits", "group", "cols"}),
    ``quantized_rerank`` and ``metadata`` (``{"field_names": [...]}``; the
    values come as the int32 array ``metadata.values``, which has no
    ``dtypes`` entry, as the reference writes it; the names without the
    values raise KeyError, as in the reference's ``load``).  Covers
    "fake-words", "lexical-lsh", "kd-tree" (``reduced``, the reduction
    model ``reduction.*``, flat PCA or nested PPA / PCA / PPA, the tree
    arrays ``split_dim`` / ``split_val`` / ``perm`` and ``lifted``) and
    "bruteforce", with their int8 / int4 packed postings (``pq.*``) and int8
    rerank store (``vq.*``), and "hnsw" (``vectors``, ``neighbors``,
    ``entry``).  Another method, or arrays that belong to no store of the
    method, raise ValueError."""
    dev = _check_device(device)
    if method not in _ARRAYS_BY_METHOD:
        raise ValueError(f"unknown method {method!r}")
    arrays = dict(arrays)
    values = arrays.pop("metadata.values", None)
    stray = sorted(set(arrays) - set(_ARRAYS_BY_METHOD[method]))
    if stray:
        raise ValueError(f"arrays {stray} belong to no store of method {method!r}")
    md = None
    if metadata is not None:
        if values is None:
            raise KeyError("metadata.values")
        md = DocMetadata(values=_tensor(values, "int32", dev),
                         field_names=tuple(metadata["field_names"]))
    elif values is not None:
        raise ValueError("metadata.values without the metadata field names")
    t = {name: _tensor(a, dtypes[name], dev) for name, a in arrays.items()}
    vq = QuantizedStore(q=t["vq.q"], scale=t["vq.scale"]) if "vq.q" in t else None
    packed = None
    if "pq.q" in t:
        if pq is None:
            raise ValueError("packed postings arrays (pq.*) without their pq metadata")
        packed = QuantizedPostings(q=t["pq.q"], scale=t["pq.scale"], bits=int(pq["bits"]),
                                   group=int(pq["group"]), cols=int(pq["cols"]))
    cfg = _CONFIG_BY_METHOD[method](**config)
    if method == "fake-words":
        index = FakeWordsIndex(
            tf=t.get("tf"), idf=t["idf"], norm=t["norm"], df=t["df"],
            scored=t.get("scored"), vectors=t.get("vectors"), vq=vq, pq=packed)
    elif method == "lexical-lsh":
        index = LshIndex(sig=t["sig"], vectors=t.get("vectors"), vq=vq)
    elif method == "kd-tree":
        index = KdTreeIndex(
            reduced=t["reduced"], reduction=_reduction(cfg.reduction, t),
            split_dim=t.get("split_dim"), split_val=t.get("split_val"), perm=t.get("perm"),
            lifted=t.get("lifted"), vectors=t.get("vectors"), vq=vq)
    elif method == "hnsw":
        index = GraphIndex(vectors=t["vectors"], neighbors=t["neighbors"], entry=t["entry"],
                           vq=vq)
    else:
        index = FlatIndex(vectors=t.get("vectors"), vq=vq, pq=packed)
    return AnnIndex(config=cfg, index=index, blockmax_keep=blockmax_keep,
                    blockmax_block_size=blockmax_block_size, quantized_rerank=quantized_rerank,
                    metadata=md)
