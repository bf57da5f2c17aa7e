"""Sharded ANN build and search over a single-process device mesh (port of
``repro/core/distributed.py``).

Lucene and Elasticsearch scale by sharding the index across nodes: every
query fans out, each shard returns its local top-d, and a coordinator
merges.  Here, as in the reference:

  1. the corpus (tf matrix / signatures / reduced points, the original
     vectors, the stores) is split on the document dimension over the
     flattened mesh axes;
  2. each shard scores its own rows and takes a local top-d through the
     SAME matcher stage objects as single-device search
     (:func:`repro_torch.core.pipeline.make_matcher`), so every encoding —
     fake words, lexical LSH, the k-d scan, brute force — gets the fan-out
     and merge from one code path, on the kernels K1–K5 as they are;
  3. each shard reranks its own candidates from its own store (no rows
     cross shards);
  4. the (score, global id) lists are gathered and one top-k is taken.

**The mesh is one process.**  The reference's ``shard_map`` is
single-controller: one process holds the mesh, and ``build_sharded`` /
``make_sharded_search`` return ordinary values and callables.  So here a
:class:`Mesh` is a grid of ``torch.device``s with axis names (a device may
repeat), and a sharded value is a list with one tensor per shard, in flat
order, each on its shard's device.  ``shard_map`` becomes
:func:`shard_map`, a loop that calls the per-shard function on each
shard's device; :func:`psum`, :func:`all_gather` and :func:`ppermute` are
plain functions over such lists, and a move between two shards on one card
is no copy.  :func:`make_mesh` places the shards round-robin over the
visible cards: on one H100, 4 shards are 4 x ``cuda:0`` and run one after
another on its stream; on a host with more cards, one shard a card.  A
process group would need a rank a shard, and NCCL puts no two ranks on one
card.  Multi-host meshes are not ported.

**A sharded index** (:class:`ShardedIndex`) holds one plain index of the
method's own type a shard, over its own rows, on its device; the
replicated leaves (idf, df, the reduction model, the graph's entry points)
are identical on every shard, and shards that share a device share one
copy.  :func:`index_pspec` is the one table of which leaves of each type
are doc-sharded and which are replicated; :func:`shard_index` splits a
monolithic index by it and :func:`gather` joins a sharded one back.  The
reference's ``config_pspec`` only feeds XLA's static sharding specs (and
the dry-run cells' shape evaluation); nothing here needs a spec before an
index exists, so it has no counterpart.

The merge's tie order is the reference's: one stable top-k over the
gathered (B, S * d) scores (``lax.top_k`` order, shard-major), so a
match-only sharded search returns the monolithic search's ids.  The
fake-words df-prune keep mask is the reference's: each shard compares the
collection's (psum'd) df against ``df_max_ratio`` times its OWN rows
(``index.num_docs`` of the shard), so below ratio 1.0 a sharded search
prunes more terms than the monolithic one, as the reference's does.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import pipeline as pl
from repro_torch.core.blockmax import BlockMaxIndex, build_blockmax
from repro_torch.core.types import (
    BruteForceConfig,
    FakeWordsConfig,
    FakeWordsIndex,
    FlatIndex,
    GraphConfig,
    GraphIndex,
    KdTreeConfig,
    KdTreeIndex,
    LshIndex,
)
from repro_torch.kernels.common import stable_topk

_TREE_BACKEND_MSG = (
    "kd-tree 'tree' backend cannot shard on documents; use backend='scan' "
    "(identical results, docs/DESIGN.md §3)"
)

_GRAPH_SEARCH_MSG = (
    "graph search cannot run shard-local: adjacency edges cross shard boundaries, so "
    "per-shard traversal + merge is not the same algorithm.  Serve graphs segmented "
    "(SegmentedAnnIndex) or single-device; the sharded BUILD (build_sharded) is supported "
    "and returns doc-sharded leaves you can gather onto one device."
)


# --------------------------------------------------------------------------
# The mesh
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An N-d grid of devices with axis names, the counterpart of
    ``jax.sharding.Mesh``.  ``devices`` is the grid in row-major order; a
    device may appear more than once (several shards on one card)."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"{len(self.axis_names)} axis names for a "
                             f"{len(self.axis_sizes)}-d mesh")
        size = 1
        for s in self.axis_sizes:
            size *= s
        if size != len(self.devices):
            raise ValueError(f"a mesh of shape {self.axis_sizes} needs {size} devices, "
                             f"got {len(self.devices)}")

    @property
    def shape(self) -> "collections.OrderedDict[str, int]":
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return collections.OrderedDict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(shape: Sequence[int], axes: Sequence[str], device="cuda") -> Mesh:
    """A mesh of ``shape`` over ``axes``.  ``device="cuda"`` places the
    positions round-robin over the visible cards (on one card every
    position is ``cuda:0``); ``"cuda:i"`` puts every position on card i;
    ``"cpu"`` on the host.  Raises when a CUDA device is asked for and none
    is available."""
    from repro_torch.core.index import _check_device

    dev = _check_device(device)
    size = 1
    for s in shape:
        size *= int(s)
    if dev.type == "cuda" and dev.index is None:
        devices = [torch.device("cuda", i % torch.cuda.device_count()) for i in range(size)]
    else:
        devices = [dev] * size
    return Mesh(tuple(devices), tuple(axes), tuple(int(s) for s in shape))


def flat_axis_size(mesh: Mesh, axes: Sequence[str]) -> int:
    size = 1
    for name in axes:
        size *= mesh.shape[name]
    return size


def flat_axis_index(mesh: Mesh, axes: Sequence[str], coords: Dict[str, int]) -> int:
    """Row-major linear index over several mesh axes of the mesh position
    ``coords`` (axis name -> index): on a (4, 2) mesh over ("data",
    "model"), position (i, j) is shard 2i + j."""
    idx = 0
    for name in axes:
        idx = idx * mesh.shape[name] + coords[name]
    return idx


def shard_devices(mesh: Mesh, axes: Sequence[str]) -> List[torch.device]:
    """The device of each shard over ``axes``, in flat order.  Mesh axes
    outside ``axes`` are replicas; the shards run on the first replica (at
    index 0 of each such axis)."""
    axes = tuple(axes)
    out = []
    for flat in range(flat_axis_size(mesh, axes)):
        coords = dict.fromkeys(mesh.axis_names, 0)
        for name in reversed(axes):
            flat, coords[name] = divmod(flat, mesh.shape[name])
        pos = 0
        for name in mesh.axis_names:
            pos = pos * mesh.shape[name] + coords[name]
        out.append(mesh.devices[pos])
    return out


# --------------------------------------------------------------------------
# shard_map and the collectives: lists with one value a shard, flat order
# --------------------------------------------------------------------------


def _on(device: torch.device):
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _to(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``x`` on ``device``: no copy when it lies there already."""
    return x.to(device, non_blocking=device.type == "cuda")


def move(obj, device: torch.device):
    """A tensor, or a (nested) dataclass of tensors such as a reduction
    model, on ``device``; None and static fields pass."""
    if isinstance(obj, torch.Tensor):
        return _to(obj, device)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: move(getattr(obj, f.name), device)
                                           for f in dataclasses.fields(obj)})
    return obj


def replicate(obj, devices: Sequence[torch.device]) -> list:
    """One ``obj`` a shard, each on its shard's device; shards on one
    device share one copy."""
    copies: Dict[torch.device, Any] = {}
    for d in devices:
        if d not in copies:
            copies[d] = move(obj, d)
    return [copies[d] for d in devices]


def shard_map(fn: Callable, devices: Sequence[torch.device], *args: Sequence) -> list:
    """``fn`` on each shard in flat order, under its device: shard s gets
    ``fn(*(a[s] for a in args))``.  Build and search share this loop."""
    out = []
    for s, dev in enumerate(devices):
        with _on(dev):
            out.append(fn(*(a[s] for a in args)))
    return out


def psum(xs: Sequence):
    """The sum over the shards, summed in flat order on shard 0's device
    (integers are exact; ``psum([1] * S)`` is the shard count)."""
    total = xs[0]
    for x in xs[1:]:
        total = total + (_to(x, total.device) if isinstance(x, torch.Tensor) else x)
    return total


def all_gather(xs: Sequence[torch.Tensor], axis: int = 0, tiled: bool = True) -> torch.Tensor:
    """The shards' values joined on shard 0's device: concatenated along
    ``axis`` (``tiled``), else stacked on a new ``axis``."""
    dev = xs[0].device
    parts = [_to(x, dev) for x in xs]
    return torch.cat(parts, dim=axis) if tiled else torch.stack(parts, dim=axis)


def ppermute(xs: Sequence[torch.Tensor], perm: Sequence[Tuple[int, int]]) -> list:
    """Shard ``dst`` receives shard ``src``'s value for each (src, dst)
    pair, on ``dst``'s device (shards that receive nothing get zeros).  Two
    shards on one card exchange references: no copy, and nothing aliases a
    value that a later step writes, since no step writes in place."""
    out = [torch.zeros_like(x) for x in xs] if len(perm) < len(xs) else [None] * len(xs)
    for src, dst in perm:
        out[dst] = _to(xs[src], xs[dst].device)
    return out


# --------------------------------------------------------------------------
# Sharded indexes and the placement table
# --------------------------------------------------------------------------

DOC, REPLICATED = "doc", "replicated"

#: Which leaves of each index type split on the document dimension and
#: which every shard holds whole (the reference's ``_pspec_tree``).  A
#: nested store (``vq``, ``pq``) splits every tensor it holds by rows; the
#: graph's neighbour ids stay GLOBAL; the blockmax bounds split by blocks.
_PLACEMENT: Dict[type, Dict[str, str]] = {
    FakeWordsIndex: {"tf": DOC, "idf": REPLICATED, "norm": DOC, "df": REPLICATED,
                     "scored": DOC, "vectors": DOC, "vq": DOC, "pq": DOC},
    LshIndex: {"sig": DOC, "vectors": DOC, "vq": DOC},
    KdTreeIndex: {"reduced": DOC, "reduction": REPLICATED, "lifted": DOC, "vectors": DOC,
                  "vq": DOC},
    FlatIndex: {"vectors": DOC, "vq": DOC, "pq": DOC},
    GraphIndex: {"vectors": DOC, "neighbors": DOC, "entry": REPLICATED, "vq": DOC},
    BlockMaxIndex: {"ub": DOC},
}


def index_pspec(index) -> Dict[str, str]:
    """Leaf name -> ``DOC`` or ``REPLICATED`` for every leaf present on
    ``index`` (any index type the pipeline serves, or a BlockMaxIndex).
    A k-d tree built with the "tree" backend cannot shard."""
    if isinstance(index, KdTreeIndex) and index.split_dim is not None:
        raise ValueError(_TREE_BACKEND_MSG)
    table = _PLACEMENT.get(type(index))
    if table is None:
        raise TypeError(f"unknown index {type(index)}")
    return {name: where for name, where in table.items() if getattr(index, name) is not None}


def _rows(obj, start: int, length: int):
    """Rows [start, start + length) of a tensor or of every tensor of a
    store dataclass (a view: no copy)."""
    if isinstance(obj, torch.Tensor):
        return obj.narrow(0, start, length)
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).narrow(0, start, length)
        for f in dataclasses.fields(obj) if isinstance(getattr(obj, f.name), torch.Tensor)})


def _join(parts: Sequence, device: torch.device):
    """Shards' doc leaves (tensors or store dataclasses) concatenated on
    ``device``."""
    first = parts[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([_to(p, device) for p in parts])
    return dataclasses.replace(first, **{
        f.name: torch.cat([_to(getattr(p, f.name), device) for p in parts])
        for f in dataclasses.fields(first) if isinstance(getattr(first, f.name), torch.Tensor)})


def _row_count(index) -> int:
    return index.num_blocks if isinstance(index, BlockMaxIndex) else index.num_docs


@dataclasses.dataclass(frozen=True)
class ShardedIndex:
    """An index split on the document dimension: ``shards[s]`` is a plain
    index of the method's own type over rows [s * n_local, (s + 1) *
    n_local), on its shard's device, in flat order over ``axes``.  Its
    replicated leaves are equal on every shard (one copy a device)."""

    shards: Tuple[Any, ...]
    mesh: Mesh
    axes: Tuple[str, ...]

    @property
    def n_local(self) -> int:
        return _row_count(self.shards[0])

    @property
    def num_docs(self) -> int:
        return sum(_row_count(s) for s in self.shards)

    @property
    def devices(self) -> List[torch.device]:
        return [s.device if not isinstance(s, BlockMaxIndex) else s.ub.device
                for s in self.shards]

    @property
    def device(self) -> torch.device:
        """The coordinator's device (shard 0's): merged results land here."""
        return self.devices[0]

    def nbytes(self) -> int:
        """The bytes of the equivalent monolithic index: doc-sharded leaves
        summed over the shards, replicated leaves once."""
        total = 0
        for name, where in index_pspec(self.shards[0]).items():
            parts = [getattr(s, name) for s in (self.shards if where == DOC else self.shards[:1])]
            total += sum(p.numel() * p.element_size() if isinstance(p, torch.Tensor)
                         else p.nbytes() for p in parts)
        return total


def first_shard(index):
    """Shard 0 of a sharded index (its replicated leaves are every
    shard's: the query encoders read them there), else the index."""
    return index.shards[0] if isinstance(index, ShardedIndex) else index


def shard_index(mesh: Mesh, index, axes: Sequence[str]) -> ShardedIndex:
    """Split a monolithic index (any type, or a BlockMaxIndex) over
    ``axes``: doc leaves by rows (views of ``index``'s, moved to each
    shard's device; no copy on a shard's own device), replicated leaves
    once a device.  The row count must divide by the shard count."""
    axes = tuple(axes)
    devices = shard_devices(mesh, axes)
    n = _row_count(index)
    if n % len(devices):
        raise ValueError(f"{n} rows not divisible by {len(devices)} shards")
    n_local = n // len(devices)
    spec = index_pspec(index)
    copies: Dict[Tuple[str, torch.device], Any] = {}
    shards = []
    for s, dev in enumerate(devices):
        fields = {}
        for name, where in spec.items():
            leaf = getattr(index, name)
            if where == DOC:
                fields[name] = move(_rows(leaf, s * n_local, n_local), dev)
            else:
                if (name, dev) not in copies:
                    copies[(name, dev)] = move(leaf, dev)
                fields[name] = copies[(name, dev)]
        shards.append(dataclasses.replace(index, **fields))
    return ShardedIndex(tuple(shards), mesh, axes)


def gather(sharded: ShardedIndex, device=None):
    """The monolithic index of a sharded one, on ``device`` (default the
    coordinator's): doc leaves concatenated in flat order, replicated
    leaves from shard 0 (the counterpart of ``np.asarray`` on a sharded
    array)."""
    dev = sharded.device if device is None else torch.device(device)
    first = sharded.shards[0]
    fields = {}
    for name, where in index_pspec(first).items():
        if where == DOC:
            fields[name] = _join([getattr(s, name) for s in sharded.shards], dev)
        else:
            fields[name] = move(getattr(first, name), dev)
    return dataclasses.replace(first, **fields)


def shard_rows(mesh: Mesh, x, axes: Sequence[str]) -> list:
    """A (N, ...) tensor (or numpy array) split by rows over ``axes``, each
    part on its shard's device; N must divide by the shard count."""
    devices = shard_devices(mesh, axes)
    x = torch.as_tensor(x)
    if x.shape[0] % len(devices):
        raise ValueError(f"{x.shape[0]} rows not divisible by {len(devices)} shards")
    n_local = x.shape[0] // len(devices)
    return [_to(x.narrow(0, s * n_local, n_local), d) for s, d in enumerate(devices)]


# --------------------------------------------------------------------------
# Distributed build
# --------------------------------------------------------------------------


def build_sharded(
    mesh: Mesh,
    vectors,
    config,
    axes: Sequence[str],
    keep_vectors: bool = True,
    rerank_store: Optional[str] = None,
    primary_postings: str = "fp32",
    postings_group: int = 32,
) -> ShardedIndex:
    """Build ANY encoding's index split over ``axes``: the staged
    :class:`repro_torch.core.builder.BuildPipeline` run row-parallel, each
    shard over its own rows on its device; df and the reduction's moments
    ``psum`` so every shard holds the statistics of the whole corpus.  The
    leaves equal a monolithic build's bit for bit (the reduction within
    f32 tolerance and up to eigenvector signs).

    ``rerank_store``: "exact" | "int8" | "none" (None derives from
    ``keep_vectors``).  ``primary_postings``: "fp32" | "int8" | "int4",
    quantized row by row on each shard."""
    from repro_torch.core import builder

    if rerank_store is None:
        rerank_store = "exact" if keep_vectors else "none"
    bp = builder.make_build_pipeline(config, rerank_store, primary_postings, postings_group)
    return bp.build_sharded(mesh, vectors, tuple(axes))


def build_fakewords_sharded(mesh: Mesh, vectors, config: FakeWordsConfig, axes: Sequence[str],
                            keep_vectors: bool = True) -> ShardedIndex:
    """Deprecated alias: the fake-words case of :func:`build_sharded`."""
    return build_sharded(mesh, vectors, config, axes, keep_vectors)


# --------------------------------------------------------------------------
# Distributed search
# --------------------------------------------------------------------------


def _shard_filt(filt, index: ShardedIndex, batch: int) -> list:
    """The (N,) keep bitmap split with the rows, as each shard's bool
    ``filt``; per-shard bitmaps (a list, as
    :func:`make_packed_segmented_search` returns them) pass."""
    devices = index.devices
    if isinstance(filt, (list, tuple)):
        return [pl.as_filter(f, index.n_local, batch, d) for f, d in zip(filt, devices)]
    f = torch.as_tensor(filt)
    if f.dim() != 1:
        raise ValueError("sharded filtered search takes a shared (N,) mask (it shards with "
                         f"the postings), got shape {tuple(f.shape)}")
    f = pl.as_filter(f, index.num_docs, batch, f.device)
    return [pl.as_filter(_rows(f, s * index.n_local, index.n_local), index.n_local, batch, d)
            for s, d in enumerate(devices)]


def make_sharded_search(
    mesh: Mesh,
    config,
    axes: Sequence[str],
    k: int = 10,
    depth: int = 100,
    rerank: bool = True,
    keep_vectors: bool = True,
    blockmax_keep: Optional[int] = None,
    rerank_store: Optional[str] = None,
    postings_bits: int = 0,
    filtered: bool = False,
):
    """``search(index, q_rep, queries) -> (scores, ids)`` over a
    :class:`ShardedIndex` of any method but the graph: each shard runs the
    method's matcher on its rows (its kernel, on its device), reranks its
    own candidates from its own store, and the coordinator (shard 0's
    device) takes one stable top-k of the gathered (B, S * d) lists.
    ``q_rep`` is the replicated query representation (``AnnIndex.
    encode_queries``); ``queries`` the unit-normalized queries (used by the
    rerank).  Padding slots stay (-inf, -1), never ``-1 + shard *
    n_local``.

    ``blockmax_keep`` makes it ``search(index, bm, q_rep, queries)`` with
    ``bm`` from :func:`build_blockmax_sharded`: each shard runs the
    two-stage pruned match over its own blocks.  ``rerank_store`` names
    the store the index was built with ("exact" | "int8" | "none"; None
    derives from ``keep_vectors``); "int8" reranks from the int8 store.
    ``postings_bits`` (0 | 8 | 4) names the primary postings; it is
    checked against the shards' packed store.  ``filtered=True`` appends a
    trailing ``filt``: a (N,) keep bitmap (nonzero = keep) split with the
    rows, each shard's part going into its matcher's kernel pass."""
    axes = tuple(axes)
    if isinstance(config, GraphConfig):
        raise TypeError(_GRAPH_SEARCH_MSG)
    if isinstance(config, KdTreeConfig) and config.backend == "tree":
        raise ValueError(_TREE_BACKEND_MSG)
    if postings_bits not in (0, 8, 4):
        raise ValueError(f"postings_bits must be 0, 8 or 4, got {postings_bits}")
    if rerank_store is None:
        rerank_store = "exact" if keep_vectors else "none"
    if rerank and rerank_store == "none" and not isinstance(config, BruteForceConfig):
        raise ValueError("rerank=True needs rerank_store 'exact' or 'int8'")
    matcher = pl.make_matcher(config)

    def local(shard, bm, q_rep, queries, filt, base):
        if bm is not None:
            n_keep = min(blockmax_keep, bm.num_blocks)
            # Cap on gathered candidates, not n_local: a ragged shard whose
            # kept blocks carry pad rows returns -1 slots past its valid
            # candidates (masked below).
            loc_s, loc_i = pl.BlockMaxMatcher(n_keep, bm)(
                shard, q_rep, min(depth, n_keep * bm.block_size), filt=filt)
        else:
            loc_s, loc_i = matcher(shard, q_rep, depth, filt=filt)
        valid = loc_i >= 0
        if rerank:
            # Against the shard's own store: no rows cross shards; -1 slots
            # are masked to -inf (they would gather local row 0).
            loc_s = pl.candidate_scores(shard, queries, loc_i, quantized=rerank_store == "int8")
        return loc_s, torch.where(valid, loc_i + base, -1)

    def run(index: ShardedIndex, bm, q_rep, queries, filt):
        if not isinstance(index, ShardedIndex):
            raise TypeError("make_sharded_search's callable takes a ShardedIndex "
                            "(build_sharded / shard_index)")
        pq = getattr(index.shards[0], "pq", None)
        if pq is not None and postings_bits and pq.bits != postings_bits:
            raise ValueError(f"postings_bits={postings_bits} but the index's packed "
                             f"postings are {pq.bits}-bit")
        devices = index.devices
        s_count = len(devices)
        b = q_rep.shape[0]
        parts = shard_map(
            local, devices, index.shards,
            bm.shards if bm is not None else [None] * s_count,
            replicate(q_rep, devices),
            replicate(queries, devices) if rerank else [None] * s_count,
            _shard_filt(filt, index, b) if filt is not None else [None] * s_count,
            [s * index.n_local for s in range(s_count)])
        # The (score, id) lists are the only cross-shard traffic.
        all_s = all_gather([p[0] for p in parts], axis=1)
        all_i = all_gather([p[1] for p in parts], axis=1)
        top_s, pos = stable_topk(all_s, k)
        return top_s, torch.gather(all_i, 1, pos.long())

    if blockmax_keep is not None:
        if filtered:
            def search(index, bm, q_rep, queries, filt):
                return run(index, bm, q_rep, queries, filt)
        else:
            def search(index, bm, q_rep, queries):
                return run(index, bm, q_rep, queries, None)
    elif filtered:
        def search(index, q_rep, queries, filt):
            return run(index, None, q_rep, queries, filt)
    else:
        def search(index, q_rep, queries):
            return run(index, None, q_rep, queries, None)
    return search


def build_blockmax_sharded(mesh: Mesh, index: ShardedIndex, axes: Sequence[str],
                           block_size: int = 256, mode: Optional[str] = None) -> ShardedIndex:
    """Per-shard block upper bounds over a sharded fake-words or LSH
    index.  Each shard blocks ITS OWN rows (padding its last block
    locally), so local block ids line up with local rows whatever
    ``n_local % block_size``; a ragged shard's pad rows are masked to (-inf,
    -1) by the pruned stage 2."""
    if not isinstance(index, ShardedIndex):
        raise TypeError("build_blockmax_sharded takes a ShardedIndex")
    bms = shard_map(lambda shard: build_blockmax(shard, block_size, mode=mode), index.devices,
                    index.shards)
    return ShardedIndex(tuple(bms), mesh, tuple(axes))


def shard_blockmax(mesh: Mesh, bm: BlockMaxIndex, axes: Sequence[str]) -> ShardedIndex:
    """Split monolithic block bounds with the rows: blocks must not
    straddle shards, so the local doc count must be a multiple of
    ``block_size`` (global block b then lives on shard b // n_blocks_local)."""
    n_shards = flat_axis_size(mesh, axes)
    if bm.num_blocks % n_shards:
        raise ValueError(f"{bm.num_blocks} blocks not divisible by {n_shards} shards "
                         "(need n_local % block_size == 0)")
    return shard_index(mesh, bm, axes)


# --------------------------------------------------------------------------
# Packed segmented search over a mesh
# --------------------------------------------------------------------------


def make_packed_segmented_search(
    mesh: Mesh,
    reader,
    axes: Sequence[str],
    k: int = 10,
    depth: int = 100,
    rerank: bool = False,
    filter_mask=None,
):
    """The packed single-launch segmented path composed with the fan-out:
    pack a :class:`repro_torch.core.segments.SegmentedAnnIndex` snapshot
    (``core/packed.py``), split the packed view over ``axes`` and serve it
    through :func:`make_sharded_search`'s filtered path with the liveDocs
    ∧ row-validity [∧ predicate] bitmap split with the rows.  Packed row g
    is global doc id g, so the merged ids are the reader's global ids.
    ``filter_mask`` is a (max_doc,) global-id keep bitmap.

    Returns ``(search_fn, sharded_index, sharded_filt)``; call
    ``search_fn(sharded_index, q_rep, queries, sharded_filt)`` with ``q_rep
    = reader.encode_queries(queries)`` and unit-normalized ``queries``."""
    from repro_torch.core import packed as packed_mod

    axes = tuple(axes)
    pk = reader.packed_segments()
    if pk is None:
        raise ValueError("packed single-launch path unavailable for this snapshot: "
                         f"{reader._packed_err}")
    n_shards = flat_axis_size(mesh, axes)
    if pk.bucket % n_shards:
        raise ValueError(f"packed bucket {pk.bucket} rows not divisible by {n_shards} shards; "
                         "choose a mesh whose flattened size divides the bucket ladder rung")
    view = pk.view
    if reader.quantized_rerank:
        rerank_store = "int8"
    elif getattr(view, "vectors", None) is not None:
        rerank_store = "exact"
    else:
        rerank_store = "none"
    pq = getattr(view, "pq", None)
    search_fn = make_sharded_search(
        mesh, reader.config, axes, k=k, depth=depth, rerank=rerank,
        rerank_store=rerank_store, postings_bits=0 if pq is None else pq.bits, filtered=True)
    filt = pk.live
    if filter_mask is not None:
        fm = torch.as_tensor(filter_mask)
        if fm.dim() != 1 or fm.shape[0] != reader.max_doc:
            raise ValueError("pod-sharded filtering takes a (max_doc,) per-doc bitmap "
                             f"(got shape {tuple(fm.shape)}, max_doc={reader.max_doc})")
        fm = pl.as_filter(fm, reader.max_doc, 1, filt.device)
        filt = filt & packed_mod._pad_mask_cols(fm, pk.bucket)
    return search_fn, shard_index(mesh, view, axes), shard_rows(mesh, filt, axes)
