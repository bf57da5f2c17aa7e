"""Lucene-style segmented mutable index (port of ``repro/core/segments.py``):
IndexWriter / commit / merge over immutable AnnIndex segments.

  * :class:`repro_torch.core.index.AnnIndex` is the immutable **segment**:
    ``IndexWriter.add`` buffers rows and ``flush`` builds them through the
    method's BuildPipeline into a new segment, on the writer's device.
  * ``IndexWriter.delete(ids)`` flips bits in a per-segment **liveDocs**
    mask (Lucene's ``.liv`` sidecar), a host bool array, moved to the
    device once per snapshot.  Deleted docs are masked INSIDE the match
    stage: the loop passes liveDocs (∧ any predicate) as each segment's
    kernel ``filt`` operand (one pass, exact at any selectivity), so
    ``depth`` keeps its meaning under deletes.
  * ``IndexWriter.commit`` persists a generation-numbered commit point:
    per-segment format-1 index dirs, per-generation live files and a
    ``segments_N.json`` manifest written last via ``os.replace``
    (``format_version`` 2; a plain format-1 ``AnnIndex.save`` dir loads as
    one segment).  The format is the reference's: commits open both ways
    with the JAX package.
  * :class:`TieredMergePolicy` compacts runs of small adjacent segments by
    rebuilding their live rows through the same BuildPipeline (deleted
    rows drop out, later global ids remap), as a Lucene merge does.
  * :class:`SegmentedAnnIndex` is the point-in-time **reader**.  Its
    search runs the packed single launch (:mod:`repro_torch.core.packed`)
    where the layout allows, else the per-segment loop, which merges the
    segments' top-depth lists on global ids.
  * ``IndexWriter.refresh()`` is the NRT hook: flush + snapshot; the
    snapshot's ``epoch`` (:func:`repro_torch.core.types.next_epoch`)
    advances only when something changed.

**Collection statistics.**  Every segment is scored under the collection's
live statistics, so a segmented search returns what a monolithic build of
the live corpus returns:

  * fake words: df is recounted over live rows per segment and summed
    (exact integers); idf and the classic ``scored`` matrix are re-derived
    from the collection's (df, live N) through the build's own
    ``builder.classic_scored`` (row-local);
  * k-d tree: the reduction refits on the concatenated live originals and
    every segment re-projects through it;
  * lexical LSH, brute force: signatures and unit rows carry none;
  * the graph: each segment keeps its own adjacency and is searched by its
    own traversal (liveDocs mask its result list only), so a segmented
    graph search is approximate in its own way, not a monolithic build's.

Integer scores (dot, LSH) and classic's bf16 products are then bit-equal
to the monolithic build's.  f32 scores (brute force, the kd scan) may
differ in the last bit, where a product's shape follows a segment's row
count (the reference's own segmented / monolithic check differs there), so
they are held under the near-tie rule.  ``global_stats=False`` scores each
segment under its own statistics.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import bruteforce, builder, pca
from repro_torch.core import index as index_mod
from repro_torch.core import packed as packed_mod
from repro_torch.core import pipeline as pl
from repro_torch.core.index import AnnIndex, AnyConfig, _check_device
from repro_torch.core.types import (
    DocMetadata,
    FakeWordsConfig,
    KdTreeConfig,
    LexicalLshConfig,
    SearchParams,
    next_epoch,
)
from repro_torch.kernels.common import stable_topk
from repro_torch.kernels.fused_topk import ops as fused

SEGMENTS_FORMAT_VERSION = 2

_METHOD_BY_CONFIG = {v: k for k, v in index_mod._CONFIG_BY_METHOD.items()}

_COMMIT_RE = re.compile(r"^segments_(\d+)\.json$")

_NEEDS_VECTORS_MSG = "requires the fp32 original vectors on every segment (rerank_store='exact')"


def find_commits(path: str) -> List[Tuple[int, str]]:
    """(generation, filename) of every commit point under ``path``,
    ascending; empty when it holds none (a format-1 save, or nothing)."""
    if not os.path.isdir(path):
        return []
    out = []
    for name in os.listdir(path):
        m = _COMMIT_RE.match(name)
        if m:
            out.append((int(m.group(1)), name))
    return sorted(out)


def _bucket(n: int) -> int:
    """A deleted-doc count rounded up to a power of two: the depth the
    inflated liveDocs match (``FilterMask(native=False)``) adds."""
    return 0 if n <= 0 else 1 << (n - 1).bit_length()


def _concat_metadata(parts: Sequence[Optional[DocMetadata]],
                     rows_kept=None) -> Optional[DocMetadata]:
    """Concatenate per-chunk metadata (flush: the buffered adds; merge: the
    merged segments' live rows, ``rows_kept`` host bool selectors).  All
    chunks must agree on presence and fields: metadata over part of a
    segment cannot answer a predicate over all of it."""
    parts = list(parts)
    if all(p is None for p in parts):
        return None
    if any(p is None for p in parts):
        raise ValueError("metadata must cover either all rows or none (some adds/segments "
                         "carry metadata and some do not)")
    names = parts[0].field_names
    if any(p.field_names != names for p in parts):
        raise ValueError(f"inconsistent metadata fields: {[p.field_names for p in parts]}")
    if rows_kept is None:
        vals = [p.values for p in parts]
    else:
        vals = [p.values[torch.from_numpy(k).to(p.values.device)]
                for p, k in zip(parts, rows_kept)]
    return DocMetadata(values=torch.cat(vals, dim=0), field_names=names)


# --------------------------------------------------------------------------
# Segments
# --------------------------------------------------------------------------


@dataclasses.dataclass
class Segment:
    """One immutable index and its mutable liveDocs mask (host bool array,
    True = live).  ``name`` is the on-disk directory name given at flush.

    ``source`` holds the unit-normalized original rows on the host when the
    index does not carry them (rerank_store "int8" / "none"): merges
    rebuild from them and the kd refit reads them.  None when
    ``ann.index.vectors`` is present.  Persisted as ``source.npz``."""

    ann: AnnIndex
    live: np.ndarray
    name: str
    source: Optional[np.ndarray] = None

    def source_rows(self) -> Optional[torch.Tensor]:
        """The unit-normalized original rows on the segment's device (the
        stored vectors, or the sidecar moved there); None if it kept
        neither."""
        if self.ann.index.vectors is not None:
            return self.ann.index.vectors
        if self.source is None:
            return None
        return torch.from_numpy(self.source).to(self.ann.device)

    @property
    def num_docs(self) -> int:
        """Total rows, deleted included (Lucene maxDoc)."""
        return self.ann.num_docs

    @property
    def num_live(self) -> int:
        return int(self.live.sum())

    @property
    def del_count(self) -> int:
        return self.num_docs - self.num_live

    def snapshot(self) -> "Segment":
        """Point-in-time copy: shares the immutable index, copies the live
        mask (later deletes do not leak into an open reader)."""
        return Segment(ann=self.ann, live=self.live.copy(), name=self.name, source=self.source)


# --------------------------------------------------------------------------
# Merge policy
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TieredMergePolicy:
    """Lucene-style tiered merging over ADJACENT segments.

    Tier t holds up to ``floor_docs * merge_factor**t`` live docs; a run of
    ``merge_factor`` adjacent same-tier segments merges into one of the
    next tier, so the segment count stays O(merge_factor * log(N /
    floor_docs)).  A segment whose deleted share reaches ``expunge_ratio``
    is rewritten alone.  Only adjacent runs merge, so global doc order
    stays add order (what makes the results a monolithic build's)."""

    merge_factor: int = 8
    floor_docs: int = 1024
    expunge_ratio: float = 0.5

    def __post_init__(self):
        if self.merge_factor < 2:
            raise ValueError("merge_factor must be >= 2")
        if not (0.0 < self.expunge_ratio <= 1.0):
            raise ValueError("expunge_ratio must be in (0, 1]")

    def tier(self, num_live: int) -> int:
        t, cap = 0, max(1, self.floor_docs)
        while num_live > cap:
            cap *= self.merge_factor
            t += 1
        return t

    def find_merge(self, segments: Sequence[Segment]) -> Optional[Tuple[int, int]]:
        """The next ``[start, end)`` range to merge, or None when the
        geometry is stable (``IndexWriter`` calls it in a loop)."""
        for i, seg in enumerate(segments):
            if seg.num_docs and seg.del_count / seg.num_docs >= self.expunge_ratio:
                return (i, i + 1)
        tiers = [self.tier(s.num_live) for s in segments]
        start = 0
        while start < len(tiers):
            end = start
            while end < len(tiers) and tiers[end] == tiers[start]:
                end += 1
            if end - start >= self.merge_factor:
                return (start, start + self.merge_factor)
            start = end
        return None


# --------------------------------------------------------------------------
# Per-segment search, merged on global ids
# --------------------------------------------------------------------------


def _segment_match(matcher: pl.FilterMask, view, mask: Optional[torch.Tensor], base: int,
                   q_rep: torch.Tensor, depth: int, native: bool = True):
    """One segment's top-depth on global ids.  ``mask`` is its liveDocs (∧
    predicate) bitmap, None when it keeps every row.  ``native`` passes it
    to the kernel as ``filt`` (one pass); otherwise the match runs
    ``_bucket(masked)`` deeper unfiltered and masks after (depth
    inflation, the reference's deletes-only path)."""
    if mask is None:
        s, i = matcher.inner(view, q_rep, min(depth, view.num_docs))
    elif native:
        s, i = matcher(view, q_rep, depth, mask, native=True)
    else:
        extra = _bucket(int((~mask).sum(dim=-1).max()))
        s, i = dataclasses.replace(matcher, extra=extra)(view, q_rep, depth, mask)
    return s, torch.where(i >= 0, i + base, torch.full_like(i, -1))


def _merge_candidates(parts_s, parts_i, q_norm: torch.Tensor, stores, k: int, depth: int,
                      rerank: bool, quantized: bool, bases: Sequence[int]):
    """Merge the per-segment candidate lists as the monolithic path ranks
    them: the global top-``depth`` by MATCH score first (segment-major
    concatenation + a stable sort: ties to the lowest global id), then the
    rerank over the merged list.  The rerank assembles the candidates'
    stored rows into ONE (B, depth, dim) tensor, each segment filling the
    positions it owns, and scores it as the monolithic reranker does, so
    the rerank scores are the monolithic build's."""
    all_s = torch.cat(list(parts_s), dim=1)
    all_i = torch.cat(list(parts_i), dim=1)
    top_s, pos = stable_topk(all_s, depth)
    top_i = torch.gather(all_i, 1, pos.long())
    if not rerank:
        return top_s[:, :k], top_i[:, :k]
    cand = scale = None
    for base, store in zip(bases, stores):
        rows = store[0] if quantized else store
        n = rows.shape[0]
        own = (top_i >= base) & (top_i < base + n)
        safe = (top_i - base).clamp(0, n - 1).long()
        part = rows[safe]  # (B, depth, dim)
        cand = part if cand is None else torch.where(own[:, :, None], part, cand)
        if quantized:
            sc = store[1][safe]  # (B, depth)
            scale = sc if scale is None else torch.where(own, sc, scale)
    return bruteforce.rerank_gathered(q_norm, cand, top_i, k, scale=scale)


# --------------------------------------------------------------------------
# The reader
# --------------------------------------------------------------------------


class SegmentedAnnIndex:
    """Point-in-time multi-segment reader (Lucene DirectoryReader).

    Segments share their immutable AnnIndexes with the writer and own
    copies of the live masks; ``epoch`` identifies the snapshot.  Global id
    = segment base (the preceding segments' rows, deleted included) +
    local row: ids survive deletes; merges compact and remap them."""

    def __init__(self, config: AnyConfig, segments: Sequence[Segment],
                 global_stats: bool = True, device=None):
        if isinstance(config, KdTreeConfig) and config.backend == "tree":
            raise ValueError(
                "segmented kd-tree requires backend='scan' (the same neighbours); the "
                "host-built tree arrays cannot re-derive shared global statistics")
        self.config = config
        self.segments = list(segments)
        self.global_stats = global_stats
        self.epoch = next_epoch()
        self.device = (self.segments[0].ann.device if self.segments
                       else _check_device("cuda" if device is None else device))
        self.pipeline = pl.build_pipeline(config)
        # Quantized rerank iff every segment carries ONLY the int8 store.
        self.quantized_rerank = bool(self.segments) and all(
            s.ann.index.vectors is None and s.ann.index.vq is not None for s in self.segments)
        self._views: Optional[List[Any]] = None
        self._live_dev: Optional[List[torch.Tensor]] = None
        self._deleted: Optional[List[bool]] = None  # per segment: any row dead
        self._n_live = int(sum(s.num_live for s in self.segments))
        base = pl.make_matcher(config)
        if global_stats and isinstance(base, pl.FakeWordsMatcher) and base.df_max_ratio < 1.0:
            # A real prune ratio thresholds against the collection's live
            # count; at df_max_ratio >= 1 every term stays whatever the
            # count, so df_num_docs stays unset and the matcher (a part of
            # the executable cache's key) survives refreshes.
            base = dataclasses.replace(base, df_num_docs=self._n_live)
        self._matcher = pl.FilterMask(inner=base)  # one matcher for the loop and the pack
        # The packed single-launch state, built lazily; _packed_prior is the
        # previous snapshot's pack, handed over by IndexWriter.refresh() so
        # that an append-only refresh writes into its buffers.
        self._packed: Optional[packed_mod.PackedSegments] = None
        self._packed_prior: Optional[packed_mod.PackedSegments] = None
        self._packed_err: Optional[str] = None

    # -- shape/identity ----------------------------------------------------

    @property
    def method(self) -> str:
        return _METHOD_BY_CONFIG[type(self.config)]

    @property
    def num_docs(self) -> int:
        """LIVE docs (Lucene ``numDocs``); ``max_doc`` counts deleted too."""
        return self._n_live

    @property
    def max_doc(self) -> int:
        return sum(s.num_docs for s in self.segments)

    @property
    def num_segments(self) -> int:
        return len(self.segments)

    @property
    def del_count(self) -> int:
        return self.max_doc - self._n_live

    def nbytes(self) -> int:
        """The segments' index bytes plus their host liveDocs masks."""
        return sum(s.ann.nbytes() + s.live.nbytes for s in self.segments)

    def live_global_ids(self) -> np.ndarray:
        """Global ids of the live docs in add order: monolithic id j of the
        equivalent live corpus is ``live_global_ids()[j]``."""
        parts, base = [], 0
        for s in self.segments:
            parts.append(np.flatnonzero(s.live) + base)
            base += s.num_docs
        return (np.concatenate(parts) if parts else np.zeros((0,), np.int64)).astype(np.int64)

    # -- collection statistics (Lucene IndexSearcher-level) ----------------

    def _ensure_views(self) -> Tuple[List[Any], pl.FilterMask]:
        if self._views is None:
            self._live_dev = [torch.from_numpy(s.live).to(self.device) for s in self.segments]
            self._deleted = [bool(s.del_count) for s in self.segments]
            self._views = (self._stat_views() if self.global_stats
                           else [s.ann.index for s in self.segments])
        return self._views, self._matcher

    def _stat_views(self) -> List[Any]:
        segs = self.segments
        if isinstance(self.config, FakeWordsConfig):
            df = None
            for s, live in zip(segs, self._live_dev):
                # dot int4 dropped tf: its df stays the build-time count
                # until a merge rebuilds the segment.
                d = (builder.live_df(s.ann.index.tf, live) if s.ann.index.tf is not None
                     else s.ann.index.df)
                df = d if df is None else df + d
            idf = builder.idf_from_df(df, self._n_live)
            views = []
            for s in segs:
                idx = s.ann.index
                if self.config.scoring != "classic":
                    views.append(dataclasses.replace(idx, df=df, idf=idf))
                    continue
                scored = builder.classic_scored(idx.tf, idf, idx.norm)
                if idx.pq is not None:
                    # Quantized classic keeps tf for this: the scores under
                    # the collection's statistics, re-quantized row by row
                    # (each row's scale and codes depend on that row only).
                    views.append(dataclasses.replace(
                        idx, df=df, idf=idf, scored=None,
                        pq=builder.quantize_postings(scored, idx.pq.bits, idx.pq.group or 32)))
                else:
                    views.append(dataclasses.replace(idx, df=df, idf=idf, scored=scored))
            return views
        if isinstance(self.config, KdTreeConfig):
            if any(s.source_rows() is None for s in segs):
                raise ValueError(
                    "global-stats refresh for a segmented kd-tree " + _NEEDS_VECTORS_MSG
                    + " or a source sidecar; pass global_stats=False to score each segment "
                    "under its own fitted reduction")
            v_live = torch.cat([s.source_rows()[live] for s, live in zip(segs, self._live_dev)])
            model, _ = pca.fit_reduction(v_live, self.config.dims, self.config.reduction,
                                         self.config.ppa_remove)
            views = []
            for s in segs:
                red = pca.apply_reduction(model, s.source_rows()).to(torch.float32)
                views.append(dataclasses.replace(s.ann.index, reduced=red, reduction=model,
                                                 lifted=fused.lift_l2(red)))
            return views
        # LSH signatures, brute-force unit rows and the graph (its
        # adjacency is the segment's own) carry no collection statistics:
        # the stored index is the view.
        return [s.ann.index for s in segs]

    # -- packed single-launch path ------------------------------------------

    def packed_segments(self) -> Optional[packed_mod.PackedSegments]:
        """This snapshot's packed superbuffer, built once and kept on the
        reader.  None when the layout cannot ride the single launch (mixed
        store presence, per-segment statistics, ...): the reason is kept in
        ``_packed_err`` and search serves the per-segment loop."""
        if self._packed is not None:
            return self._packed
        if self._packed_err is not None:
            return None
        views, _ = self._ensure_views()
        prior, self._packed_prior = self._packed_prior, None
        try:
            self._packed = packed_mod.pack_segments(self.config, views, self.segments,
                                                    self.global_stats, prior=prior)
        except packed_mod.PackedUnsupported as e:
            self._packed_err = str(e)
            return None
        return self._packed

    # -- metadata (predicate source for filtered search) --------------------

    def global_metadata(self) -> Optional[DocMetadata]:
        """The segments' metadata concatenated in global-id order (deleted
        rows included: row g answers for global id g), the source of
        ``search(filter_mask=)`` bitmaps.  None when no segment carries
        any; partial coverage raises."""
        mds = [s.ann.metadata for s in self.segments]
        if all(md is None for md in mds):
            return None
        if any(md is None for md in mds):
            raise ValueError("some segments carry doc metadata and some do not; "
                             "metadata-filtered search needs every segment covered")
        names = mds[0].field_names
        if any(md.field_names != names for md in mds):
            raise ValueError(f"segments carry inconsistent metadata fields: "
                             f"{[md.field_names for md in mds]}")
        return DocMetadata(values=torch.cat([md.values for md in mds], dim=0),
                           field_names=names)

    # -- search ------------------------------------------------------------

    def encode_queries(self, queries) -> torch.Tensor:
        views, _ = self._ensure_views()
        if not views:
            raise ValueError("cannot encode against an empty segmented index")
        q = torch.as_tensor(queries, device=self.device)
        return self.pipeline.encoder(views[0], bruteforce.l2_normalize(q))

    def search(
        self,
        queries,
        k: int = 10,
        depth: int = 100,
        rerank: bool = False,
        params: Optional[SearchParams] = None,
        filter_mask=None,
        packed: Optional[bool] = None,
        blockmax_keep: Optional[int] = None,
        blockmax_block_size: int = 256,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Multi-segment search: encode once (the stat view carries any
        fitted model), then the packed single launch or the per-segment
        loop.  For a healthy snapshot the results are those of
        ``AnnIndex.search`` over the equivalent live corpus, ids mapped
        through :meth:`live_global_ids`.

        ``filter_mask`` ((max_doc,) or (B, max_doc); bool, uint8 or int32;
        nonzero = keep; indexed by GLOBAL id, e.g. from
        :meth:`global_metadata`) is composed with liveDocs into one mask in
        the kernels' single pass.  A mask that keeps nothing returns (-inf,
        -1) rows.

        ``packed``: None takes the packed path when the layout allows and
        the loop otherwise (the reason in ``_packed_err``); True raises
        when it does not; False takes the loop.  Both run the same kernels
        on the same device.  ``blockmax_keep`` prunes to that many blocks
        over the packed view (fake words and LSH; approximate by design)."""
        p = params if params is not None else SearchParams(k=k, depth=depth, rerank=rerank)
        if self._n_live == 0:
            raise ValueError("segmented index has no live docs to search")
        views, matcher = self._ensure_views()
        q = torch.as_tensor(queries, device=self.device)
        q_norm = bruteforce.l2_normalize(q)
        fm = None
        if filter_mask is not None:
            width = tuple(np.shape(filter_mask))[-1:]
            if width != (self.max_doc,):
                raise ValueError(
                    f"filter_mask covers {width} docs but the index has max_doc="
                    f"{self.max_doc} (masks index GLOBAL ids, deleted rows included)")
            fm = pl.as_filter(filter_mask, self.max_doc, q.shape[0], self.device)
        want_packed = True if packed is None else bool(packed)
        if blockmax_keep is not None and not want_packed:
            raise ValueError("blockmax_keep rides the packed single-launch path; "
                             "packed=False forces the per-segment loop")
        if want_packed:
            pk = self.packed_segments()
            if pk is None:
                if packed or blockmax_keep is not None:
                    raise ValueError("packed single-launch path unavailable for this "
                                     f"snapshot: {self._packed_err}")
            else:
                if p.rerank and not self.quantized_rerank and pk.view.vectors is None:
                    raise ValueError("rerank=True " + _NEEDS_VECTORS_MSG
                                     + " or the int8 store on every segment")
                bm = None
                if blockmax_keep is not None:
                    if not isinstance(self.config, (FakeWordsConfig, LexicalLshConfig)):
                        raise ValueError("blockmax pruning supports fake-words and LSH "
                                         "encodings only")
                    bm = packed_mod.packed_blockmax(pk, self.config, blockmax_block_size)
                return packed_mod.packed_search(
                    pk, self.pipeline, matcher.inner, q_norm, p.k, p.depth,
                    rerank=p.rerank, quantized=self.quantized_rerank, fm=fm,
                    n_keep=blockmax_keep, bm=bm)
        return self._loop(q_norm, p, fm, matcher)

    def _loop(self, q_norm: torch.Tensor, p: SearchParams, fm: Optional[torch.Tensor],
              matcher: pl.FilterMask, native: bool = True):
        """The per-segment reference path: each segment's match with its
        liveDocs (∧ predicate) mask, merged on global ids."""
        views = self._views
        q_rep = self.pipeline.encoder(views[0], q_norm)
        d_eff = min(p.depth, self._n_live)
        k_eff = min(p.k, d_eff)
        parts_s, parts_i, stores, bases = [], [], [], []
        base = 0
        for seg, view, live, deleted in zip(self.segments, views, self._live_dev,
                                            self._deleted):
            if fm is None:
                mask = live if deleted else None
            else:
                pred = fm[..., base:base + seg.num_docs]
                mask = pred & (live if pred.dim() == 1 else live[None, :])
            s, gid = _segment_match(matcher, view, mask, base, q_rep, p.depth, native)
            parts_s.append(s)
            parts_i.append(gid)
            bases.append(base)
            base += seg.num_docs
            if p.rerank:
                idx = seg.ann.index
                if self.quantized_rerank:
                    stores.append((idx.vq.q, idx.vq.scale))
                elif idx.vectors is not None:
                    stores.append(idx.vectors)
                else:
                    raise ValueError("rerank=True " + _NEEDS_VECTORS_MSG
                                     + " or the int8 store on every segment")
        return _merge_candidates(parts_s, parts_i, q_norm, stores, k_eff, d_eff, p.rerank,
                                 self.quantized_rerank, bases)

    # -- persistence (read side; IndexWriter.commit writes) ----------------

    @classmethod
    def load(cls, path: str, generation: Optional[int] = None,
             device="cuda") -> "SegmentedAnnIndex":
        """Open a commit point (the latest generation by default) onto
        ``device`` (raises when it is a CUDA device and none is available).
        A plain format-1 ``AnnIndex.save`` dir loads as one fully-live
        segment."""
        dev = _check_device(device)
        commits = find_commits(path)
        if not commits:
            if os.path.exists(os.path.join(path, "config.json")):
                if generation is not None:
                    raise FileNotFoundError(
                        f"{path!r} is a v1 single-index save with no commit generations; "
                        f"cannot load generation {generation}")
                ann = AnnIndex.load(path, device=dev)
                seg = Segment(ann=ann, live=np.ones(ann.num_docs, bool), name="seg0")
                return cls(ann.config, [seg])
            raise FileNotFoundError(
                f"no segments_N.json commit point (and no v1 config.json) under {path!r}")
        if generation is None:
            generation, fname = commits[-1]
        else:
            by_gen = dict(commits)
            if generation not in by_gen:
                raise FileNotFoundError(f"no commit generation {generation} under {path!r} "
                                        f"(have {sorted(by_gen)})")
            fname = by_gen[generation]
        with open(os.path.join(path, fname)) as f:
            meta = json.load(f)
        version = meta.get("format_version", 2)
        if version > SEGMENTS_FORMAT_VERSION:
            raise ValueError(
                f"commit point {fname!r} has format_version {version}, but this build reads "
                f"<= {SEGMENTS_FORMAT_VERSION} — it was written by a newer version of the "
                "code; upgrade to load it")
        config = index_mod._CONFIG_BY_METHOD[meta["method"]](**meta["config"])
        segments = []
        for e in meta["segments"]:
            ann = AnnIndex.load(os.path.join(path, e["name"]), device=dev)
            if e.get("live_file"):
                with np.load(os.path.join(path, e["live_file"])) as z:
                    live = z["live"].astype(bool)
            else:
                live = np.ones(ann.num_docs, bool)
            source = None
            src_file = os.path.join(path, e["name"], "source.npz")
            if ann.index.vectors is None and os.path.exists(src_file):
                with np.load(src_file) as z:
                    source = z["source"]
            segments.append(Segment(ann=ann, live=live, name=e["name"], source=source))
        return cls(config, segments, global_stats=meta.get("global_stats", True), device=dev)


# --------------------------------------------------------------------------
# The writer
# --------------------------------------------------------------------------


class IndexWriter:
    """Lucene IndexWriter for AnnIndex segments: buffer adds, flush through
    the BuildPipeline on ``device``, flip liveDocs bits on delete, merge by
    policy, and commit generation-numbered points.

    ``add`` assigns consecutive global ids; ids are stable across adds and
    deletes, and a merge compacts its range and REMAPS every id after it.
    ``refresh()`` returns a point-in-time :class:`SegmentedAnnIndex` whose
    ``epoch`` advances only when something changed.

    Any ``rerank_store`` and ``primary_postings`` work: when a built
    segment does not carry the fp32 originals, the writer keeps them as a
    host ``Segment.source`` sidecar (normalized once, persisted as
    ``source.npz``), so merges rebuild live rows bit for bit and the kd
    refit reads them.  ``device`` defaults to the card and raises without
    one."""

    def __init__(
        self,
        config: AnyConfig,
        path: Optional[str] = None,
        rerank_store: str = "exact",
        merge_policy: Optional[TieredMergePolicy] = TieredMergePolicy(),
        max_buffered_docs: Optional[int] = None,
        global_stats: bool = True,
        primary_postings: str = "fp32",
        postings_group: int = 32,
        device="cuda",
    ):
        if rerank_store not in ("exact", "int8", "none"):
            raise ValueError(f"unknown rerank_store {rerank_store!r}")
        if isinstance(config, KdTreeConfig) and config.backend == "tree":
            raise ValueError("segmented kd-tree requires backend='scan'")
        self.device = _check_device(device)
        self.config = config
        self.path = path
        self.rerank_store = rerank_store
        self.primary_postings = primary_postings
        self.postings_group = postings_group
        self.merge_policy = merge_policy
        self.max_buffered_docs = max_buffered_docs
        self.global_stats = global_stats
        self._segments: List[Segment] = []
        self._buf: List[torch.Tensor] = []
        self._buf_live: List[np.ndarray] = []
        self._buf_md: List[Optional[DocMetadata]] = []
        self._seg_counter = 0
        self._changed = False
        self._reader: Optional[SegmentedAnnIndex] = None
        # The latest commit generation THIS writer has read or written: the
        # lineage guard (Lucene's write.lock analog) refuses to commit into
        # a directory whose commits it never saw.
        self._last_gen = 0

    @classmethod
    def open(cls, path: str, **kwargs) -> "IndexWriter":
        """Open the latest commit point under ``path`` for further writes
        (a format-1 ``AnnIndex.save`` dir opens as one segment: the upgrade
        from a frozen index to an online one)."""
        reader = SegmentedAnnIndex.load(path, device=kwargs.get("device", "cuda"))
        kwargs.setdefault("global_stats", reader.global_stats)
        if reader.segments:
            # Continue the stores the existing segments were built with.
            idx = reader.segments[0].ann.index
            if idx.vectors is not None:
                kwargs.setdefault("rerank_store", "exact")
            elif getattr(idx, "vq", None) is not None:
                kwargs.setdefault("rerank_store", "int8")
            else:
                kwargs.setdefault("rerank_store", "none")
            pq = getattr(idx, "pq", None)
            if pq is not None:
                kwargs.setdefault("primary_postings", f"int{pq.bits}")
                kwargs.setdefault("postings_group", pq.group or 32)
        w = cls(reader.config, path=path, **kwargs)
        w._segments = reader.segments
        commits = find_commits(path)
        w._last_gen = commits[-1][0] if commits else 0
        nums = [int(m.group(1)) for m in (re.match(r"^seg(\d+)$", s.name) for s in w._segments)
                if m]
        w._seg_counter = max(nums) + 1 if nums else 0
        return w

    # -- counts ------------------------------------------------------------

    @property
    def buffered_docs(self) -> int:
        return sum(len(c) for c in self._buf)

    @property
    def total_docs(self) -> int:
        """Total assigned doc ids (segments + buffer, deleted included)."""
        return sum(s.num_docs for s in self._segments) + self.buffered_docs

    @property
    def num_segments(self) -> int:
        return len(self._segments)

    def _next_name(self) -> str:
        name = f"seg{self._seg_counter}"
        self._seg_counter += 1
        return name

    # -- mutation ----------------------------------------------------------

    def add(self, vectors, metadata=None) -> np.ndarray:
        """Buffer rows (numpy or a tensor; moved to the writer's device as
        f32); returns their global doc ids.  They become searchable at the
        next flush / refresh / commit.  ``metadata``: per-row fields, a
        ``{field: (n,) ints}`` mapping or a :class:`DocMetadata`; every add
        into one index must agree on the field set."""
        rows = torch.as_tensor(vectors, device=self.device).to(torch.float32)
        if rows.dim() == 1:
            rows = rows[None, :]
        if rows.dim() != 2 or rows.shape[0] == 0:
            raise ValueError(f"add expects (n, dim) rows, got {tuple(rows.shape)}")
        md = builder.build_metadata(metadata, rows.shape[0], self.device)
        start = self.total_docs
        self._buf.append(rows)
        self._buf_live.append(np.ones(rows.shape[0], bool))
        self._buf_md.append(md)
        if self.max_buffered_docs is not None and self.buffered_docs >= self.max_buffered_docs:
            self.flush()
        return np.arange(start, start + rows.shape[0], dtype=np.int64)

    def delete(self, ids) -> int:
        """Flip liveDocs bits for the given global doc ids (buffered rows
        included).  Returns the number of newly deleted docs: a dead or
        repeated id is a no-op.  An unknown id raises IndexError before any
        bit flips."""
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        total = self.total_docs
        bad = ids[(ids < 0) | (ids >= total)]
        if bad.size:
            raise IndexError(f"unknown doc id {int(bad[0])} (have {total} docs)")
        chunks = [s.live for s in self._segments] + self._buf_live
        starts = np.cumsum([0] + [len(c) for c in chunks])
        ids = np.unique(ids)
        owner = np.searchsorted(starts, ids, side="right") - 1
        newly = 0
        for c in np.unique(owner):
            loc = ids[owner == c] - starts[c]
            live = chunks[c]
            newly_here = int(live[loc].sum())
            live[loc] = False
            newly += newly_here
            if newly_here and c < len(self._segments):
                self._changed = True
        return newly

    def flush(self) -> bool:
        """Build the buffered rows into a new immutable segment, then let
        the merge policy react.  Returns True when a segment was written."""
        if not self._buf:
            return False
        rows = torch.cat(self._buf, dim=0)
        live = np.concatenate(self._buf_live, axis=0)
        md = _concat_metadata(self._buf_md)
        ann = self._build_segment(rows, normalized=False, metadata=md)
        self._segments.append(Segment(ann=ann, live=live, name=self._next_name(),
                                      source=self._source_sidecar(ann, rows, normalized=False)))
        self._buf, self._buf_live, self._buf_md = [], [], []
        self._changed = True
        self.maybe_merge()
        return True

    def _build_segment(self, rows: torch.Tensor, normalized: bool, metadata=None) -> AnnIndex:
        return AnnIndex.build(rows, self.config, rerank_store=self.rerank_store,
                              primary_postings=self.primary_postings,
                              postings_group=self.postings_group, normalized=normalized,
                              metadata=metadata, device=self.device)

    @staticmethod
    def _source_sidecar(ann: AnnIndex, rows: torch.Tensor,
                        normalized: bool) -> Optional[np.ndarray]:
        """The unit rows on the host when the built index dropped them (the
        rows a rerank_store='exact' build stores: normalized on the same
        device by the same function), so merges do not depend on the store
        choice."""
        if ann.index.vectors is not None:
            return None
        if not normalized:
            rows = bruteforce.l2_normalize(rows)
        return rows.to(torch.float32).cpu().numpy()

    # -- merging -----------------------------------------------------------

    def maybe_merge(self) -> int:
        """Run the merge policy to a fixed point; returns the merges done."""
        if self.merge_policy is None:
            return 0
        done = 0
        while True:
            rng = self.merge_policy.find_merge(self._segments)
            if rng is None:
                return done
            self._merge_range(*rng)
            done += 1

    def force_merge(self, max_segments: int = 1) -> None:
        """Compact to at most ``max_segments`` segments and expunge every
        delete (``max_segments=1`` leaves one fully-live segment, a
        monolithic build of the live corpus)."""
        self.flush()
        if max_segments < 1:
            raise ValueError("max_segments must be >= 1")
        while len(self._segments) > max_segments:
            # The cheapest adjacent pair first (Lucene's smallest-merge bias).
            sizes = [s.num_live for s in self._segments]
            i = min(range(len(sizes) - 1), key=lambda j: sizes[j] + sizes[j + 1])
            self._merge_range(i, i + 2)
        for i in range(len(self._segments) - 1, -1, -1):
            if self._segments[i].del_count:
                self._merge_range(i, i + 1)

    def _merge_range(self, start: int, end: int) -> None:
        """Rebuild segments [start, end) as one: their live unit rows in
        add order through the same BuildPipeline with ``normalized=True``;
        deleted rows drop out and the ids after the range remap."""
        group = self._segments[start:end]
        for s in group:
            if s.source_rows() is None:
                raise ValueError("merging " + _NEEDS_VECTORS_MSG
                                 + f" or a source sidecar; segment {s.name!r} has neither")
        keep = [torch.from_numpy(s.live).to(self.device) for s in group]
        rows = torch.cat([s.source_rows()[k] for s, k in zip(group, keep)], dim=0)
        if rows.shape[0] == 0:  # every row dead: drop the segments
            del self._segments[start:end]
            self._changed = True
            return
        md = _concat_metadata([s.ann.metadata for s in group], rows_kept=[s.live for s in group])
        ann = self._build_segment(rows, normalized=True, metadata=md)
        merged = Segment(ann=ann, live=np.ones(rows.shape[0], bool), name=self._next_name(),
                         source=self._source_sidecar(ann, rows, normalized=True))
        self._segments[start:end] = [merged]
        self._changed = True

    # -- visibility --------------------------------------------------------

    def refresh(self) -> SegmentedAnnIndex:
        """Near-real-time reader (Lucene openIfChanged): flush, then a
        point-in-time snapshot.  The epoch advances IFF something changed;
        an unchanged refresh returns the same reader.  The old snapshot's
        pack goes to the new reader, which writes an append-only refresh
        into its buffers (the old reader repacks if searched again)."""
        self.flush()
        if self._reader is None or self._changed:
            old = self._reader
            self._reader = SegmentedAnnIndex(self.config, [s.snapshot() for s in self._segments],
                                             global_stats=self.global_stats, device=self.device)
            if old is not None:
                self._reader._packed_prior = old._packed
                old._packed = None
            self._changed = False
        return self._reader

    def commit(self, path: Optional[str] = None) -> int:
        """Flush, then persist a generation-numbered commit point: one
        format-1 index dir per segment (written once: segments are
        immutable), a live file per segment with deletes, and
        ``segments_{gen}.json`` written LAST via a temp file + ``os.replace``,
        so a reader sees the whole new generation or the previous one.
        Superseded dirs and live files stay for older generations."""
        path = path if path is not None else self.path
        if path is None:
            raise ValueError("commit needs a path (or IndexWriter(path=...))")
        self.path = path
        self.flush()
        os.makedirs(path, exist_ok=True)
        commits = find_commits(path)
        on_disk = commits[-1][0] if commits else 0
        if on_disk != self._last_gen:
            raise ValueError(
                f"{path!r} holds commit generation {on_disk}, but this writer last saw "
                f"generation {self._last_gen}; open the directory with IndexWriter.open(path) "
                "(or commit to a fresh directory) instead of committing over a foreign "
                "commit history")
        gen = on_disk + 1
        entries = []
        for seg in self._segments:
            seg_dir = os.path.join(path, seg.name)
            if not os.path.exists(os.path.join(seg_dir, "config.json")):
                seg.ann.save(seg_dir)
            if seg.source is not None:
                src_file = os.path.join(seg_dir, "source.npz")
                if not os.path.exists(src_file):
                    np.savez_compressed(src_file, source=seg.source)
            entry = {"name": seg.name, "num_docs": seg.num_docs, "del_count": seg.del_count,
                     "live_file": None}
            if seg.del_count:
                live_file = os.path.join(seg.name, f"live_gen{gen}.npz")
                np.savez_compressed(os.path.join(path, live_file), live=seg.live)
                entry["live_file"] = live_file
            entries.append(entry)
        meta = {
            "format_version": SEGMENTS_FORMAT_VERSION,
            "generation": gen,
            "method": _METHOD_BY_CONFIG[type(self.config)],
            "config": index_mod._config_to_json(self.config),
            "total_docs": sum(s.num_docs for s in self._segments),
            "num_live": sum(s.num_live for s in self._segments),
            "segments": entries,
            "use_kernel": None,  # a reference knob the port does not have
            "global_stats": self.global_stats,
        }
        final = os.path.join(path, f"segments_{gen}.json")
        tmp = final + ".tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=2)
        os.replace(tmp, final)
        self._last_gen = gen
        return gen
