"""Packed single-launch segmented search (port of ``repro/core/packed.py``).

The per-segment loop of :mod:`repro_torch.core.segments` launches the
match kernels once per segment and merges on the host side of the call.
This module packs every segment's stat view into ONE padded superbuffer so
the fused top-k kernels launch once per query batch whatever the segment
count:

  * **Layout.**  Per-doc leaves (postings, signatures, reduced points,
    rerank stores) are concatenated in GLOBAL-ID ORDER with no padding
    between segments, so packed row ``g`` IS global doc id ``g`` and the
    kernels emit global ids directly.  Global leaves (df / idf, the fitted
    reduction) come from the stat views, which share them already.
  * **Bucket ladder.**  Only the tail pads, up to a geometric ladder
    (powers of two and their 1.5x midpoints), so buffer shapes recur across
    flush / merge / refresh cycles.  Tail rows are zeros and never rank:
    they are masked through the same ``filt`` bitmap that masks deletes.
  * **Executable cache.**  :data:`EXEC_CACHE`, an
    :class:`~repro_torch.core.executables.ExecutableCache`.  On the card an
    entry is one captured ``torch.cuda.CUDAGraph`` of the whole match
    (+ rerank), owned by the packed view whose buffers it reads, so a
    pack's entries go when its buffers are freed.  On the CPU an entry is
    the plain callable.
  * **Donated incremental append.**  For stats-static encodings (dot-mode
    fake words, LSH, brute force) a refresh that only appends segments
    writes the new rows into the previous snapshot's buffers in place
    (``copy_`` into the tail), so their addresses, and the cached graph,
    stay valid.  The previous snapshot's pack is then spent (``view`` set
    to None) and its reader repacks if searched again.  Classic and kd
    views rebuild per-row state under new global statistics, so they
    repack fully (new buffers, a new graph).

Parity: per-row scores are row-local, so packing rows does not change them;
global-id order and the kernels' lowest-id ties reproduce the loop's
segment-major merge; the rerank gathers the same rows into the same
candidate positions.  The loop stays (``search(packed=False)``) as the
reference path and serves the layouts this module rejects.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.executables import ExecutableCache
from repro_torch.core.types import (
    BruteForceConfig,
    FakeWordsConfig,
    KdTreeConfig,
    LexicalLshConfig,
    QuantizedPostings,
    QuantizedStore,
)

__all__ = [
    "PackedUnsupported",
    "PackedSegments",
    "ExecutableCache",
    "EXEC_CACHE",
    "bucket_rows",
    "pack_segments",
    "packed_search",
    "packed_blockmax",
]


class PackedUnsupported(ValueError):
    """This snapshot cannot ride the packed single-launch path (mixed
    per-segment store layouts, per-segment statistics, ...); callers serve
    it through the per-segment loop."""


# --------------------------------------------------------------------------
# Bucket ladder
# --------------------------------------------------------------------------

BUCKET_FLOOR = 256


def bucket_rows(n: int) -> int:
    """Round a row count up the geometric ladder {256, ..., 2^k, 3·2^(k-1), 2^(k+1)}
    (powers of two interleaved with their 1.5x midpoints): at most 50% of
    padding, and every snapshot whose total lands in one rung shares the
    buffers' shapes."""
    if n <= BUCKET_FLOOR:
        return BUCKET_FLOOR
    p = 1 << (n - 1).bit_length()  # next power of two >= n
    mid = 3 * (p // 4)             # 1.5 * the previous power of two
    return mid if mid >= n else p


def _append_block(n: int, room: int = 1 << 30) -> int:
    """The rows an appended block is padded to: a power of two, so appends
    recur in a few block shapes.  Near the top of the bucket the preferred
    rung may overhang the remaining ``room`` though the rows fit; it halves
    down to the largest rung that fits (>= 8 rows).  Returns 0 when no
    rung holds ``n`` rows in ``room`` (the caller repacks fully)."""
    block = max(128, 1 << (n - 1).bit_length())
    while block > room and block >= 16:
        block //= 2
    if block > room or block < n:
        return 0
    return block


# --------------------------------------------------------------------------
# Leaf packing
# --------------------------------------------------------------------------


def _cat_pad(parts: Sequence[torch.Tensor], rows: int) -> torch.Tensor:
    """Per-segment per-doc leaves concatenated along rows into a new buffer
    of ``rows`` rows whose tail is zero.  The zero tail matters: pad rows
    are masked at search time, and the in-place append writes over them."""
    n = sum(p.shape[0] for p in parts)
    if n > rows:
        raise PackedUnsupported(f"segment rows {n} exceed bucket {rows}")
    out = torch.zeros((rows,) + tuple(parts[0].shape[1:]), dtype=parts[0].dtype,
                      device=parts[0].device)
    at = 0
    for p in parts:
        out[at:at + p.shape[0]].copy_(p)
        at += p.shape[0]
    return out


def _all_or_none(views: Sequence[Any], name: str) -> Optional[List[Any]]:
    vals = [getattr(v, name) for v in views]
    if all(v is None for v in vals):
        return None
    if any(v is None for v in vals):
        raise PackedUnsupported(
            f"mixed per-segment presence of {name!r} (some segments carry it, some do "
            "not): per-segment loop only")
    return vals


def _pack_vq(views: Sequence[Any], rows: int) -> Optional[QuantizedStore]:
    vqs = _all_or_none(views, "vq")
    if vqs is None:
        return None
    return QuantizedStore(q=_cat_pad([s.q for s in vqs], rows),
                          scale=_cat_pad([s.scale for s in vqs], rows))


def _pack_pq(views: Sequence[Any], rows: int) -> Optional[QuantizedPostings]:
    pqs = _all_or_none(views, "pq")
    if pqs is None:
        return None
    meta = {(p.bits, p.group, p.cols, tuple(p.q.shape[1:])) for p in pqs}
    if len(meta) > 1:
        raise PackedUnsupported(f"segments disagree on quantized-postings layout: "
                                f"{sorted(meta)}")
    return dataclasses.replace(pqs[0], q=_cat_pad([p.q for p in pqs], rows),
                               scale=_cat_pad([p.scale for p in pqs], rows))


def _packed_view(config, views: Sequence[Any], rows: int):
    """One index view with every per-doc leaf packed to ``rows`` rows; the
    global leaves carry over from the stat views (fake words' df / idf as
    copies of their own, which the in-place append updates)."""
    v0 = views[0]
    repl: Dict[str, Any] = {"vq": _pack_vq(views, rows)}
    if isinstance(config, FakeWordsConfig):
        repl["pq"] = _pack_pq(views, rows)
        repl["norm"] = _cat_pad([v.norm for v in views], rows)
        repl["df"], repl["idf"] = v0.df.clone(), v0.idf.clone()
        for name in ("tf", "scored", "vectors"):
            vals = _all_or_none(views, name)
            repl[name] = None if vals is None else _cat_pad(vals, rows)
        return dataclasses.replace(v0, **repl)
    if isinstance(config, LexicalLshConfig):
        repl["sig"] = _cat_pad([v.sig for v in views], rows)
        vecs = _all_or_none(views, "vectors")
        repl["vectors"] = None if vecs is None else _cat_pad(vecs, rows)
        return dataclasses.replace(v0, **repl)
    if isinstance(config, KdTreeConfig):
        from repro_torch.kernels.fused_topk import ops as fused

        repl["reduced"] = _cat_pad([v.reduced for v in views], rows)
        repl["lifted"] = _cat_pad(
            [v.lifted if v.lifted is not None else fused.lift_l2(v.reduced) for v in views],
            rows)
        repl["split_dim"] = repl["split_val"] = repl["perm"] = None
        vecs = _all_or_none(views, "vectors")
        repl["vectors"] = None if vecs is None else _cat_pad(vecs, rows)
        return dataclasses.replace(v0, **repl)
    if isinstance(config, BruteForceConfig):
        repl["pq"] = _pack_pq(views, rows)
        vecs = _all_or_none(views, "vectors")
        repl["vectors"] = None if vecs is None else _cat_pad(vecs, rows)
        if repl["vectors"] is None and repl["pq"] is None:
            raise PackedUnsupported("brute-force segments carry neither vectors nor postings")
        return dataclasses.replace(v0, **repl)
    raise PackedUnsupported(f"no packed layout for config type {type(config).__name__}")


def _doc_leaf_paths(config, view) -> List[Tuple[str, ...]]:
    """Attribute paths of every per-doc leaf present on a packed view (the
    leaves the in-place append writes)."""
    names = {
        FakeWordsConfig: ("tf", "scored", "norm", "vectors"),
        LexicalLshConfig: ("sig", "vectors"),
        KdTreeConfig: ("reduced", "lifted", "vectors"),
        BruteForceConfig: ("vectors",),
    }[type(config)]
    paths: List[Tuple[str, ...]] = [(n,) for n in names if getattr(view, n, None) is not None]
    for store in ("vq", "pq"):
        if getattr(view, store, None) is not None:
            paths += [(store, "q"), (store, "scale")]
    return paths


def _get_path(view, path: Tuple[str, ...]):
    x = view
    for p in path:
        x = getattr(x, p)
    return x


def _replace_paths(view, updates: Dict[Tuple[str, ...], torch.Tensor]):
    """Rebuild a view with the given (possibly nested) leaves replaced."""
    top: Dict[str, Any] = {}
    nested: Dict[str, Dict[str, Any]] = {}
    for path, val in updates.items():
        if len(path) == 1:
            top[path[0]] = val
        else:
            nested.setdefault(path[0], {})[path[1]] = val
    for store, fields in nested.items():
        top[store] = dataclasses.replace(getattr(view, store), **fields)
    return dataclasses.replace(view, **top)


# --------------------------------------------------------------------------
# Executable cache
# --------------------------------------------------------------------------

#: Process-wide cache shared by every packed reader (snapshots of one
#: writer land in the same rungs, so sharing is the point).
EXEC_CACHE = ExecutableCache()


# --------------------------------------------------------------------------
# Packed snapshot state
# --------------------------------------------------------------------------


@dataclasses.dataclass
class PackedSegments:
    """One snapshot's packed superbuffer and the mask that makes it exact.

    ``view`` is an index view of ``bucket`` rows: rows [0, n_rows) are the
    segments' rows in global-id order, rows [n_rows, bucket) zeros.
    ``live`` is liveDocs ∧ row < n_rows, the one bitmap the kernels take.
    ``view`` is None once an in-place append has spent the buffers; the
    view object travels with the buffers through every in-place append, and
    a full pack makes a new one, so it owns their cache entries."""

    view: Any
    bucket: int
    n_rows: int                    # reader.max_doc (deleted rows included)
    n_live: int                    # reader.num_docs (live rows only)
    live: Optional[torch.Tensor]   # (bucket,) bool: live ∧ row < n_rows
    any_deleted: bool
    seg_names: Tuple[str, ...]
    seg_rows: Tuple[int, ...]
    appends: int = 0               # in-place appends absorbed
    bm_cache: Dict[int, Any] = dataclasses.field(default_factory=dict)

    @property
    def full(self) -> bool:
        """No pad rows and no deletes: no mask at all, the monolithic call."""
        return (not self.any_deleted) and self.n_rows == self.bucket


def _stats_static(config) -> bool:
    """Encodings whose stat views keep per-doc leaves as built across
    refreshes (only global leaves move), so an append-only refresh can
    write into the prior buffers.  Classic fake words rebuild ``scored`` /
    ``pq`` under the new idf, and the kd reduction refits: both repack."""
    if isinstance(config, (LexicalLshConfig, BruteForceConfig)):
        return True
    return isinstance(config, FakeWordsConfig) and config.scoring != "classic"


def _global_leaf_updates(config, views) -> Dict[Tuple[str, ...], torch.Tensor]:
    """Global leaves an append refreshes from the new stat views: dot-mode
    fake words re-derive df / idf over the new live set."""
    if isinstance(config, FakeWordsConfig):
        return {("df",): views[0].df, ("idf",): views[0].idf}
    return {}


def _live_bitmap(segments, bucket: int) -> np.ndarray:
    """The segments' liveDocs in global-id order, False past the last row."""
    live = np.zeros(bucket, bool)
    base = 0
    for s in segments:
        live[base:base + s.num_docs] = s.live
        base += s.num_docs
    return live


def _try_append(config, views, prior: PackedSegments, names: Tuple[str, ...],
                rows: Tuple[int, ...], bucket: int, n_rows: int,
                live_np: np.ndarray, n_live: int) -> Optional[PackedSegments]:
    """Absorb an append-only refresh into the prior snapshot's buffers in
    place; None when it does not qualify (the caller repacks fully)."""
    k = len(prior.seg_names)
    if not (_stats_static(config) and bucket == prior.bucket and len(names) > k
            and names[:k] == prior.seg_names and rows[:k] == prior.seg_rows):
        return None
    offset = prior.n_rows
    block = _append_block(n_rows - offset, room=bucket - offset)
    if not block:
        return None  # no rung fits in the room left: never write past the bucket
    paths = _doc_leaf_paths(config, prior.view)
    new_view = _packed_view(config, views[k:], block)
    old = [_get_path(prior.view, p) for p in paths]
    new = [_get_path(new_view, p) for p in paths]
    if any(o.shape[1:] != n.shape[1:] or o.dtype != n.dtype for o, n in zip(old, new)):
        return None
    for o, n in zip(old, new):
        o[offset:offset + block].copy_(n)
    for path, val in _global_leaf_updates(config, views).items():
        _get_path(prior.view, path).copy_(val)
    live = prior.live
    live.copy_(torch.from_numpy(live_np))
    view = prior.view
    # The prior snapshot's buffers now hold this one's rows: spend it, so a
    # stale reader repacks instead of searching them.
    prior.view = prior.live = None
    return PackedSegments(
        view=view, bucket=bucket, n_rows=n_rows, n_live=n_live, live=live,
        any_deleted=n_live < n_rows, seg_names=names, seg_rows=rows,
        appends=prior.appends + 1)


def pack_segments(config, views: Sequence[Any], segments: Sequence[Any],
                  global_stats: bool = True,
                  prior: Optional[PackedSegments] = None) -> PackedSegments:
    """Pack a snapshot's stat views into one superbuffer, in place of the
    prior snapshot's when the refresh only appended (:func:`_try_append`).
    Raises :class:`PackedUnsupported` for layouts one launch cannot serve
    exactly (per-segment statistics, mixed store presence)."""
    if not segments:
        raise PackedUnsupported("no segments to pack")
    if not global_stats and not isinstance(config, (LexicalLshConfig, BruteForceConfig)):
        raise PackedUnsupported(
            "global_stats=False scores each segment under its own statistics: one packed "
            "launch cannot reproduce per-segment query operands")
    names = tuple(s.name for s in segments)
    rows = tuple(s.num_docs for s in segments)
    n_rows = sum(rows)
    bucket = bucket_rows(n_rows)
    live_np = _live_bitmap(segments, bucket)
    n_live = int(live_np.sum())
    if prior is not None and prior.view is not None:
        inc = _try_append(config, views, prior, names, rows, bucket, n_rows, live_np, n_live)
        if inc is not None:
            return inc
    view = _packed_view(config, views, bucket)
    # The view object carries the buffers through every in-place append:
    # when it is freed, so are the graphs captured over them.
    return PackedSegments(
        view=view, bucket=bucket, n_rows=n_rows, n_live=n_live,
        live=torch.from_numpy(live_np).to(view.device), any_deleted=n_live < n_rows,
        seg_names=names, seg_rows=rows)


# --------------------------------------------------------------------------
# Blockmax over the packed view
# --------------------------------------------------------------------------


def packed_blockmax(pk: PackedSegments, config, block_size: int):
    """A BlockMaxIndex over the packed view (the packed view is a
    monolithic index, so the builder applies as it is).  Pad and deleted
    rows may raise stage-1 bounds (still admissible); stage 2 masks them
    through the live bitmap.  Cached per block size on the snapshot."""
    bm = pk.bm_cache.get(block_size)
    if bm is None:
        from repro_torch.core import blockmax

        mode = "lsh" if isinstance(config, LexicalLshConfig) else config.scoring
        bm = blockmax.build_blockmax(pk.view, block_size, mode=mode)
        pk.bm_cache[block_size] = bm
    return bm


# --------------------------------------------------------------------------
# The single-launch search
# --------------------------------------------------------------------------


def _pad_mask_cols(fm: torch.Tensor, bucket: int) -> torch.Tensor:
    """A (n_rows,) / (B, n_rows) bool predicate bitmap padded with False to
    the bucket's width (pad rows are never kept)."""
    pad = bucket - fm.shape[-1]
    if pad == 0:
        return fm.contiguous()
    return torch.nn.functional.pad(fm, (0, pad), value=False)


def packed_search(
    pk: PackedSegments,
    pipeline,
    matcher,
    q_norm: torch.Tensor,
    k: int,
    depth: int,
    rerank: bool,
    quantized: bool,
    fm: Optional[torch.Tensor] = None,
    n_keep: Optional[int] = None,
    bm=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """ONE launch of the match kernels (and the rerank) for the whole
    segmented snapshot, through the executable cache.

    Mask choice: ``pk.full`` and no predicate, no mask (the monolithic
    call); otherwise liveDocs ∧ row validity [∧ predicate] as the kernels'
    ``filt`` operand, so the key does not change as rows are appended.

    ``fm`` is a (n_rows,) / (B, n_rows) bool predicate on global ids.  The
    output is (scores (B, k_out), ids (B, k_out)), ``k_out = min(k,
    depth, live docs)``, the loop's width."""
    if pk.view is None:
        raise ValueError("this packed snapshot was spent by an in-place append")
    bucket = pk.bucket
    d_eff = min(depth, pk.n_live)
    k_out = min(k, d_eff)
    if k_out <= 0:
        raise ValueError("packed search over zero live docs")
    q_rep = pipeline.encoder(pk.view, q_norm)
    use_filt = (fm is not None) or not pk.full
    fm_arg = None if fm is None else _pad_mask_cols(fm, bucket)

    def build():
        from repro_torch.core import bruteforce
        from repro_torch.core import pipeline as pl

        def fn(view, live, bm_in, q_rep_in, q_norm_in, fm_in):
            filt = None
            if use_filt:
                filt = live if fm_in is None else (
                    fm_in & (live if fm_in.dim() == 1 else live[None, :]))
            if n_keep is not None:
                s, i = pl.BlockMaxMatcher(min(n_keep, bm_in.num_blocks), bm_in)(
                    view, q_rep_in, d_eff, filt=filt)
            else:
                s, i = matcher(view, q_rep_in, d_eff, filt=filt)
            if rerank:
                safe = i.clamp_min(0).long()
                store = view.vq if quantized else None
                cand = store.q[safe] if quantized else view.vectors[safe]
                return bruteforce.rerank_gathered(
                    q_norm_in, cand, i, k_out, scale=store.scale[safe] if quantized else None)
            return s[:, :k_out], i[:, :k_out]
        return fn

    key = ("search", matcher, d_eff, k_out, rerank, quantized, use_filt, n_keep)
    resident, fed = (pk.view, pk.live, bm), (q_rep, q_norm, fm_arg)
    return EXEC_CACHE.get(key, pk.view, build, resident, fed)(resident, fed)
