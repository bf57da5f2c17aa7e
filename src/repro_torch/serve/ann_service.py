"""Batched ANN query service over any AnnIndex, single-device or segmented
(near-real-time): port of ``repro/serve/ann_service.py``.

A query stream is micro-batched (padded to ``max_batch``), encoded through
the index's pipeline encoder (tf row / MinHash signature / reduced point /
identity) and searched through the same staged pipeline as
``AnnIndex.search`` (:func:`repro_torch.core.pipeline.match_rerank`), or
across the segments of a :class:`repro_torch.core.segments.
SegmentedAnnIndex` (its packed single launch, or the per-segment loop).
Every encoding serves through one code path.  The search runs on the
index's device: on the card, the kernels; results go to callers as numpy.

``AnnServiceConfig.cache_size`` turns on an LRU result cache keyed on the
encoded query's bytes (copied to the host), the knobs and the index's
**epoch** (:func:`repro_torch.core.types.next_epoch`), so a refresh or a
:meth:`AnnService.set_index` swap can never serve another snapshot's
results.  Construct with ``writer=`` (an :class:`repro_torch.core.segments.
IndexWriter`) and call :meth:`AnnService.refresh` after ingesting: the
service re-points at the writer's latest NRT snapshot.

:meth:`AnnService.start_async` runs a micro-batcher on a worker thread:
:meth:`AnnService.search_async` admits single queries (``queue.Full`` past
``queue_depth``), and the worker coalesces them into one launch once the
batch reaches ``max_batch`` rows or the oldest request has waited
``max_wait_s``.  A search that captures a CUDA graph on the worker while
caller threads write to the card is safe: every capture runs in
``thread_local`` mode (:func:`repro_torch.core.executables.capture`).

``mesh=`` / ``shard_axes=`` serve a monolithic ``AnnIndex`` split over a
device mesh (:mod:`repro_torch.core.distributed`): each batch fans out to
the shards (their match, blockmax and rerank on their own rows) and the
coordinator merges.  An index built with ``mesh=`` is served as it is split;
a monolithic one is split once, at bind.  The sharded path takes a shared
(N,) filter only, and a segmented index refuses a mesh.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import queue as queue_mod
import threading
import time
from concurrent.futures import Future
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import blockmax, bruteforce, distributed
from repro_torch.core import packed as packed_mod
from repro_torch.core import pipeline as pl
from repro_torch.core.index import AnnIndex, AnyConfig, AnyIndex
from repro_torch.core.segments import IndexWriter, SegmentedAnnIndex
from repro_torch.core.types import FakeWordsConfig, FakeWordsIndex, LexicalLshConfig, LshIndex

# Integer views of the dtypes numpy has no name for (bytes unchanged).
_BITS_VIEW = {torch.uint32: torch.int32, torch.bfloat16: torch.int16}


def _host(x) -> np.ndarray:
    """A caller's array or a tensor (any device) as numpy, bytes unchanged:
    uint32 (MinHash signatures) and bf16 go through their integer bits."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    x = x.detach()
    if x.dtype in _BITS_VIEW:
        x = x.view(_BITS_VIEW[x.dtype])
    return x.contiguous().cpu().numpy()


def _pad_rows(x, pad: int):
    """``x`` with ``pad`` zero rows appended (numpy or tensor)."""
    if isinstance(x, torch.Tensor):
        return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))], 0)
    return np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)], 0)


@dataclasses.dataclass
class AnnServiceConfig:
    k: int = 10
    depth: int = 100
    rerank: bool = True
    max_batch: int = 64       # micro-batch size (pad to this)
    # Async micro-batcher: a queued request launches once the coalesced
    # batch reaches ``max_batch`` rows OR the OLDEST queued request has
    # waited ``max_wait_s``.  ``queue_depth`` bounds the admission queue;
    # search_async raises queue.Full past it (backpressure).
    max_wait_s: float = 0.002
    queue_depth: int = 256
    # Two-stage blockmax pruning: keep this many blocks per query in the
    # match phase.  None takes the index's own setting.  Fake-words and
    # LSH indexes only (segmented serving prunes over the packed view).
    blockmax_keep: Optional[int] = None
    blockmax_block_size: int = 256
    # Latency ring-buffer length for stats() p50/p99 (per-batch wall times).
    latency_window: int = 1024
    # LRU over the last ``cache_size`` micro-batches, keyed on the encoded
    # query's bytes + the knobs + the index epoch.  0 disables.
    cache_size: int = 0


class AnnService:
    """Single-device, sharded or segmented search service over any
    AnnIndex / SegmentedAnnIndex.  Forms: ``AnnService(ann)``,
    ``AnnService(ann, service_cfg)``, ``AnnService(raw_index,
    method_config, service_cfg)`` and ``AnnService(writer=w,
    service=service_cfg)``; ``mesh=`` (with ``shard_axes``, by default the
    sharded index's own axes, else every mesh axis) serves over a device
    mesh."""

    def __init__(
        self,
        index: Union[AnnIndex, SegmentedAnnIndex, AnyIndex, None] = None,
        config: Optional[AnyConfig] = None,
        service: Optional[AnnServiceConfig] = None,
        mesh: Optional[distributed.Mesh] = None,
        shard_axes: Sequence[str] = (),
        writer: Optional[IndexWriter] = None,
    ):
        if writer is not None:
            if index is not None:
                raise ValueError("pass index= or writer=, not both")
            index = writer.refresh()
        self.writer = writer
        if index is None:
            raise ValueError("AnnService needs an index or a writer")
        if isinstance(index, (AnnIndex, SegmentedAnnIndex)):
            if service is None and isinstance(config, AnnServiceConfig):
                config, service = None, config
            if config is not None and config != index.config:
                raise ValueError(
                    "method config passed alongside an AnnIndex disagrees with the index's "
                    f"own config ({config} != {index.config})")
            ann = index
        else:
            ann = AnnIndex(config=config, index=index)
        self.scfg = service if service is not None else AnnServiceConfig()
        self.mesh = mesh
        self.shard_axes = tuple(shard_axes)
        # One lock covers every snapshot swap (_bind) and every search: the
        # async worker thread and caller threads share this service.
        self._lock = threading.RLock()
        self._bind(ann)
        self.queries_served = 0
        self.batches = 0
        self._lat_s = collections.deque(maxlen=self.scfg.latency_window)
        # Per-REQUEST enqueue -> result wall times of the async path, apart
        # from the per-batch ring (queue wait included).
        self._req_lat_s = collections.deque(maxlen=self.scfg.latency_window)
        self._cache: "collections.OrderedDict[bytes, Tuple[np.ndarray, np.ndarray]]" = (
            collections.OrderedDict())
        self.cache_hits = 0
        self.cache_misses = 0
        self.async_launches = 0
        self.rejected = 0
        self._queue: Optional["queue_mod.Queue"] = None
        self._worker: Optional[threading.Thread] = None

    def _bind(self, ann: Union[AnnIndex, SegmentedAnnIndex]) -> None:
        """Point the service at a searchable snapshot and derive the
        effective serving knobs (the service config's, else the index's).
        The snapshot's epoch in the cache key keeps earlier results
        unreachable."""
        self.ann = ann
        self.index = getattr(ann, "index", ann)
        self.config = ann.config
        self.device = ann.device
        self._segmented = isinstance(ann, SegmentedAnnIndex)
        if self.scfg.blockmax_keep is not None:
            self._bm_keep = self.scfg.blockmax_keep
            self._bm_block = self.scfg.blockmax_block_size
        else:
            self._bm_keep = getattr(ann, "blockmax_keep", None)
            self._bm_block = getattr(ann, "blockmax_block_size", 256)
        self._bm = None
        self._search = self._search_filtered = None
        if self._segmented:
            if self.mesh is not None:
                raise ValueError("segmented serving is single-process; shard the corpus with "
                                 "mesh= over a monolithic index instead")
            # Segmented blockmax rides the packed view, built per snapshot
            # inside its search.
            if self._bm_keep is not None and not isinstance(
                    ann.config, (FakeWordsConfig, LexicalLshConfig)):
                raise ValueError(f"blockmax pruning is not supported for {ann.method}")
            return
        if self.mesh is not None:
            self._bind_sharded(ann)
            return
        if self._bm_keep is not None:
            if not isinstance(ann.index, (FakeWordsIndex, LshIndex)):
                raise ValueError(f"blockmax pruning is not supported for {ann.method}")
            if ann.bm is not None and ann.bm.block_size == self._bm_block:
                self._bm = ann.bm
            else:
                self._bm = blockmax.build_blockmax(ann.index, self._bm_block)

    def _bind_sharded(self, ann: AnnIndex) -> None:
        """The sharded search over ``ann``: its own split (an index built
        with ``mesh=``), else ``ann.index`` split once over the mesh; the
        shards' own block bounds for blockmax; the rerank store the index
        carries; the packed postings' bits; and the filtered variant."""
        index = ann.index
        if isinstance(index, distributed.ShardedIndex):
            axes = self.shard_axes or index.axes
            if axes != index.axes:
                index = distributed.shard_index(self.mesh, distributed.gather(index), axes)
        else:
            axes = self.shard_axes or self.mesh.axis_names
            index = distributed.shard_index(self.mesh, index, axes)
        self.index, local = index, distributed.first_shard(index)
        self.device = index.device
        if self._bm_keep is not None:
            if not isinstance(local, (FakeWordsIndex, LshIndex)):
                raise ValueError(f"blockmax pruning is not supported for {ann.method}")
            if (isinstance(ann.bm, distributed.ShardedIndex) and ann.index is index
                    and ann.bm.shards[0].block_size == self._bm_block):
                self._bm = ann.bm
            else:
                self._bm = distributed.build_blockmax_sharded(self.mesh, index, axes,
                                                              self._bm_block)
        pq = getattr(local, "pq", None)
        knobs = dict(k=self.scfg.k, depth=self.scfg.depth, rerank=self.scfg.rerank,
                     blockmax_keep=self._bm_keep, rerank_store=ann.rerank_store(),
                     postings_bits=0 if pq is None else pq.bits)
        self._search = distributed.make_sharded_search(self.mesh, ann.config, axes, **knobs)
        self._search_filtered = distributed.make_sharded_search(
            self.mesh, ann.config, axes, filtered=True, **knobs)

    # -- online index updates ----------------------------------------------

    def set_index(self, index: Union[AnnIndex, SegmentedAnnIndex]) -> int:
        """Serve a new snapshot; returns its epoch.  The old snapshot's
        cached results become unreachable (no eviction sweep)."""
        if not isinstance(index, (AnnIndex, SegmentedAnnIndex)):
            raise TypeError("set_index takes an AnnIndex or SegmentedAnnIndex")
        with self._lock:
            self._bind(index)
        return self.ann.epoch

    def refresh(self) -> int:
        """Near-real-time visibility: serve the writer's latest snapshot
        (flushing its buffered adds).  Returns the serving epoch, unchanged
        when the writer had nothing new (the cache stays warm)."""
        if self.writer is None:
            raise ValueError("refresh() needs a service constructed with writer=")
        with self._lock:
            self._bind(self.writer.refresh())
        return self.ann.epoch

    # -- serving -----------------------------------------------------------

    def _matcher(self):
        """The effective match stage for single-device serving."""
        return self.ann.matcher_for(self._bm, self._bm_keep)

    def _cache_key(self, q_rep, q, filt=None) -> bytes:
        """Result-cache key: the encoded query's bytes plus every knob that
        changes the result, the index epoch included.  When reranking the
        normalized queries join the hash (distinct queries can share a tf
        row or a signature, and their exact scores differ); a filter's
        bytes join it too, with a presence flag, so an all-ones mask never
        aliases the unfiltered entry.  Device tensors are copied to the
        host for it: a sync on the encoder, paid only with the cache on."""
        h = hashlib.sha1(_host(q_rep).tobytes())
        if self.scfg.rerank and q is not None:
            h.update(_host(q).tobytes())
        if filt is not None:
            h.update(_host(filt).tobytes())
        h.update(repr((self.scfg.k, self.scfg.depth, self.scfg.rerank, self._bm_keep,
                       self._bm_block, self.ann.epoch, filt is not None)).encode())
        return h.digest()

    def search_batch(self, queries, filter=None, plan=None) -> Tuple[np.ndarray, np.ndarray]:
        """(B, dim) -> (scores (B, k), ids (B, k)) as numpy; batches are
        padded to ``max_batch`` with zero rows (trimmed from the output).

        ``filter``: per-doc keep bitmap (nonzero = keep; numpy or tensor),
        (N,) shared or (B, N) per query, applied inside the match stage.
        Segmented indexes take GLOBAL doc ids (``ann.global_metadata()``).
        Its bytes join the cache key.

        ``plan``: a composed query plan (:mod:`repro_torch.core.plan`) run
        as one batch in place of this service's own search; its leaves
        carry their own filters and indexes.  Plan results bypass the
        cache."""
        with self._lock:
            return self._search_batch(queries, filter, plan)

    def _search_batch(self, queries, filter=None, plan=None) -> Tuple[np.ndarray, np.ndarray]:
        b = queries.shape[0]
        if plan is not None:
            if filter is not None:
                raise ValueError("pass filters on the plan's leaves, not alongside plan=")
            t0 = time.perf_counter()
            s, ids = plan.run(torch.as_tensor(queries, device=self.device))
            s_np, i_np = _host(s), _host(ids)  # results go to callers as numpy
            self.batches += 1
            self._lat_s.append(time.perf_counter() - t0)
            self.queries_served += b
            return s_np, i_np
        mb = self.scfg.max_batch
        pad = (-b) % mb
        if pad:
            queries = _pad_rows(queries, pad)
        fm = filter
        if fm is not None and len(fm.shape) == 2 and self.mesh is not None:
            raise ValueError("sharded filtered serving takes a shared (N,) mask (it shards with "
                             "the postings); per-query (B, N) masks are single-device/segmented "
                             "only")
        if fm is not None and len(fm.shape) == 2 and pad:
            # Pad queries get all-zero mask rows; their (-inf, -1) rows are
            # trimmed with the batch below.
            fm = _pad_rows(fm, pad)
        use_cache = self.scfg.cache_size > 0
        out_s, out_i = [], []
        for i in range(0, queries.shape[0], mb):
            t0 = time.perf_counter()
            q_in = queries[i : i + mb]
            fl = fm if fm is None or len(fm.shape) == 1 else fm[i : i + mb]
            if self._segmented:
                # The reader encodes per search (its stat view owns any
                # fitted model): key on the raw query bytes; the epoch in
                # the key still pins the snapshot.
                key = self._cache_key(q_in, None, fl) if use_cache else None
                q = q_rep = None
            else:
                q = bruteforce.l2_normalize(torch.as_tensor(q_in, device=self.device))
                q_rep = self.ann.pipeline.encoder(distributed.first_shard(self.index), q)
                key = self._cache_key(q_rep, q, fl) if use_cache else None
            if use_cache and key in self._cache:
                self._cache.move_to_end(key)
                s_np, i_np = self._cache[key]
                self.cache_hits += 1
            else:
                if self._segmented:
                    s, ids = self.ann.search(
                        torch.as_tensor(q_in, device=self.device), k=self.scfg.k,
                        depth=self.scfg.depth, rerank=self.scfg.rerank, filter_mask=fl,
                        blockmax_keep=self._bm_keep, blockmax_block_size=self._bm_block)
                elif self._search is not None:
                    args = (self.index,) + ((self._bm,) if self._bm is not None else ()) + (
                        q_rep, q)
                    s, ids = (self._search(*args) if fl is None
                              else self._search_filtered(*args, fl))
                else:
                    filt = pl.as_filter(fl, self.ann.num_docs, q.shape[0], self.device)
                    s, ids = pl.match_rerank(
                        self._matcher(), self.ann.index, q_rep, q, self.scfg.k,
                        self.scfg.depth, self.scfg.rerank,
                        reranker=self.ann.pipeline.reranker, filt=filt)
                # The hand-off copies block, so the device work stays inside
                # the wall time recorded below.
                s_np, i_np = _host(s), _host(ids)
                if use_cache:
                    self.cache_misses += 1
                    self._cache[key] = (s_np, i_np)
                    while len(self._cache) > self.scfg.cache_size:
                        self._cache.popitem(last=False)
            out_s.append(s_np)
            out_i.append(i_np)
            self.batches += 1
            self._lat_s.append(time.perf_counter() - t0)
        self.queries_served += b
        return np.concatenate(out_s)[:b], np.concatenate(out_i)[:b]

    search = search_batch

    # -- async micro-batching loop ------------------------------------------

    def start_async(self) -> None:
        """Start the admission queue and the micro-batcher worker."""
        if self._worker is not None:
            return
        self._queue = queue_mod.Queue(maxsize=self.scfg.queue_depth)
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._batch_loop, name="ann-batcher",
                                        daemon=True)
        self._worker.start()

    def stop_async(self, drain: bool = True) -> None:
        """Stop the worker.  ``drain=True`` serves everything already
        admitted first; pending futures are failed otherwise."""
        if self._worker is None:
            return
        if not drain:
            self._stop.set()
        self._queue.put(None)  # wake the worker
        self._worker.join()
        self._worker = None
        # Fail anything still queued (drain=False, or raced past the
        # sentinel) rather than leaving callers blocked.
        while True:
            try:
                req = self._queue.get_nowait()
            except queue_mod.Empty:
                break
            if req is not None:
                req[3].set_exception(RuntimeError("service stopped"))
        self._queue = None

    def search_async(self, query, filter=None) -> "Future[Tuple[np.ndarray, np.ndarray]]":
        """Admit one query ((dim,) or (b, dim)) to the micro-batcher; the
        future resolves to this request's (scores, ids) rows.  Raises
        ``queue.Full`` when the admission queue holds ``queue_depth``
        requests (backpressure: the caller sheds or retries)."""
        if self._queue is None:
            raise RuntimeError("call start_async() first")
        q = _host(query)
        if q.ndim == 1:
            q = q[None, :]
        fkey = None if filter is None else _host(filter).tobytes()
        fut: "Future[Tuple[np.ndarray, np.ndarray]]" = Future()
        try:
            self._queue.put_nowait((q, filter, fkey, fut, time.perf_counter()))
        except queue_mod.Full:
            with self._lock:  # counters are bumped from any caller thread
                self.rejected += 1
            raise
        return fut

    def _batch_loop(self) -> None:
        carry = None
        while True:
            req = carry if carry is not None else self._queue.get()
            carry = None
            if req is None:
                return
            if self._stop.is_set():
                req[3].set_exception(RuntimeError("service stopped"))
                continue
            batch = [req]
            rows = req[0].shape[0]
            deadline = req[4] + self.scfg.max_wait_s
            # Coalesce until max_batch rows or the OLDEST request's window
            # ends; only same-filter requests share a launch.  Backlog
            # already queued coalesces at once; the deadline only bounds
            # the wait for more.
            while rows < self.scfg.max_batch:
                try:
                    nxt = self._queue.get_nowait()
                except queue_mod.Empty:
                    wait = deadline - time.perf_counter()
                    if wait <= 0:
                        break
                    try:
                        nxt = self._queue.get(timeout=wait)
                    except queue_mod.Empty:
                        break
                if nxt is None or self._stop.is_set():
                    carry = nxt
                    break
                if nxt[2] != req[2]:
                    carry = nxt  # different filter: next launch
                    break
                batch.append(nxt)
                rows += nxt[0].shape[0]
            try:
                qs = np.concatenate([r[0] for r in batch], axis=0)
                s, ids = self.search_batch(qs, filter=req[1])
                done = time.perf_counter()
                # Stats are read by caller threads under the lock; futures
                # resolve outside it (a done-callback may re-enter).
                with self._lock:
                    self.async_launches += 1
                    for r in batch:
                        self._req_lat_s.append(done - r[4])
                off = 0
                for r in batch:
                    n = r[0].shape[0]
                    r[3].set_result((s[off : off + n], ids[off : off + n]))
                    off += n
            except Exception as e:  # every caller in the batch gets the error; no retry
                for r in batch:
                    if not r[3].done():
                        r[3].set_exception(e)

    def reset_latency(self) -> None:
        """Drop recorded latencies (e.g. after a warm-up batch that
        compiled or captured), not the counts."""
        with self._lock:
            self._lat_s.clear()
            self._req_lat_s.clear()

    @staticmethod
    def _pcts(ring) -> Tuple[Optional[float], Optional[float]]:
        ms = np.asarray(ring, np.float64) * 1e3
        if not ms.size:
            return None, None
        return (round(float(np.percentile(ms, 50)), 3),
                round(float(np.percentile(ms, 99)), 3))

    def _packed_stats(self) -> dict:
        """The packed path's executable-cache counters and this snapshot's
        bucket occupancy; never forces a pack."""
        out = {f"exec_cache_{k}": v for k, v in packed_mod.EXEC_CACHE.stats().items()}
        pk = getattr(self.ann, "_packed", None)
        if pk is not None:
            out["packed_bucket"] = pk.bucket
            out["packed_rows"] = pk.n_rows
            out["packed_live"] = pk.n_live
            out["packed_occupancy"] = round(pk.n_rows / pk.bucket, 4)
            out["packed_appends"] = pk.appends
        else:
            out["packed_bucket"] = None
            err = getattr(self.ann, "_packed_err", None)
            if err is not None:
                out["packed_unsupported"] = err
        return out

    def stats(self) -> dict:
        with self._lock:
            lat_p50, lat_p99 = self._pcts(self._lat_s)
            req_p50, req_p99 = self._pcts(self._req_lat_s)
            return {
                "queries": self.queries_served,
                "batches": self.batches,
                "index_bytes": self.ann.nbytes(),
                "num_docs": self.ann.num_docs,
                "method": self.ann.method,
                "epoch": self.ann.epoch,
                "segments": getattr(self.ann, "num_segments", None),
                # per-BATCH wall times (one search_batch chunk each)
                "lat_p50_ms": lat_p50,
                "lat_p99_ms": lat_p99,
                # per-REQUEST enqueue -> result times of the async path
                "req_p50_ms": req_p50,
                "req_p99_ms": req_p99,
                "async_launches": self.async_launches,
                "rejected": self.rejected,
                "queue_depth": self._queue.qsize() if self._queue is not None else 0,
                "cache_hits": self.cache_hits,
                "cache_misses": self.cache_misses,
                "cache_entries": len(self._cache),
                **self._packed_stats(),
            }
