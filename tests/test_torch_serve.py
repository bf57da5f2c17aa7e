"""The port's serving layer (``repro_torch.serve.ann_service``: the sync
service, async micro-batching, the epoch-keyed result cache, NRT refresh)
on the CPU route, against the port's own facade and against the JAX
package's ``AnnService`` (``use_kernel=False``, its plain XLA path).

Mirrors the reference's serving cases: ``tests/test_pipeline.py``'s
``test_ann_service_*``, ``tests/test_serve.py``'s ANN cases,
``tests/test_builder.py``'s service cases and ``tests/test_segments.py``'s
epoch-keyed serving cases; the one left out is ``test_segments.py``'s
``mesh=`` case (doc-sharded serving is not ported).

Tolerances.  The service against the port's own facade on the same rows:
bit for bit in every mode (on the CPU the f32 modes come out bit-equal
too, though the service pads to ``max_batch`` and the facade runs the
unsplit batch).  Against the JAX service, where the JAX index is carried
across by ``save`` -> ``AnnIndex.load(device="cpu")``: matches without
rerank bit for bit in the integer-scored modes (dot, LSH) and in classic
(its bf16 operands come out the same on both CPU routes); every reranked
or f32 result under the near-tie rule of ``torch_parity.assert_topk_match`` (scores within
1e-5, ids equal wherever the wanted score is more than that from both
neighbours).  Cache hit and miss counts equal the reference's on the same
stream.
"""
import collections
import dataclasses
import os
import queue as queue_mod
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_topk_match

from repro.core.index import AnnIndex as JAnnIndex
from repro.core.segments import IndexWriter as JIndexWriter
from repro.core.types import BruteForceConfig as JBruteForceConfig
from repro.core.types import FakeWordsConfig as JFakeWordsConfig
from repro.core.types import GraphConfig as JGraphConfig
from repro.core.types import KdTreeConfig as JKdTreeConfig
from repro.core.types import LexicalLshConfig as JLexicalLshConfig
from repro.serve.ann_service import AnnService as JAnnService
from repro.serve.ann_service import AnnServiceConfig as JAnnServiceConfig
from repro_torch.core import bruteforce
from repro_torch.core import eval as ev
from repro_torch.core import fakewords
from repro_torch.core import pipeline as pl
from repro_torch.core import plan as qplan
from repro_torch.core.index import AnnIndex
from repro_torch.core.segments import IndexWriter
from repro_torch.core.types import (
    BruteForceConfig,
    FakeWordsConfig,
    GraphConfig,
    KdTreeConfig,
    LexicalLshConfig,
)
from repro_torch.serve.ann_service import AnnService, AnnServiceConfig

CPU = "cpu"

# (id, port config, JAX config, match-only scores bit-equal to the JAX service's)
ALL_CONFIGS = [
    ("fakewords-classic", FakeWordsConfig(quantization=50), JFakeWordsConfig(quantization=50),
     True),
    ("fakewords-dot", FakeWordsConfig(quantization=50, scoring="dot"),
     JFakeWordsConfig(quantization=50, scoring="dot"), True),
    ("LexicalLshConfig", LexicalLshConfig(buckets=64, hashes=2),
     JLexicalLshConfig(buckets=64, hashes=2), True),
    ("KdTreeConfig", KdTreeConfig(dims=8, backend="scan"), JKdTreeConfig(dims=8, backend="scan"),
     False),
    ("BruteForceConfig", BruteForceConfig(), JBruteForceConfig(), False),
    ("hnsw", GraphConfig(), JGraphConfig(), False),
]
_IDS = [c[0] for c in ALL_CONFIGS]


def _carried(corpus, jcfg, tmp_path, **knobs):
    """The JAX index (plain XLA path) and the port's copy of its arrays."""
    jann = JAnnIndex.build(jnp.asarray(corpus), jcfg, use_kernel=False, **knobs)
    path = str(tmp_path / "j.ann")
    jann.save(path)
    return jann, AnnIndex.load(path, device=CPU)


# -- service == facade over every encoding (test_pipeline.py:40-100) ---------


@pytest.mark.parametrize("cid,cfg,jcfg,exact_match", ALL_CONFIGS, ids=_IDS)
def test_ann_service_matches_ann_index(small_corpus, tmp_path, cid, cfg, jcfg, exact_match):
    """The service returns exactly what the facade returns on the same rows
    (24 queries in 3 padded batches of 8 against one batch of 24, bit for
    bit), and what the JAX service returns: reranked under the near-tie
    rule, match only bit for bit where ``exact_match`` (classic, dot, LSH)
    and under the near-tie rule in the f32 modes (kd scan, brute force,
    hnsw)."""
    jann, ann = _carried(small_corpus, jcfg, tmp_path)
    qs = small_corpus[:24]
    s_direct, i_direct = ann.search(qs, k=10, depth=100, rerank=True)
    svc = AnnService(ann, AnnServiceConfig(k=10, depth=100, rerank=True, max_batch=8))
    s_srv, i_srv = svc.search_batch(qs)
    np.testing.assert_array_equal(i_direct.numpy(), i_srv)
    np.testing.assert_array_equal(s_direct.numpy(), s_srv)
    stats = svc.stats()
    assert stats["queries"] == 24 and stats["method"] == ann.method == jann.method
    jsvc = JAnnService(jann, JAnnServiceConfig(k=10, depth=100, rerank=True, max_batch=8,
                                               use_kernel=False))
    assert_topk_match((s_srv, i_srv), jsvc.search_batch(qs), exact=False)
    kw = dict(k=10, depth=100, rerank=False, max_batch=8)
    assert_topk_match(AnnService(ann, AnnServiceConfig(**kw)).search_batch(qs),
                      JAnnService(jann, JAnnServiceConfig(use_kernel=False, **kw)).search_batch(qs),
                      exact=exact_match)


@pytest.mark.parametrize("cid,cfg,jcfg,exact_match", ALL_CONFIGS, ids=_IDS)
def test_zero_pad_rows_stay_finite(small_corpus, cid, cfg, jcfg, exact_match):
    """Pad queries are zero vectors: every encoder takes them without NaN
    (a zero MinHash input, a zero kd point, a zero graph query), and a
    batch of one padded to 8 returns the facade's row."""
    ann = AnnIndex.build(small_corpus, cfg, device=CPU)
    q0 = bruteforce.l2_normalize(torch.zeros((8, small_corpus.shape[1])))
    rep = ann.pipeline.encoder(ann.index, q0)
    if rep.dtype.is_floating_point:
        assert bool(torch.isfinite(rep).all())
    s, i = pl.match_rerank(ann.matcher_for(), ann.index, rep, q0, 10, 100, True)
    assert bool(torch.isfinite(s).all()) and bool(((i >= 0) & (i < ann.num_docs)).all())
    svc = AnnService(ann, AnnServiceConfig(k=10, depth=100, rerank=True, max_batch=8))
    s1, i1 = svc.search_batch(small_corpus[5:6])
    s_d, i_d = ann.search(small_corpus[5:6], k=10, depth=100, rerank=True)
    np.testing.assert_array_equal(i_d.numpy(), i1)
    np.testing.assert_array_equal(s_d.numpy(), s1)


def test_ann_service_raw_index_back_compat(small_corpus):
    """AnnService(raw_index, method_config, service_config) still works."""
    cfg = FakeWordsConfig(quantization=50)
    idx = AnnIndex.build(small_corpus, cfg, device=CPU).index
    svc = AnnService(idx, cfg, AnnServiceConfig(k=5, depth=50, max_batch=16))
    s, ids = svc.search_batch(small_corpus[:16])
    assert ids.shape == (16, 5)
    with pytest.raises(ValueError):  # a config that disagrees with the index's own
        AnnService(AnnIndex(config=cfg, index=idx), FakeWordsConfig(quantization=40))
    with pytest.raises(ValueError):
        AnnService()


def test_ann_service_inherits_index_level_knobs(small_corpus):
    """An AnnIndex carrying its own blockmax knobs serves with them when the
    service config leaves them unset; the service's own knobs win."""
    ann = AnnIndex.build(small_corpus[:512], FakeWordsConfig(quantization=40),
                         blockmax_keep=4, blockmax_block_size=64, device=CPU)
    svc = AnnService(ann, AnnServiceConfig(k=10, depth=50, rerank=False, max_batch=8))
    s_srv, i_srv = svc.search_batch(small_corpus[:8])
    assert svc._bm is ann.bm  # reuses the index's structure, no rebuild
    s_d, i_d = ann.search(small_corpus[:8], k=10, depth=50)
    np.testing.assert_array_equal(i_d.numpy(), i_srv)
    np.testing.assert_array_equal(s_d.numpy(), s_srv)
    svc2 = AnnService(ann, AnnServiceConfig(k=10, depth=50, rerank=False, max_batch=8,
                                            blockmax_keep=2, blockmax_block_size=128))
    assert svc2._bm.block_size == 128 and svc2._bm_keep == 2
    svc2.search_batch(small_corpus[:8])


def test_ann_service_latency_stats(small_corpus):
    svc = AnnService(AnnIndex.build(small_corpus, FakeWordsConfig(quantization=50), device=CPU),
                     AnnServiceConfig(k=10, depth=50, max_batch=8, latency_window=4))
    assert svc.stats()["lat_p50_ms"] is None  # nothing served yet
    svc.search_batch(small_corpus[:48])  # 6 batches through a window of 4
    stats = svc.stats()
    assert stats["batches"] == 6
    assert len(svc._lat_s) == 4  # ring buffer, not unbounded
    assert stats["lat_p50_ms"] > 0 and stats["lat_p99_ms"] >= stats["lat_p50_ms"]
    svc.reset_latency()  # drops latencies, not counts
    assert svc.stats()["lat_p50_ms"] is None and svc.stats()["batches"] == 6


# -- filters and plans through the service ------------------------------------


@pytest.mark.parametrize("form", ["numpy-shared", "numpy-per-query", "metadata-tensors"])
def test_ann_service_filter_matches_facade(small_corpus, form):
    """(N,) and (B, N) keep bitmaps through the padded service equal the
    facade's filtered search, and no masked id comes back: numpy int32
    (nonzero = keep), and bool tensors built from the index's metadata
    (the (B, N) one padded with zero rows inside the service)."""
    rng = np.random.default_rng(3)
    n, b = small_corpus.shape[0], 12
    cat = rng.integers(0, 5, n)
    ann = AnnIndex.build(small_corpus, FakeWordsConfig(quantization=50), metadata={"cat": cat},
                         device=CPU)
    if form == "numpy-shared":
        mask = (rng.random(n) < 0.2).astype(np.int32)
    elif form == "numpy-per-query":
        mask = (rng.random((b, n)) < 0.2).astype(np.int32)
    else:
        mask = torch.stack([ann.metadata.eq_mask("cat", j % 5) for j in range(b)])
    svc = AnnService(ann, AnnServiceConfig(k=10, depth=100, rerank=True, max_batch=8,
                                           cache_size=4))
    s, i = svc.search_batch(small_corpus[:b], filter=mask)
    s_d, i_d = ann.search(small_corpus[:b], k=10, depth=100, rerank=True, filt=mask)
    np.testing.assert_array_equal(i_d.numpy(), i)
    np.testing.assert_array_equal(s_d.numpy(), s)
    keep = np.broadcast_to(np.asarray(mask), (b, n))
    assert all(keep[r, i[r]].all() for r in range(b))
    svc.search_batch(small_corpus[:b])  # unfiltered: its own cache entries
    assert svc.cache_hits == 0 and svc.cache_misses == 4


def test_ann_service_plan_runs_one_batch(small_corpus):
    """``plan=`` runs a composed plan in place of the service's search,
    bypassing the cache; a filter beside it is refused."""
    lex = AnnIndex.build(small_corpus, FakeWordsConfig(quantization=50), device=CPU)
    dense = AnnIndex.build(small_corpus, KdTreeConfig(dims=8, backend="scan"), device=CPU)
    fusion = qplan.FusionStage(plans=(
        qplan.QueryPlan(search=lambda q: lex.search(q, k=10, depth=50)),
        qplan.QueryPlan(search=lambda q: dense.search(q, k=10, depth=50))), k=10)
    svc = AnnService(lex, AnnServiceConfig(k=10, depth=50, max_batch=8, cache_size=4))
    s, i = svc.search_batch(small_corpus[:12], plan=fusion)
    s_p, i_p = fusion.run(torch.as_tensor(small_corpus[:12]))
    np.testing.assert_array_equal(i_p.numpy(), i)
    np.testing.assert_array_equal(s_p.numpy(), s)
    assert svc.cache_misses == 0 and svc.stats()["queries"] == 12
    with pytest.raises(ValueError):
        svc.search_batch(small_corpus[:4], plan=fusion, filter=np.ones(2000, np.int32))


# -- recall, blockmax, async (test_serve.py:103-327) -------------------------


def test_ann_service_recall_and_batching(small_corpus, tmp_path):
    jann, ann = _carried(small_corpus, JFakeWordsConfig(quantization=50), tmp_path)
    svc = AnnService(ann.index, ann.config,
                     AnnServiceConfig(k=10, depth=100, rerank=True, max_batch=16))
    qs = small_corpus[:40]  # not a multiple of max_batch: exercises padding
    s, ids = svc.search_batch(qs)
    assert ids.shape == (40, 10)
    _, gt_i = bruteforce.exact_topk(torch.as_tensor(small_corpus), torch.as_tensor(qs), 10)
    assert float(ev.recall_at(gt_i, torch.as_tensor(ids))) > 0.85
    assert svc.stats()["queries"] == 40
    jsvc = JAnnService(jann, JAnnServiceConfig(k=10, depth=100, rerank=True, max_batch=16,
                                               use_kernel=False))
    assert_topk_match((s, ids), jsvc.search_batch(qs), exact=False)


@pytest.mark.parametrize("cid,cfg,jcfg,exact_match",
                         [c for c in ALL_CONFIGS if c[0] in ("fakewords-classic",
                                                             "fakewords-dot",
                                                             "LexicalLshConfig")],
                         ids=["fakewords-classic", "fakewords-dot", "LexicalLshConfig"])
def test_ann_service_blockmax_pruned(small_corpus, tmp_path, cid, cfg, jcfg, exact_match):
    """Blockmax-pruned serving: every block kept equals the unpruned service
    (bit for bit); half the blocks keep most of the recall; both against
    the JAX service at the same knobs (near-tie rule; matches without
    rerank bit for bit)."""
    jann, ann = _carried(small_corpus, jcfg, tmp_path)
    qs = small_corpus[:24]
    _, gt_i = bruteforce.exact_topk(torch.as_tensor(small_corpus), torch.as_tensor(qs), 10)
    n_blocks = -(-small_corpus.shape[0] // 256)
    out = {}
    for keep in (None, n_blocks, max(1, n_blocks // 2)):
        for rerank in (True, False):
            kw = dict(k=10, depth=100, rerank=rerank, max_batch=16, blockmax_keep=keep)
            got = AnnService(ann, AnnServiceConfig(**kw)).search_batch(qs)
            want = JAnnService(jann, JAnnServiceConfig(use_kernel=False, **kw)).search_batch(qs)
            assert_topk_match(got, want, exact=exact_match and not rerank)
            out[keep, rerank] = got
    for rerank in (True, False):
        np.testing.assert_array_equal(out[None, rerank][1], out[n_blocks, rerank][1])
        np.testing.assert_array_equal(out[None, rerank][0], out[n_blocks, rerank][0])
    if cid == "fakewords-classic":
        r_all = float(ev.recall_at(gt_i, torch.as_tensor(out[n_blocks, True][1])))
        r_half = float(ev.recall_at(gt_i, torch.as_tensor(out[n_blocks // 2, True][1])))
        assert r_all > 0.85 and r_half > 0.3 and r_all >= r_half


def test_ann_service_async_matches_sync(small_corpus):
    """search_async results == search_batch results, request for request,
    and the micro-batcher coalesces singles into fewer launches."""
    ann = AnnIndex.build(small_corpus, FakeWordsConfig(quantization=50), device=CPU)
    svc = AnnService(ann, AnnServiceConfig(k=10, depth=100, rerank=True, max_batch=16,
                                           max_wait_s=0.05))
    qs = small_corpus[:24]
    s_ref, i_ref = svc.search_batch(qs)
    svc.start_async()
    futs = [svc.search_async(qs[i]) for i in range(24)]
    out = [f.result(timeout=30) for f in futs]
    svc.stop_async()
    np.testing.assert_array_equal(i_ref, np.concatenate([o[1] for o in out]))
    np.testing.assert_array_equal(s_ref, np.concatenate([o[0] for o in out]))
    st = svc.stats()
    assert 1 <= st["async_launches"] < 24
    assert st["req_p50_ms"] is not None and st["req_p99_ms"] >= st["req_p50_ms"]
    assert st["rejected"] == 0


def test_ann_service_async_coalesces_by_filter(small_corpus):
    """Only requests with the same filter share a launch: two filters
    interleaved in the queue give per-filter results equal to the sync
    service's."""
    ann = AnnIndex.build(small_corpus, LexicalLshConfig(buckets=64, hashes=2), device=CPU)
    svc = AnnService(ann, AnnServiceConfig(k=5, depth=50, rerank=True, max_batch=8,
                                           max_wait_s=0.05))
    rng = np.random.default_rng(5)
    masks = [(rng.random(2000) < 0.3).astype(np.int32), None]
    qs = small_corpus[:8]
    want = [svc.search_batch(qs, filter=m) for m in masks]
    svc.start_async()
    with svc._lock:  # hold the worker so that every request queues first
        futs = [(j, svc.search_async(qs[j], filter=masks[j % 2])) for j in range(8)]
    got = [(j, f.result(timeout=30)) for j, f in futs]
    svc.stop_async()
    for j, (s, i) in got:
        np.testing.assert_array_equal(want[j % 2][1][j:j + 1], i)
        np.testing.assert_array_equal(want[j % 2][0][j:j + 1], s)
    assert svc.stats()["async_launches"] >= 2


def test_ann_service_async_failure_reaches_every_future(small_corpus):
    """A search that raises on the worker fails every future of its batch
    with that error (no retry), and the worker keeps serving."""
    ann = AnnIndex.build(small_corpus, FakeWordsConfig(quantization=50), device=CPU)
    svc = AnnService(ann, AnnServiceConfig(k=5, depth=50, max_batch=8, max_wait_s=0.05))
    svc.start_async()
    with svc._lock:
        bad = [svc.search_async(small_corpus[j], filter=np.ones(7, np.int32)) for j in range(3)]
    for f in bad:
        with pytest.raises(ValueError, match="filter mask"):
            f.result(timeout=30)
    ok = svc.search_async(small_corpus[0]).result(timeout=30)
    svc.stop_async()
    assert ok[1].shape == (1, 5)


def test_ann_service_async_backpressure(small_corpus):
    """A full admission queue rejects at the door (queue.Full) and counts
    the shed requests in stats()."""
    ann = AnnIndex.build(small_corpus, FakeWordsConfig(quantization=50), device=CPU)
    svc = AnnService(ann, AnnServiceConfig(k=5, depth=50, rerank=False, max_batch=1,
                                           max_wait_s=0.0, queue_depth=2))
    svc.start_async()
    rejected = 0
    futs = []
    with svc._lock:  # the worker blocks on the service lock: the queue backs up
        for i in range(32):
            try:
                futs.append(svc.search_async(small_corpus[i % 8]))
            except queue_mod.Full:
                rejected += 1
    assert rejected >= 1
    for f in futs:
        f.result(timeout=30)
    svc.stop_async()
    assert svc.stats()["rejected"] == rejected
    svc.start_async()
    with svc._lock:
        pending = [svc.search_async(small_corpus[0])]
        svc._stop.set()  # drain=False: what is still queued fails
    svc.stop_async(drain=False)
    with pytest.raises(RuntimeError):
        pending[0].result(timeout=30)


def test_ann_service_counters_under_thread_contention(small_corpus):
    """More caller threads than cores submit to a small admission queue with
    a shortened switch interval: every request is either admitted (and
    served) or counted as rejected, and the served-query and rejection
    counters lose no update."""
    import sys

    ann = AnnIndex.build(small_corpus[:256, :16], LexicalLshConfig(buckets=16, hashes=1),
                         device=CPU)
    svc = AnnService(ann, AnnServiceConfig(k=3, depth=20, rerank=False, max_batch=4,
                                           max_wait_s=0.001, queue_depth=4))
    n_threads, per_thread = 2 * (os.cpu_count() or 4), 30
    futs, shed = [], []
    done = threading.Lock()

    def caller(t):
        mine, rejected = [], 0
        for j in range(per_thread):
            try:
                mine.append(svc.search_async(small_corpus[(t * per_thread + j) % 256, :16]))
            except queue_mod.Full:
                rejected += 1
        with done:
            futs.extend(mine)
            shed.append(rejected)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        svc.start_async()
        threads = [threading.Thread(target=caller, args=(t,)) for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        for f in futs:
            assert f.result(timeout=120)[1].shape == (1, 3)
        svc.stop_async()
    finally:
        sys.setswitchinterval(old)
    st = svc.stats()
    assert len(futs) + sum(shed) == n_threads * per_thread
    assert st["rejected"] == sum(shed) and st["queries"] == len(futs)
    assert len(svc._req_lat_s) == min(len(futs), svc.scfg.latency_window)


def test_ann_service_async_with_nrt_refresh(small_corpus):
    """refresh() (a _bind swap) interleaves safely with the async worker;
    results always come from a coherent snapshot."""
    w = IndexWriter(FakeWordsConfig(quantization=50), merge_policy=None, device=CPU)
    w.add(small_corpus[:500])
    svc = AnnService(writer=w, service=AnnServiceConfig(k=5, depth=50, rerank=False,
                                                        max_batch=8, max_wait_s=0.005))
    svc.start_async()
    futs = [svc.search_async(small_corpus[i]) for i in range(8)]
    w.add(small_corpus[500:600])
    svc.refresh()
    futs += [svc.search_async(small_corpus[i]) for i in range(8, 16)]
    for f in futs:
        s, ids = f.result(timeout=30)
        assert ids.shape == (1, 5) and (ids >= 0).all()
    svc.stop_async()
    assert svc.ann.num_docs == 600


def test_ann_service_segmented_blockmax(small_corpus):
    """Segmented blockmax serving rides the packed superbuffer: keeping
    every block matches the unpruned segmented service bit for bit."""
    w = IndexWriter(FakeWordsConfig(quantization=50), merge_policy=None, device=CPU)
    w.add(small_corpus[:700])
    w.flush()
    w.add(small_corpus[700:1100])
    qs = small_corpus[:16]
    svc = AnnService(writer=w, service=AnnServiceConfig(k=10, depth=100, rerank=True,
                                                        max_batch=16))
    s0, i0 = svc.search_batch(qs)
    reader = svc.ann
    n_blocks = reader.packed_segments().bucket // 256
    svc_bm = AnnService(reader, service=AnnServiceConfig(
        k=10, depth=100, rerank=True, max_batch=16, blockmax_keep=n_blocks,
        blockmax_block_size=256))
    s1, i1 = svc_bm.search_batch(qs)
    np.testing.assert_array_equal(i0, i1)
    np.testing.assert_array_equal(s0, s1)
    st = svc.stats()
    assert st["packed_bucket"] == reader.packed_segments().bucket
    assert st["packed_rows"] == 1100 and st["exec_cache_entries"] >= 1


def test_ann_service_stats_mutations_hold_lock(small_corpus):
    """Every mutation of the shared counters and latency rings (worker
    thread, caller threads, rejections, resets) happens under the service
    lock."""
    violations = []

    class CheckedLock:
        def __init__(self):
            self._lock = threading.RLock()
            self._local = threading.local()

        def __enter__(self):
            self._lock.acquire()
            self._local.depth = getattr(self._local, "depth", 0) + 1
            return self

        def __exit__(self, *exc):
            self._local.depth -= 1
            self._lock.release()

        @property
        def held(self):
            return getattr(self._local, "depth", 0) > 0

    class GuardedDeque(collections.deque):
        def __init__(self, name, lock, maxlen=None):
            super().__init__(maxlen=maxlen)
            self._name = name
            self._guard = lock

        def append(self, x):
            if not self._guard.held:
                violations.append(f"{self._name}.append")
            super().append(x)

        def clear(self):
            if not self._guard.held:
                violations.append(f"{self._name}.clear")
            super().clear()

    guarded_ints = {"async_launches", "rejected", "batches", "queries_served"}

    class GuardedService(AnnService):
        def __setattr__(self, name, value):
            if name in guarded_ints and getattr(self, "_armed", False) and not self._lock.held:
                violations.append(name)
            object.__setattr__(self, name, value)

    ann = AnnIndex.build(small_corpus[:400], FakeWordsConfig(quantization=50), device=CPU)
    svc = GuardedService(ann, AnnServiceConfig(k=5, depth=50, rerank=False, max_batch=4,
                                               max_wait_s=0.005, queue_depth=8))
    lock = CheckedLock()
    svc._lock = lock
    svc._lat_s = GuardedDeque("_lat_s", lock)
    svc._req_lat_s = GuardedDeque("_req_lat_s", lock)
    svc._armed = True

    svc.search_batch(small_corpus[:8])  # sync path
    svc.start_async()
    for f in [svc.search_async(small_corpus[i]) for i in range(4)]:
        f.result(timeout=30)  # worker path
    with svc._lock:  # back the queue up
        rejected = 0
        for i in range(32):
            try:
                svc.search_async(small_corpus[i % 8])
            except queue_mod.Full:
                rejected += 1  # rejection path
    svc.stop_async()
    svc.reset_latency()  # ring-clear path
    assert rejected >= 1
    assert svc.stats()["rejected"] == rejected
    assert violations == []


# -- the result cache (test_builder.py:288-360) -------------------------------


def test_service_honors_quantized_knob_when_both_stores_present(small_corpus, tmp_path):
    """Brute force keeps its fp32 rows (the match operand) beside the int8
    store; the service reranks through the knob's store, as the facade."""
    jann, ann = _carried(small_corpus[:256], JBruteForceConfig(), tmp_path,
                         rerank_store="int8")
    assert ann.index.vectors is not None and ann.quantized_rerank
    svc = AnnService(ann, AnnServiceConfig(k=10, depth=50, rerank=True, max_batch=8))
    s_srv, i_srv = svc.search_batch(small_corpus[:8])
    s_d, i_d = ann.search(small_corpus[:8], k=10, depth=50, rerank=True)
    np.testing.assert_array_equal(i_d.numpy(), i_srv)
    np.testing.assert_array_equal(s_d.numpy(), s_srv)
    jsvc = JAnnService(jann, JAnnServiceConfig(k=10, depth=50, rerank=True, max_batch=8,
                                               use_kernel=False))
    assert_topk_match((s_srv, i_srv), jsvc.search_batch(small_corpus[:8]), exact=False)


def test_ann_service_result_cache_hits_and_counters(small_corpus):
    ann = AnnIndex.build(small_corpus[:512], FakeWordsConfig(quantization=50), device=CPU)
    svc = AnnService(ann, AnnServiceConfig(k=10, depth=50, rerank=True, max_batch=8,
                                           cache_size=4))
    qs = small_corpus[:8]
    s0, i0 = svc.search_batch(qs)
    assert svc.stats()["cache_misses"] == 1 and svc.stats()["cache_hits"] == 0
    s1, i1 = svc.search_batch(qs)  # identical batch -> pure cache hit
    assert svc.stats()["cache_hits"] == 1
    np.testing.assert_array_equal(i0, i1)
    np.testing.assert_array_equal(s0, s1)
    for j in range(6):  # distinct queries miss; the LRU stays at cache_size
        svc.search_batch(small_corpus[8 * (j + 1): 8 * (j + 2)])
    st = svc.stats()
    assert st["cache_misses"] == 7 and st["cache_entries"] <= 4
    svc_off = AnnService(ann, AnnServiceConfig(k=10, depth=50, rerank=True, max_batch=8))
    s2, i2 = svc_off.search_batch(qs)
    np.testing.assert_array_equal(i1, i2)
    assert svc_off.stats()["cache_entries"] == 0


def test_ann_service_cache_respects_rerank_on_rep_collisions(small_corpus):
    """Two distinct raw queries can share a quantized tf row; with rerank on
    the cache must NOT serve one query's exact scores for the other."""
    ann = AnnIndex.build(small_corpus[:256], FakeWordsConfig(quantization=2), device=CPU)
    svc = AnnService(ann, AnnServiceConfig(k=5, depth=50, rerank=True, max_batch=4,
                                           cache_size=8))
    qa = small_corpus[:4]
    qb = qa + 1e-4  # same tf row at Q = 2, different exact cosine
    ra = fakewords.encode_queries(torch.as_tensor(qa), ann.config)
    rb = fakewords.encode_queries(torch.as_tensor(qb), ann.config)
    np.testing.assert_array_equal(ra.numpy(), rb.numpy())
    s_a, _ = svc.search_batch(qa)
    s_b, _ = svc.search_batch(qb)
    assert svc.stats()["cache_hits"] == 0  # the rep collided, the raw queries did not
    assert not np.array_equal(s_a, s_b)


@pytest.mark.parametrize("cid,cfg,jcfg,exact_match",
                         [c for c in ALL_CONFIGS if c[0] in ("fakewords-classic",
                                                             "LexicalLshConfig")],
                         ids=["fakewords-classic", "LexicalLshConfig"])
@pytest.mark.parametrize("rerank", [True, False], ids=["rerank", "match-only"])
def test_cache_counts_follow_the_reference(small_corpus, tmp_path, cid, cfg, jcfg, exact_match,
                                           rerank):
    """The same stream of batches (repeats, rep collisions at Q = 2 or in a
    MinHash signature, a filter, an index swap) through both services gives
    the same hit and miss counts after every batch.  The LSH case keys on
    uint32 signatures, hashed through their int32 bits."""
    jann, ann = _carried(small_corpus[:512], jcfg, tmp_path)
    kw = dict(k=5, depth=50, rerank=rerank, max_batch=4, cache_size=3)
    svc = AnnService(ann, AnnServiceConfig(**kw))
    jsvc = JAnnService(jann, JAnnServiceConfig(use_kernel=False, **kw))
    q = small_corpus[:12]
    mask = (np.arange(512) % 3 == 0).astype(np.int32)
    stream = [(q[:4], None), (q[:4], None), (q[:4] + 1e-4, None), (q[4:12], None),
              (q[:4], mask), (q[:4], None), (q[:4], mask), (q[8:12], None), (q[:4], None)]
    for qs, m in stream:
        svc.search_batch(qs, filter=m)
        jsvc.search_batch(qs, filter=m)
        assert (svc.cache_hits, svc.cache_misses) == (jsvc.cache_hits, jsvc.cache_misses)
    assert svc.cache_hits > 0 and svc.stats()["cache_entries"] == 3
    sig = svc.ann.pipeline.encoder(ann.index, bruteforce.l2_normalize(torch.as_tensor(q[:4])))
    assert sig.dtype == (torch.uint32 if cid == "LexicalLshConfig" else torch.int32)
    assert svc._cache_key(sig, None) == svc._cache_key(sig.clone(), None)


# -- epoch-keyed serving (test_segments.py:311-406) --------------------------


def _corpora(rng):
    a = rng.normal(size=(600, 32)).astype(np.float32)
    b = rng.normal(size=(412, 32)).astype(np.float32)
    return a, b


def test_service_nrt_refresh_zero_stale_hits(rng):
    """AnnService(writer=...) serves across refresh() with ZERO stale cache
    hits: a doc added after the first round surfaces right after refresh
    with the cache on, and a delete hides it; the counts are the JAX
    service's on the same stream."""
    a, _ = _corpora(rng)
    counts = []
    for ports in (True, False):
        if ports:
            w = IndexWriter(BruteForceConfig(), merge_policy=None, device=CPU)
            w.add(a)
            svc = AnnService(writer=w, service=AnnServiceConfig(
                k=5, depth=20, rerank=True, max_batch=8, cache_size=16))
        else:
            w = JIndexWriter(JBruteForceConfig(), merge_policy=None, use_kernel=False)
            w.add(a)
            svc = JAnnService(writer=w, service=JAnnServiceConfig(
                k=5, depth=20, rerank=True, max_batch=8, cache_size=16, use_kernel=False))
        qs = a[:8]
        _, i1 = svc.search_batch(qs)
        _, i1b = svc.search_batch(qs)
        np.testing.assert_array_equal(i1, i1b)
        new_id = int(w.add(a[0:1] * 3.0)[0])
        old_epoch = svc.ann.epoch
        assert svc.refresh() != old_epoch
        _, i2 = svc.search_batch(qs)
        assert new_id in np.asarray(i2)[0]
        w.delete([new_id])
        svc.refresh()
        _, i3 = svc.search_batch(qs)
        assert new_id not in np.asarray(i3)
        assert svc.refresh() == svc.ann.epoch  # unchanged: epoch and warm cache kept
        _, i3b = svc.search_batch(qs)
        np.testing.assert_array_equal(i3, i3b)
        counts.append((svc.cache_hits, svc.cache_misses))
        stats = svc.stats()
        assert stats["segments"] == svc.ann.num_segments and stats["epoch"] == svc.ann.epoch
    assert counts[0] == counts[1] == (2, 3)


def test_service_cache_key_includes_index_epoch(small_corpus):
    """Swapping the served index never serves the old index's cached
    results; swapping back revives its still-resident entries."""
    cfg = BruteForceConfig()
    ann1 = AnnIndex.build(small_corpus[:512], cfg, device=CPU)
    ann2 = AnnIndex.build(small_corpus[:512][::-1].copy(), cfg, device=CPU)
    assert ann1.epoch != ann2.epoch
    svc = AnnService(ann1, AnnServiceConfig(k=5, depth=20, rerank=True, max_batch=8,
                                            cache_size=8))
    qs = small_corpus[:8]
    _, ia = svc.search_batch(qs)
    assert svc.set_index(ann2) == ann2.epoch
    _, ib = svc.search_batch(qs)
    assert svc.cache_hits == 0, "stale hit across an index swap"
    assert not np.array_equal(ia, ib)
    svc.set_index(ann1)
    _, ic = svc.search_batch(qs)
    assert svc.cache_hits == 1
    np.testing.assert_array_equal(ia, ic)


def test_index_epochs_are_fresh(small_corpus, tmp_path):
    """Every constructed, loaded or carried index is a new snapshot."""
    ann = AnnIndex.build(small_corpus[:256], LexicalLshConfig(buckets=64, hashes=2), device=CPU)
    ann.save(str(tmp_path / "i.ann"))
    loaded = AnnIndex.load(str(tmp_path / "i.ann"), device=CPU)
    copy = dataclasses.replace(ann, epoch=None)
    assert len({ann.epoch, loaded.epoch, copy.epoch}) == 3
    assert dataclasses.replace(ann).epoch == ann.epoch  # an explicit epoch is kept


def test_service_serves_segmented_index_directly(rng, tmp_path):
    """A SegmentedAnnIndex (e.g. loaded from a commit point) serves through
    AnnService like any index; unsupported combinations fail loudly."""
    a, _ = _corpora(rng)
    w = IndexWriter(FakeWordsConfig(quantization=50), merge_policy=None, device=CPU)
    w.add(a[:300])
    w.flush()
    w.add(a[300:])
    reader = w.refresh()
    svc = AnnService(reader, AnnServiceConfig(k=10, depth=50, rerank=True, max_batch=8))
    s_svc, i_svc = svc.search_batch(a[:8])
    s_dir, i_dir = reader.search(torch.as_tensor(a[:8]), k=10, depth=50, rerank=True)
    np.testing.assert_array_equal(i_dir.numpy(), i_svc)
    np.testing.assert_array_equal(s_dir.numpy(), s_svc)
    assert svc.stats()["index_bytes"] == reader.nbytes() > 0
    jw = JIndexWriter(JFakeWordsConfig(quantization=50), merge_policy=None, use_kernel=False)
    jw.add(a[:300])
    jw.flush()
    jw.add(a[300:])
    jsvc = JAnnService(jw.refresh(), JAnnServiceConfig(k=10, depth=50, rerank=True,
                                                       max_batch=8, use_kernel=False))
    assert_topk_match((s_svc, i_svc), jsvc.search_batch(a[:8]), exact=False)
    w_bf = IndexWriter(BruteForceConfig(), merge_policy=None, device=CPU)
    w_bf.add(a[:64])
    w_bf.flush()
    with pytest.raises(ValueError):
        AnnService(w_bf.refresh(), AnnServiceConfig(blockmax_keep=4))
    with pytest.raises(TypeError):
        svc.set_index("not an index")  # type: ignore[arg-type]
    with pytest.raises(ValueError):
        svc.refresh()  # no writer


def test_max_wait_s_is_back():
    """``max_wait_s`` is the async micro-batcher's coalescing window:
    positive by default, beside a bounded admission queue; the port's
    config is the reference's without ``use_kernel``."""
    assert AnnServiceConfig().max_wait_s > 0
    assert AnnServiceConfig().queue_depth > 0
    port = {f.name: f.default for f in dataclasses.fields(AnnServiceConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(JAnnServiceConfig)}
    ref.pop("use_kernel")
    assert port == ref
