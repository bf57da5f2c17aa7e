"""The port's packed single-launch segmented search
(``repro_torch.core.packed``) on the CPU route: the packed superbuffer path
returns exactly the per-segment loop's results (ids and scores bit for bit:
both score the same rows) across segment counts, encodings and filters;
the executable cache keeps its builds bounded across refresh cycles, and a
full repack never reuses an entry keyed on the old buffers.

Mirrors ``tests/test_packed.py`` except ``test_packed_sharded_composition``
(the sharded path is not ported).  The recompile guard asserts on
``EXEC_CACHE.compiles`` / ``hits``: the reference's trace audit counts
JAX's compiles, and the port has none.  The port has no ``REPRO_PACKED``
switch, so only the ``packed=False`` half of
``test_packed_false_forces_loop_and_env_kill_switch`` is mirrored, and no
``static_rows`` mode (no search sets it), so ``test_packed_static_rows_bound``
is not; the cache's entries going with their pack is the port's own.  One
case holds the packed search against the JAX package's own packed search
on the same operations."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_topk_match

from repro.core.segments import IndexWriter as JIndexWriter
from repro.core.types import FakeWordsConfig as JFakeWordsConfig
from repro.core.types import LexicalLshConfig as JLexicalLshConfig
from repro_torch.core import packed as packed_mod
from repro_torch.core.segments import IndexWriter
from repro_torch.core.types import FakeWordsConfig, KdTreeConfig, LexicalLshConfig

# The parity matrix: classic fp32 postings, dot-mode int8 postings, int4
# quantized-classic postings, LSH signatures.
MATRIX = [
    ("classic", FakeWordsConfig(quantization=50), "fp32", "exact"),
    ("dot-int8", FakeWordsConfig(quantization=50, scoring="dot"), "int8", "int8"),
    ("int4", FakeWordsConfig(quantization=50), "int4", "exact"),
    ("lsh", LexicalLshConfig(buckets=64, hashes=2), "fp32", "exact"),
]
LSH = LexicalLshConfig(buckets=64, hashes=2)


def _writer(cfg, postings, store, n_segments, rng, dim=32, seg_docs=40):
    w = IndexWriter(cfg, rerank_store=store, primary_postings=postings, merge_policy=None,
                    device="cpu")
    for _ in range(n_segments):
        w.add(rng.normal(size=(seg_docs, dim)).astype(np.float32))
        w.flush()
    return w


def _assert_packed_equals_loop(reader, queries, fm=None, k=10, depth=50):
    for rerank in (False, True):
        s0, i0 = reader.search(queries, k=k, depth=depth, rerank=rerank, packed=False,
                               filter_mask=fm)
        s1, i1 = reader.search(queries, k=k, depth=depth, rerank=rerank, packed=True,
                               filter_mask=fm)
        assert torch.equal(i0, i1) and torch.equal(s0, s1)


@pytest.mark.parametrize("n_segments", [1, 4, 16])
@pytest.mark.parametrize("name,cfg,postings,store", MATRIX, ids=[m[0] for m in MATRIX])
def test_packed_parity(name, cfg, postings, store, n_segments, rng):
    """Packed single launch == per-segment loop, rerank on and off,
    unfiltered AND under deletes ∧ a predicate."""
    w = _writer(cfg, postings, store, n_segments, rng)
    reader = w.refresh()
    queries = rng.normal(size=(6, 32)).astype(np.float32)
    _assert_packed_equals_loop(reader, queries)
    n = reader.max_doc
    w.delete(rng.choice(n, size=max(1, n // 10), replace=False))
    reader = w.refresh()
    fm = rng.random(n) < 0.7
    _assert_packed_equals_loop(reader, queries, fm=fm)


@pytest.mark.parametrize("name,cfg,jcfg,exact", [
    ("classic", FakeWordsConfig(quantization=50), JFakeWordsConfig(quantization=50), False),
    ("lsh", LSH, JLexicalLshConfig(buckets=64, hashes=2), True),
], ids=["classic", "lsh"])
def test_packed_matches_jax_packed(name, cfg, jcfg, exact, rng):
    """The port's packed search against the JAX package's packed search
    over the same adds and deletes (integer scores bit for bit, classic
    under the near-tie rule)."""
    chunks = [rng.normal(size=(n, 32)).astype(np.float32) for n in (70, 90, 40)]
    dead = rng.choice(200, size=20, replace=False)
    w = IndexWriter(cfg, merge_policy=None, device="cpu")
    jw = JIndexWriter(jcfg, merge_policy=None, use_kernel=False)
    for c in chunks:
        w.add(c)
        w.flush()
        jw.add(c)
        jw.flush()
    w.delete(dead)
    jw.delete(dead)
    queries = chunks[0][:5]
    for rerank in (False, True):
        js, ji = jw.refresh().search(jnp.asarray(queries), k=10, depth=50, rerank=rerank,
                                     use_kernel=False, packed=True)
        got = w.refresh().search(queries, k=10, depth=50, rerank=rerank, packed=True)
        assert_topk_match(got, (js, ji), exact=exact and not rerank)


def test_packed_parity_per_query_filter(rng):
    """(B, max_doc) per-query predicate bitmaps ride the packed path too."""
    w = _writer(FakeWordsConfig(quantization=50), "fp32", "exact", 4, rng)
    reader = w.refresh()
    queries = rng.normal(size=(5, 32)).astype(np.float32)
    fm = rng.random((5, reader.max_doc)) < 0.6
    _assert_packed_equals_loop(reader, queries, fm=fm)


def test_packed_kdtree_scan_parity(rng):
    """The kd scan (the reduction refitted on the live rows) packs too."""
    w = _writer(KdTreeConfig(dims=8, backend="scan"), "fp32", "exact", 4, rng)
    reader = w.refresh()
    _assert_packed_equals_loop(reader, rng.normal(size=(4, 32)).astype(np.float32))
    pk = reader.packed_segments()
    assert pk.view.split_dim is None and pk.view.perm is None


def test_bucket_ladder():
    assert packed_mod.bucket_rows(1) == 256
    assert packed_mod.bucket_rows(256) == 256
    assert packed_mod.bucket_rows(257) == 384
    assert packed_mod.bucket_rows(600) == 768
    assert packed_mod.bucket_rows(769) == 1024
    assert packed_mod.bucket_rows(1025) == 1536
    assert packed_mod.bucket_rows(2_999_808) == 3_145_728
    for n in range(1, 5000, 37):
        assert n <= packed_mod.bucket_rows(n) <= max(256, int(n * 1.5))
    assert packed_mod._append_block(8) == 128
    assert packed_mod._append_block(8, room=68) == 64
    assert packed_mod._append_block(5, room=6) == 0


def test_recompile_guard(rng):
    """One search build across 10 NRT refresh cycles of a stats-static
    encoding inside one bucket: the appends write in place, so every later
    search is a cache hit."""
    cache = packed_mod.EXEC_CACHE
    cache.clear()
    # 560 docs -> bucket 768, room for nine 8-row appends in 128-row blocks.
    w = _writer(LSH, "fp32", "exact", 1, rng, seg_docs=560)
    queries = rng.normal(size=(4, 32)).astype(np.float32)

    def cycle(i):
        if i:
            w.add(rng.normal(size=(8, 32)).astype(np.float32))
            w.flush()
        reader = w.refresh()
        reader.search(queries, k=10, depth=50, packed=True)
        assert reader.packed_segments().bucket == 768
        return reader

    cycle(0)
    cycle(1)
    compiles = cache.compiles
    for i in range(2, 10):
        reader = cycle(i)
    assert cache.compiles == compiles == 1, cache.stats()
    assert cache.hits >= 8, cache.stats()
    assert reader.packed_segments().appends == 9
    _assert_packed_equals_loop(reader, queries)


def test_append_rung_narrowing(rng):
    """Near the top of a bucket the in-place append narrows its block rung
    (128 -> 64 -> 32) instead of repacking fully, and the search stays a
    cache hit throughout."""
    cache = packed_mod.EXEC_CACHE
    # 700 docs -> bucket 768: only 68 rows of room, so appends narrow.
    w = _writer(LSH, "fp32", "exact", 1, rng, seg_docs=700)
    queries = rng.normal(size=(4, 32)).astype(np.float32)

    def cycle():
        w.add(rng.normal(size=(8, 32)).astype(np.float32))
        w.flush()
        reader = w.refresh()
        reader.search(queries, k=10, depth=50, packed=True)
        return reader.packed_segments()

    w.refresh().search(queries, k=10, depth=50, packed=True)  # warm search
    compiles = cache.compiles
    for _ in range(3):  # rungs 64, 32, 32
        pk = cycle()
    assert pk.bucket == 768
    assert pk.appends == 3, "appends near the bucket edge must absorb"
    pk = cycle()
    assert pk.appends == 4 and cache.compiles == compiles


def test_full_repack_is_a_cache_miss(rng):
    """A full repack allocates new buffers, so the search entry keyed on
    the old ones must miss: after an append no rung holds (``_append_block``
    returns 0) and after a classic refresh."""
    cache = packed_mod.EXEC_CACHE
    queries = rng.normal(size=(4, 32)).astype(np.float32)
    # 762 docs -> bucket 768: 5 more rows fit the bucket but no 8-row rung.
    w = _writer(LSH, "fp32", "exact", 1, rng, seg_docs=762)
    w.refresh().search(queries, k=10, depth=50, packed=True)
    compiles = cache.compiles
    w.add(rng.normal(size=(5, 32)).astype(np.float32))
    reader = w.refresh()
    reader.search(queries, k=10, depth=50, packed=True)
    pk = reader.packed_segments()
    assert pk.bucket == 768 and pk.appends == 0
    assert cache.compiles == compiles + 1
    _assert_packed_equals_loop(reader, queries)

    w = _writer(FakeWordsConfig(quantization=50), "fp32", "exact", 2, rng)
    w.refresh().search(queries, k=10, depth=50, packed=True)
    compiles = cache.compiles
    w.add(rng.normal(size=(30, 32)).astype(np.float32))
    w.refresh().search(queries, k=10, depth=50, packed=True)
    assert cache.compiles == compiles + 1


def test_donated_incremental_append(rng):
    """Append-only refreshes of a stats-static encoding write into the
    prior snapshot's buffers; the spent prior repacks when searched."""
    w = _writer(LSH, "fp32", "exact", 1, rng, seg_docs=600)
    r0 = w.refresh()
    pk0 = r0.packed_segments()
    assert pk0.appends == 0
    sig = pk0.view.sig
    w.add(rng.normal(size=(20, 32)).astype(np.float32))
    w.flush()
    r1 = w.refresh()
    pk = r1.packed_segments()
    assert pk.appends == 1 and pk.view.sig is sig  # the same buffer, written in place
    assert pk0.view is None
    queries = rng.normal(size=(4, 32)).astype(np.float32)
    _assert_packed_equals_loop(r1, queries)
    assert r0._packed is None
    r0_again = r0.packed_segments()
    assert r0_again is not None and r0_again.appends == 0
    assert r0_again.view.sig is not sig
    _assert_packed_equals_loop(r0, queries)


def test_dot_append_refreshes_global_leaves_in_place(rng):
    """Dot-mode fake words append in place too: the packed view's df / idf
    are its own, refreshed from the new stat views."""
    w = _writer(FakeWordsConfig(quantization=50, scoring="dot"), "fp32", "exact", 1, rng,
                seg_docs=600)
    w.refresh().packed_segments()
    w.add(rng.normal(size=(20, 32)).astype(np.float32))
    w.flush()
    reader = w.refresh()
    pk = reader.packed_segments()
    assert pk.appends == 1
    views, _ = reader._ensure_views()
    assert torch.equal(pk.view.df, views[0].df) and pk.view.df is not views[0].df
    _assert_packed_equals_loop(reader, rng.normal(size=(4, 32)).astype(np.float32))


def test_classic_repacks_fully_and_stays_exact(rng):
    """Classic scoring rebuilds per-row state under the new idf, so a
    refresh repacks fully, and stays loop-exact."""
    w = _writer(FakeWordsConfig(quantization=50), "fp32", "exact", 2, rng)
    w.refresh().packed_segments()
    w.add(rng.normal(size=(30, 32)).astype(np.float32))
    w.flush()
    r1 = w.refresh()
    assert r1.packed_segments().appends == 0
    _assert_packed_equals_loop(r1, rng.normal(size=(4, 32)).astype(np.float32))


def test_packed_false_forces_loop(rng):
    """packed=False serves the reference loop and never builds the pack;
    packed=None takes the packed path when the layout allows."""
    w = _writer(FakeWordsConfig(quantization=50), "fp32", "exact", 2, rng)
    reader = w.refresh()
    queries = rng.normal(size=(3, 32)).astype(np.float32)
    reader.search(queries, packed=False)
    assert reader._packed is None
    reader.search(queries)
    assert reader._packed is not None


def test_packed_blockmax_exact_at_full_keep(rng):
    """blockmax_keep = every block reshuffles the exact scan: segmented
    blockmax over the packed view == the unpruned loop."""
    for cfg in (FakeWordsConfig(quantization=50), LSH):
        w = _writer(cfg, "fp32", "exact", 4, rng, seg_docs=40)
        reader = w.refresh()
        queries = rng.normal(size=(4, 32)).astype(np.float32)
        s0, i0 = reader.search(queries, k=10, depth=50, packed=False)
        keep = reader.packed_segments().bucket // 64  # block_size 64: every block
        s1, i1 = reader.search(queries, k=10, depth=50, packed=True, blockmax_keep=keep,
                               blockmax_block_size=64)
        assert torch.equal(i0, i1)
        np.testing.assert_allclose(s0.numpy(), s1.numpy(), rtol=1e-5, atol=1e-6)


def test_cache_entries_die_with_their_pack(rng):
    """A pack's cache entries go when its buffers are freed: classic
    refresh cycles (each a full repack) leave only the live snapshot's
    entry, an in-place append keeps its pack's view (the entries' owner), and dropping
    the last reader empties the cache."""
    cache = packed_mod.EXEC_CACHE
    cache.clear()
    queries = rng.normal(size=(4, 32)).astype(np.float32)
    w = _writer(FakeWordsConfig(quantization=50), "fp32", "exact", 2, rng)
    for _ in range(4):
        w.add(rng.normal(size=(30, 32)).astype(np.float32))
        reader = w.refresh()
        reader.search(queries, k=10, depth=50, packed=True)
        assert cache.stats()["entries"] == 1, cache.stats()
    assert cache.compiles == 4 and cache.evictions == 0
    del reader
    w._reader = None
    assert cache.stats()["entries"] == 0

    w = _writer(LSH, "fp32", "exact", 1, rng, seg_docs=600)
    reader = w.refresh()
    reader.search(queries, k=10, depth=50, packed=True)
    owner = reader.packed_segments().view
    w.add(rng.normal(size=(20, 32)).astype(np.float32))
    reader = w.refresh()
    reader.search(queries, k=10, depth=50, packed=True)
    assert reader.packed_segments().view is owner and reader.packed_segments().appends == 1
    del owner
    assert cache.stats()["entries"] == 1 and cache.hits == 1
    del reader
    w._reader = None
    assert cache.stats()["entries"] == 0


def test_packed_unsupported_falls_back_and_true_raises(rng):
    """global_stats=False cannot pack fake words: packed=None serves the
    loop, packed=True raises with the reason."""
    w = IndexWriter(FakeWordsConfig(quantization=50), merge_policy=None, global_stats=False,
                    device="cpu")
    w.add(np.random.default_rng(1).normal(size=(80, 32)).astype(np.float32))
    w.flush()
    w.add(np.random.default_rng(2).normal(size=(60, 32)).astype(np.float32))
    w.flush()
    reader = w.refresh()
    queries = np.random.default_rng(3).normal(size=(3, 32)).astype(np.float32)
    s, i = reader.search(queries, k=5, depth=20)
    assert reader.packed_segments() is None and reader._packed_err
    assert torch.equal(i, reader.search(queries, k=5, depth=20, packed=False)[1])
    with pytest.raises(ValueError, match="packed single-launch"):
        reader.search(queries, k=5, depth=20, packed=True)


def test_executable_cache_lru_bounds():
    """LRU past ``capacity``; the key holds the resident buffers' addresses
    and the owner; an owner's entries go when it is freed (no eviction)."""
    import gc

    cache = packed_mod.ExecutableCache(capacity=2)
    x = torch.zeros(3)
    owner, other = torch.zeros(1), torch.zeros(1)
    for depth in (1, 2, 3):
        cache.get(("k", depth), owner, lambda: (lambda a, b: a + b), (x,), (x,))
    assert cache.stats() == {"entries": 2, "hits": 0, "compiles": 3, "evictions": 1,
                             "pool_bytes": 0}
    cache.get(("k", 3), owner, lambda: None, (x,), (x,))
    assert cache.hits == 1
    cache.get(("k", 3), owner, lambda: (lambda a, b: a), (torch.zeros(3),), (x,))  # other buffer
    cache.get(("k", 3), other, lambda: (lambda a, b: a), (x,), (x,))  # other owner
    assert cache.compiles == 5
    del owner
    gc.collect()
    assert cache.stats()["entries"] == 1 and cache.evictions == 3
