"""The port's segmented mutable index (``repro_torch.core.segments``:
IndexWriter add / delete / flush / merge / commit, liveDocs inside the match
stage, ``segments_N.json`` commit points) on the CPU route, against the
port's own monolithic builds and against the JAX package's segmented
reader (``repro.core.segments``, its plain XLA path).

Mirrors ``tests/test_segments.py`` except its four serving cases
(``AnnService`` is not ported), with the three ``IndexWriter`` cases of
``tests/test_filtered.py`` and the segmented quantized cases of
``tests/test_quantized.py``.  A segmented search equals a monolithic build
of the live corpus: integer-scored modes (dot, LSH) and classic bit for
bit; the f32 modes (brute force, the kd scan) under the near-tie rule,
since their product's shape follows a segment's row count (the reference's
own segmented / monolithic check differs in the last bit there).  Against
the JAX package: integer modes bit for bit, float modes under the near-tie
rule.  Commit points open both ways."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_topk_match

from repro.core.segments import IndexWriter as JIndexWriter
from repro.core.segments import SegmentedAnnIndex as JSegmentedAnnIndex
from repro.core.types import BruteForceConfig as JBruteForceConfig
from repro.core.types import FakeWordsConfig as JFakeWordsConfig
from repro.core.types import KdTreeConfig as JKdTreeConfig
from repro.core.types import LexicalLshConfig as JLexicalLshConfig
from repro_torch.core import bruteforce
from repro_torch.core import pipeline as pl
from repro_torch.core.index import AnnIndex
from repro_torch.core.segments import (
    IndexWriter,
    Segment,
    SegmentedAnnIndex,
    TieredMergePolicy,
    find_commits,
)
from repro_torch.core.types import (
    BruteForceConfig,
    FakeWordsConfig,
    KdTreeConfig,
    LexicalLshConfig,
    SearchParams,
)

CPU = "cpu"

# (id, port config, JAX config, scores bit-equal to a monolithic build, to JAX)
ALL_CONFIGS = [
    ("fakewords-classic", FakeWordsConfig(quantization=50), JFakeWordsConfig(quantization=50),
     True, False),
    ("fakewords-dot", FakeWordsConfig(quantization=50, scoring="dot"),
     JFakeWordsConfig(quantization=50, scoring="dot"), True, True),
    ("LexicalLshConfig", LexicalLshConfig(buckets=64, hashes=2),
     JLexicalLshConfig(buckets=64, hashes=2), True, True),
    ("kdtree-pca", KdTreeConfig(dims=8, backend="scan"), JKdTreeConfig(dims=8, backend="scan"),
     False, False),
    ("kdtree-ppa-pca-ppa", KdTreeConfig(dims=8, backend="scan", reduction="ppa-pca-ppa"),
     JKdTreeConfig(dims=8, backend="scan", reduction="ppa-pca-ppa"), False, False),
    ("BruteForceConfig", BruteForceConfig(), JBruteForceConfig(), False, False),
]
_IDS = [c[0] for c in ALL_CONFIGS]


def _corpora(rng):
    a = rng.normal(size=(600, 32)).astype(np.float32)
    b = rng.normal(size=(412, 32)).astype(np.float32)
    return a, b


def _map_mono_ids(gmap, mono_ids):
    """Monolithic live-corpus ids -> segmented stable global ids."""
    mono_ids = np.asarray(mono_ids)
    return np.where(mono_ids >= 0, gmap[np.maximum(mono_ids, 0)], -1)


def _assert_parity(reader, mono, queries, exact=True, k=10, depth=50, packed=None):
    """Segmented search == monolithic search of the live corpus, rerank on
    AND off: scores bit for bit and ids exact (through the live-id map), or
    under the near-tie rule where ``exact`` is False."""
    gmap = reader.live_global_ids()
    for rerank in (False, True):
        s0, i0 = mono.search(queries, k=k, depth=depth, rerank=rerank)
        s1, i1 = reader.search(queries, k=k, depth=depth, rerank=rerank, packed=packed)
        assert_topk_match((s1, i1), (s0, _map_mono_ids(gmap, i0)), exact=exact)


def _writer(cfg, **kw):
    return IndexWriter(cfg, device=CPU, **kw)


# -- the acceptance flow: add / add / delete / commit / reload / merge -------


@pytest.mark.parametrize("name,cfg,jcfg,exact,jexact", ALL_CONFIGS, ids=_IDS)
def test_segmented_equals_monolithic_with_deletes(name, cfg, jcfg, exact, jexact, rng, tmp_path):
    """Corpus A, then B through the writer, a random 10% deleted, commit,
    reload: the results of a monolithic build of the live corpus, before
    AND after a full merge, on both search paths; and those of the JAX
    package's segmented reader over the same operations."""
    a, b = _corpora(rng)
    queries = a[:8]
    w = _writer(cfg, merge_policy=None)
    ids_a = w.add(a)
    assert w.flush() and w.num_segments == 1
    ids_b = w.add(b)
    np.testing.assert_array_equal(ids_a, np.arange(len(a)))
    np.testing.assert_array_equal(ids_b, np.arange(len(a), len(a) + len(b)))
    n = len(a) + len(b)
    dead = rng.choice(n, size=n // 10, replace=False)
    assert w.delete(dead) == len(dead)
    assert w.delete(dead) == 0  # idempotent

    live = np.ones(n, bool)
    live[dead] = False
    mono = AnnIndex.build(np.concatenate([a, b])[live], cfg, device=CPU)

    path = os.path.join(tmp_path, "seg.ann")
    assert w.commit(path) == 1
    reader = SegmentedAnnIndex.load(path, device=CPU)
    assert reader.num_segments == 2
    assert reader.num_docs == live.sum() and reader.max_doc == n
    np.testing.assert_array_equal(reader.live_global_ids(), np.flatnonzero(live))
    for packed in (False, True):
        _assert_parity(reader, mono, queries, exact, packed=packed)

    # The JAX package's writer through the same operations (its loop, XLA).
    jw = JIndexWriter(jcfg, merge_policy=None, use_kernel=False)
    jw.add(a)
    jw.flush()
    jw.add(b)
    jw.delete(dead)
    jreader = jw.refresh()
    for rerank in (False, True):
        js, ji = jreader.search(jnp.asarray(queries), k=10, depth=50, rerank=rerank,
                                use_kernel=False, packed=False)
        got = reader.search(queries, k=10, depth=50, rerank=rerank)
        assert_topk_match(got, (js, ji), exact=jexact and not rerank)

    # forced full merge: one fully-live segment, ids now == monolithic ids
    w.force_merge(1)
    merged = w.refresh()
    assert merged.num_segments == 1 and merged.del_count == 0
    assert merged.num_docs == live.sum()
    _assert_parity(merged, mono, queries)
    assert w.commit() == 2
    _assert_parity(SegmentedAnnIndex.load(path, device=CPU), mono, queries)


@pytest.mark.parametrize("scoring", ["classic", "dot"])
def test_df_prune_thresholds_at_the_collection_live_count(scoring, rng):
    """A real df prune ratio: every segment prunes against the collection's
    live count (not its own rows), so both search paths equal a
    monolithic build of the live corpus bit for bit."""
    a, b = _corpora(rng)
    cfg = FakeWordsConfig(quantization=50, scoring=scoring, df_max_ratio=0.49)
    w = _writer(cfg, merge_policy=None)
    w.add(a)
    w.flush()
    w.add(b)
    n = len(a) + len(b)
    dead = rng.choice(n, size=n // 10, replace=False)
    w.delete(dead)
    live = np.ones(n, bool)
    live[dead] = False
    mono = AnnIndex.build(np.concatenate([a, b])[live], cfg, device=CPU)
    reader = w.refresh()
    views, matcher = reader._ensure_views()
    assert matcher.inner.df_num_docs == live.sum()
    keep = views[0].df <= int(0.49 * live.sum())
    assert 0 < int(keep.sum()) < keep.numel()  # the ratio prunes some terms, not all
    for packed in (False, True):
        _assert_parity(reader, mono, a[:8], packed=packed)


@pytest.mark.parametrize("name,cfg,jcfg,exact,jexact", ALL_CONFIGS, ids=_IDS)
def test_one_segment_equals_many_segments_after_merge(name, cfg, jcfg, exact, jexact, rng):
    """One flush == four flushes + a full merge, bit for bit (the merge
    rebuilds from the stored unit rows without normalizing them again)."""
    a, b = _corpora(rng)
    corpus = np.concatenate([a, b])
    w1 = _writer(cfg, merge_policy=None)
    w1.add(corpus)
    one = w1.refresh()
    wn = _writer(cfg, merge_policy=None)
    for chunk in np.array_split(corpus, 4):
        wn.add(chunk)
        wn.flush()
    assert wn.num_segments == 4
    wn.force_merge(1)
    many = wn.refresh()
    assert many.num_segments == 1
    for rerank in (False, True):
        s0, i0 = one.search(a[:8], k=10, depth=50, rerank=rerank)
        s1, i1 = many.search(a[:8], k=10, depth=50, rerank=rerank)
        assert torch.equal(i0, i1) and torch.equal(s0, s1)


# -- deletes -----------------------------------------------------------------


def test_delete_commit_load_round_trip(rng, tmp_path):
    """Deletes persist through commit points; deleted docs never surface;
    later generations stack further deletes."""
    a, _ = _corpora(rng)
    cfg = BruteForceConfig()
    path = os.path.join(tmp_path, "del.ann")
    w = _writer(cfg, path=path, merge_policy=None)
    w.add(a)
    w.commit()
    queries = a[:4]
    _, top = AnnIndex.build(a, cfg, device=CPU).search(queries, k=1, depth=1)
    victims = top.numpy()[:, 0]
    w.delete(victims)
    assert w.commit() == 2
    loaded = SegmentedAnnIndex.load(path, device=CPU)
    assert loaded.del_count == len(set(victims.tolist()))
    _, ids = loaded.search(queries, k=10, depth=50, rerank=True)
    assert not set(victims.tolist()) & set(ids.flatten().tolist())
    old = SegmentedAnnIndex.load(path, generation=1, device=CPU)
    assert old.del_count == 0
    _, old_ids = old.search(queries, k=1, depth=1)
    np.testing.assert_array_equal(old_ids.numpy()[:, 0], victims)


def test_delete_in_buffer_and_depth_semantics(rng):
    """Deleting buffered (unflushed) docs works, and liveDocs inside the
    match stage keeps depth: depth-d returns d LIVE candidates when d live
    docs exist."""
    a, _ = _corpora(rng)
    w = _writer(BruteForceConfig(), merge_policy=None)
    ids = w.add(a)
    w.delete(ids[10:20])  # still in the buffer
    reader = w.refresh()
    assert reader.del_count == 10
    depth = len(a) - 10  # exactly the live count
    for packed in (False, True):
        s, i = reader.search(a[:2], k=depth, depth=depth, packed=packed)
        assert (i >= 0).all(), "masked deletes must not shrink the depth"
        assert not np.isin(i.numpy(), np.arange(10, 20)).any()
    with pytest.raises(IndexError):
        w.delete([len(a) + 5])


def test_live_docs_matcher_is_a_match_stage(rng):
    """LiveDocsMatcher semantics: masking happens before the stage's top-k,
    so the output is the top-depth over LIVE docs only, both ways."""
    v = rng.normal(size=(64, 16)).astype(np.float32)
    ann = AnnIndex.build(v, BruteForceConfig(), device=CPU)
    q = bruteforce.l2_normalize(torch.from_numpy(v[:1]))
    inner = pl.make_matcher(BruteForceConfig())
    _, i_all = inner(ann.index, q, 64)
    top = i_all.numpy()[0]
    live = np.ones(64, bool)
    live[top[:3]] = False  # kill the 3 best docs
    m = pl.LiveDocsMatcher(inner=inner, extra=4)
    for native in (False, True):
        _, i = m(ann.index, q, 5, live, native=native)
        np.testing.assert_array_equal(i.numpy()[0], top[3:8])


@pytest.mark.parametrize("name", ["fakewords-classic", "fakewords-dot", "LexicalLshConfig",
                                  "BruteForceConfig"])
def test_loop_live_docs_native_equals_inflated(name, rng):
    """The loop passes each segment's liveDocs to the kernel as ``filt``
    (one pass); the reference's deletes-only path inflates the depth by
    ``_bucket(deleted)`` and masks after.  Both give the same ids and
    scores, ties included, with and without rerank."""
    cfg = ALL_CONFIGS[_IDS.index(name)][1]
    a, b = _corpora(rng)
    w = _writer(cfg, merge_policy=None)
    for chunk in (a, b[:200], b[200:]):
        w.add(chunk)
        w.flush()
    w.delete(rng.choice(w.total_docs, size=150, replace=False))
    reader = w.refresh()
    _, matcher = reader._ensure_views()
    q_norm = bruteforce.l2_normalize(torch.from_numpy(a[:6]))
    for rerank in (False, True):
        p = SearchParams(k=10, depth=40, rerank=rerank)
        s_n, i_n = reader._loop(q_norm, p, None, matcher, native=True)
        s_f, i_f = reader._loop(q_norm, p, None, matcher, native=False)
        assert torch.equal(i_n, i_f) and torch.equal(s_n, s_f)


# -- merge policy ------------------------------------------------------------


def test_tiered_merge_policy_geometry():
    pol = TieredMergePolicy(merge_factor=4, floor_docs=100)
    assert pol.tier(50) == 0 and pol.tier(100) == 0
    assert pol.tier(101) == 1 and pol.tier(400) == 1 and pol.tier(401) == 2

    def seg(n_live, n_total=None):
        n_total = n_total if n_total is not None else n_live
        live = np.zeros(n_total, bool)
        live[:n_live] = True
        ann = AnnIndex.build(np.zeros((n_total, 4), np.float32) + np.arange(n_total)[:, None],
                             BruteForceConfig(), device=CPU)
        return Segment(ann=ann, live=live, name="t")

    assert pol.find_merge([seg(50)] * 3) is None
    assert pol.find_merge([seg(50)] * 4) == (0, 4)
    # adjacent-only: a tier-1 segment breaks the run
    assert pol.find_merge([seg(50), seg(50), seg(200), seg(50), seg(50)]) is None
    # expunge: >= 50% deleted is rewritten alone
    assert pol.find_merge([seg(200), seg(40, 100)]) == (1, 2)
    with pytest.raises(ValueError, match="merge_factor"):
        TieredMergePolicy(merge_factor=1)


def test_writer_auto_merge_and_id_remap(rng):
    """Flush-triggered tiered merging keeps the segment count logarithmic,
    and a merge drops deleted rows and remaps ids compactly."""
    a, _ = _corpora(rng)
    w = _writer(BruteForceConfig(), merge_policy=TieredMergePolicy(merge_factor=4,
                                                                   floor_docs=128))
    for chunk in np.array_split(a[:512], 8):  # 8 x 64-doc flushes
        w.add(chunk)
        w.flush()
    assert w.num_segments <= 3
    total_before = w.total_docs
    w.delete(np.arange(0, 32))
    w.force_merge(1)
    assert w.num_segments == 1
    assert w.total_docs == total_before - 32
    reader = w.refresh()
    assert reader.num_docs == total_before - 32 and reader.del_count == 0


def test_merge_fully_dead_segments_are_dropped(rng):
    a, _ = _corpora(rng)
    w = _writer(BruteForceConfig(), merge_policy=None)
    ids = w.add(a[:64])
    w.flush()
    w.add(a[64:128])
    w.flush()
    w.delete(ids)  # first segment fully dead
    w.force_merge(1)
    assert w.num_segments == 1 and w.total_docs == 64
    np.testing.assert_array_equal(w.refresh().live_global_ids(), np.arange(64))


def test_refresh_epoch_advances_only_on_change(rng):
    """An unchanged refresh returns the same snapshot (same epoch); a flush
    or a delete makes a new one with a later epoch."""
    a, _ = _corpora(rng)
    w = _writer(BruteForceConfig(), merge_policy=None)
    w.add(a[:64])
    r1 = w.refresh()
    assert w.refresh() is r1
    w.delete([3])
    r2 = w.refresh()
    assert r2 is not r1 and r2.epoch > r1.epoch
    w.add(a[64:70])
    assert w.refresh().epoch > r2.epoch


# -- persistence formats -----------------------------------------------------


def test_commit_points_are_generation_numbered_and_atomic(rng, tmp_path):
    a, _ = _corpora(rng)
    path = os.path.join(tmp_path, "gen.ann")
    w = _writer(BruteForceConfig(), path=path, merge_policy=None)
    w.add(a[:100])
    assert w.commit() == 1
    w.add(a[100:200])
    assert w.commit() == 2
    assert [g for g, _ in find_commits(path)] == [1, 2]
    with open(os.path.join(path, "segments_2.json")) as f:
        meta = json.load(f)
    assert meta["format_version"] == 2 and meta["generation"] == 2
    assert len(meta["segments"]) == 2 and meta["use_kernel"] is None
    assert meta["segments"][0]["name"] == "seg0"  # gen 2 reuses gen 1's dir
    assert not [f for f in os.listdir(path) if f.endswith(".tmp")]
    r1 = SegmentedAnnIndex.load(path, generation=1, device=CPU)
    r2 = SegmentedAnnIndex.load(path, device=CPU)
    assert (r1.num_docs, r2.num_docs) == (100, 200)
    with pytest.raises(FileNotFoundError):
        SegmentedAnnIndex.load(path, generation=7, device=CPU)


def test_commit_lineage_guard(rng, tmp_path):
    """A writer that never read a directory's commits must not commit over
    them; IndexWriter.open adopts the lineage and may continue it."""
    a, _ = _corpora(rng)
    path = os.path.join(tmp_path, "lineage.ann")
    w1 = _writer(BruteForceConfig(), merge_policy=None)
    w1.add(a[:64])
    assert w1.commit(path) == 1
    w2 = _writer(BruteForceConfig(), merge_policy=None)
    w2.add(a[64:128])
    with pytest.raises(ValueError, match="foreign commit history"):
        w2.commit(path)
    assert [g for g, _ in find_commits(path)] == [1]
    w3 = IndexWriter.open(path, device=CPU)
    w3.add(a[64:128])
    assert w3.commit() == 2
    assert SegmentedAnnIndex.load(path, device=CPU).num_docs == 128


def test_v1_dir_loads_as_single_segment_and_upgrades(rng, tmp_path):
    """A plain AnnIndex.save dir opens as one fully-live segment, and
    IndexWriter.open upgrades it to the segmented lifecycle."""
    a, _ = _corpora(rng)
    cfg = FakeWordsConfig(quantization=50)
    ann = AnnIndex.build(a, cfg, device=CPU)
    path = os.path.join(tmp_path, "v1.ann")
    ann.save(path)
    reader = SegmentedAnnIndex.load(path, device=CPU)
    assert reader.num_segments == 1 and reader.num_docs == len(a)
    with pytest.raises(FileNotFoundError, match="v1 single-index"):
        SegmentedAnnIndex.load(path, generation=3, device=CPU)
    for rerank in (False, True):
        s0, i0 = ann.search(a[:8], k=10, depth=50, rerank=rerank)
        s1, i1 = reader.search(a[:8], k=10, depth=50, rerank=rerank)
        assert torch.equal(i0, i1) and torch.equal(s0, s1)
    w = IndexWriter.open(path, device=CPU)
    w.add(a[:10])
    w.delete([0])
    gen = w.commit()
    upgraded = SegmentedAnnIndex.load(path, device=CPU)
    assert gen == 1 and upgraded.num_segments == 2
    assert upgraded.num_docs == len(a) + 10 - 1


def test_format_version_is_validated(rng, tmp_path):
    """AnnIndex.load refuses a newer format and names SegmentedAnnIndex.load
    on a commit dir; commit points validate their version the same way."""
    a, _ = _corpora(rng)
    path = os.path.join(tmp_path, "fv.ann")
    AnnIndex.build(a[:64], BruteForceConfig(), device=CPU).save(path)
    cfg_path = os.path.join(path, "config.json")
    with open(cfg_path) as f:
        meta = json.load(f)
    meta["format_version"] = 99
    with open(cfg_path, "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match="format_version 99.*newer"):
        AnnIndex.load(path, device=CPU)

    seg_path = os.path.join(tmp_path, "seg.ann")
    w = _writer(BruteForceConfig(), path=seg_path, merge_policy=None)
    w.add(a[:64])
    w.commit()
    with pytest.raises(ValueError, match="segmented commit point.*SegmentedAnnIndex.load"):
        AnnIndex.load(seg_path, device=CPU)
    commit_file = os.path.join(seg_path, "segments_1.json")
    with open(commit_file) as f:
        meta = json.load(f)
    meta["format_version"] = 99
    with open(commit_file, "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match="format_version 99"):
        SegmentedAnnIndex.load(seg_path, device=CPU)


# -- guard rails -------------------------------------------------------------


def test_writer_guard_rails(rng):
    a, _ = _corpora(rng)
    with pytest.raises(ValueError, match="rerank_store"):
        _writer(BruteForceConfig(), rerank_store="fp16")
    with pytest.raises(ValueError, match="backend='scan'"):
        _writer(KdTreeConfig(dims=8, backend="tree"))
    with pytest.raises(ValueError, match="backend='scan'"):
        SegmentedAnnIndex(KdTreeConfig(dims=8, backend="tree"), [], device=CPU)
    w = _writer(BruteForceConfig(), merge_policy=None)
    with pytest.raises(ValueError):
        w.add(np.zeros((0, 8), np.float32))
    with pytest.raises(ValueError, match="no live docs"):
        w.refresh().search(a[:1])
    with pytest.raises(ValueError, match="commit needs a path"):
        w.commit()
    w.add(a[:64])
    reader = w.refresh()
    with pytest.raises(ValueError, match="max_doc=64"):
        reader.search(a[:1], filter_mask=np.ones(65, np.int32))
    with pytest.raises(ValueError, match="blockmax_keep"):
        reader.search(a[:1], packed=False, blockmax_keep=1)
    with pytest.raises(ValueError, match="fake-words and LSH"):
        reader.search(a[:1], blockmax_keep=1)


def test_writer_and_load_default_to_cuda_and_raise_without_it(rng, tmp_path, monkeypatch):
    a, _ = _corpora(rng)
    path = os.path.join(tmp_path, "dev.ann")
    w = _writer(BruteForceConfig(), path=path, merge_policy=None)
    w.add(a[:64])
    w.commit()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        IndexWriter(BruteForceConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        SegmentedAnnIndex.load(path)
    with pytest.raises(RuntimeError, match="CUDA"):
        IndexWriter.open(path)


def test_auto_flush_on_buffer_threshold(rng):
    a, _ = _corpora(rng)
    w = _writer(BruteForceConfig(), merge_policy=None, max_buffered_docs=128)
    for chunk in np.array_split(a[:512], 16):  # 32 docs per add
        w.add(chunk)
    assert w.num_segments == 4 and w.buffered_docs == 0


# -- filtered search through the writer (tests/test_filtered.py) -------------


def test_all_filtered_segmented_no_nans(rng):
    v = rng.normal(size=(600, 32)).astype(np.float32)
    w = _writer(FakeWordsConfig(quantization=30), merge_policy=None)
    w.add(v[:300])
    w.add(v[300:])
    reader = w.refresh()
    zeros = np.zeros((reader.max_doc,), np.int32)
    for packed in (False, True):
        s, i = reader.search(v[:4], k=10, depth=40, filter_mask=zeros, packed=packed)
        assert (i == -1).all() and not torch.isnan(s).any()


def test_filter_and_deletes_compose_to_one_mask(rng):
    """A predicate over a segmented index with deletes equals both
    restrictions applied: the exact top-k over docs live AND kept."""
    v = rng.normal(size=(800, 32)).astype(np.float32)
    w = _writer(BruteForceConfig(), merge_policy=None)
    w.add(v[:400])
    w.add(v[400:])
    dead = rng.choice(800, 120, replace=False)
    w.delete(dead.tolist())
    reader = w.refresh()
    pred = (rng.random(800) < 0.5).astype(np.int32)
    live = np.ones(800, bool)
    live[dead] = False
    both = pred.astype(bool) & live
    kept = np.flatnonzero(both)
    vn = bruteforce.l2_normalize(torch.from_numpy(v[kept]))
    qn = bruteforce.l2_normalize(torch.from_numpy(v[:6]))
    truth = kept[torch.topk(qn @ vn.T, 10).indices.numpy()]
    for packed in (False, True):
        _, ids = reader.search(v[:6], k=10, depth=128, filter_mask=pred, packed=packed)
        np.testing.assert_array_equal(ids.numpy(), truth)
        assert not np.isin(ids.numpy(), np.flatnonzero(~both)).any()


def test_doc_metadata_through_writer_flush_and_merge(rng):
    """Metadata rides per segment through flush and merge; the reader's
    global_metadata() answers by global id, and its masks filter."""
    v = rng.normal(size=(400, 32)).astype(np.float32)
    cat = rng.integers(0, 3, 400)
    w = _writer(FakeWordsConfig(quantization=30), merge_policy=None)
    w.add(v[:200], metadata={"cat": cat[:200]})
    w.add(v[200:], metadata={"cat": cat[200:]})
    reader = w.refresh()
    md = reader.global_metadata()
    np.testing.assert_array_equal(md.values[:, 0].numpy(), cat)
    filt = md.eq_mask("cat", 1).to(torch.int32)
    _, ids = reader.search(v[:4], k=10, depth=64, filter_mask=filt)
    kept = ids.numpy()
    assert (cat[kept[kept >= 0]] == 1).all()
    w.flush()
    w.add(v[:50], metadata={"cat": cat[:50]})
    w.flush()
    w.delete(np.arange(10))
    w.force_merge(1)
    merged = w.refresh().global_metadata()
    np.testing.assert_array_equal(merged.values[:, 0].numpy(),
                                  np.concatenate([cat[10:], cat[:50]]))


# -- quantized stores through the writer (tests/test_quantized.py) -----------


@pytest.mark.parametrize(
    "cfg,pp",
    [
        (FakeWordsConfig(quantization=50), "int8"),
        (FakeWordsConfig(quantization=50), "int4"),
        (FakeWordsConfig(quantization=50, scoring="dot"), "int4"),
        (BruteForceConfig(), "int8"),
    ],
    ids=["classic-int8", "classic-int4", "dot-int4", "bruteforce-int8"],
)
def test_segmented_quantized_bitwise_equals_monolithic(small_corpus, cfg, pp, tmp_path):
    """Flushed + merged segments with the int8 rerank store and quantized
    postings search bit for bit as a monolithic build of the same rows;
    the commit keeps the source sidecar, and the reopened writer keeps the
    store choices."""
    v = small_corpus[:240]
    q = small_corpus[:7]
    mono = AnnIndex.build(v, cfg, rerank_store="int8", primary_postings=pp, device=CPU)
    w = _writer(cfg, rerank_store="int8", primary_postings=pp)
    w.add(v[:100])
    w.flush()
    w.add(v[100:])
    w.flush()
    w._merge_range(0, 2)
    reader = w.refresh()
    s_m, i_m = mono.search(q, k=10, depth=60, rerank=True)
    for packed in (False, True):
        s_r, i_r = reader.search(q, k=10, depth=60, rerank=True, packed=packed)
        assert torch.equal(i_m, i_r) and torch.equal(s_m, s_r)
    path = str(tmp_path / "idx")
    w.path = path
    w.commit()
    assert os.path.exists(os.path.join(path, w._segments[0].name, "source.npz"))
    s_2, i_2 = SegmentedAnnIndex.load(path, device=CPU).search(q, k=10, depth=60, rerank=True)
    assert torch.equal(i_m, i_2) and torch.equal(s_m, s_2)
    w2 = IndexWriter.open(path, device=CPU)
    assert w2.rerank_store == "int8" and w2.primary_postings == pp


# -- commit points both ways with the JAX package ----------------------------


COMMIT_CONFIGS = [
    ("classic-int8", FakeWordsConfig(quantization=50), JFakeWordsConfig(quantization=50),
     {"rerank_store": "int8", "primary_postings": "int8"}, False),
    ("dot", FakeWordsConfig(quantization=50, scoring="dot"),
     JFakeWordsConfig(quantization=50, scoring="dot"), {}, True),
    ("lsh", LexicalLshConfig(buckets=64, hashes=2), JLexicalLshConfig(buckets=64, hashes=2),
     {"rerank_store": "none"}, True),
]


@pytest.mark.parametrize("name,cfg,jcfg,knobs,exact", COMMIT_CONFIGS,
                         ids=[c[0] for c in COMMIT_CONFIGS])
def test_commits_open_both_ways_with_the_jax_package(name, cfg, jcfg, knobs, exact, rng,
                                                     tmp_path):
    """A JAX-written commit (deletes, metadata, source sidecars where the
    store drops the originals) opens in the port's SegmentedAnnIndex.load
    and IndexWriter.open; a port-written one opens in the JAX package's
    unchanged SegmentedAnnIndex.load.  Their searches agree (integer modes
    bit for bit, classic under the near-tie rule)."""
    a, b = _corpora(rng)
    cat = rng.integers(0, 4, len(a) + len(b)).astype(np.int32)
    dead = rng.choice(len(a) + len(b), size=80, replace=False)
    pred = cat != 2
    rerank = knobs.get("rerank_store") != "none"

    jpath = os.path.join(tmp_path, "jax.ann")
    jw = JIndexWriter(jcfg, path=jpath, merge_policy=None, use_kernel=False, **knobs)
    jw.add(a, metadata={"cat": cat[:len(a)]})
    jw.flush()
    jw.add(b, metadata={"cat": cat[len(a):]})
    jw.delete(dead)
    assert jw.commit() == 1
    jreader = JSegmentedAnnIndex.load(jpath)
    reader = SegmentedAnnIndex.load(jpath, device=CPU)
    assert reader.num_segments == 2 and reader.del_count == len(dead)
    sidecars = knobs.get("rerank_store", "exact") != "exact"
    assert all((s.source is not None) == sidecars for s in reader.segments)
    np.testing.assert_array_equal(reader.global_metadata().values[:, 0].numpy(), cat)
    for fm in (None, pred):
        js, ji = jreader.search(jnp.asarray(a[:8]), k=10, depth=50, rerank=rerank,
                                use_kernel=False, packed=False,
                                filter_mask=None if fm is None else jnp.asarray(fm))
        got = reader.search(a[:8], k=10, depth=50, rerank=rerank, filter_mask=fm)
        assert_topk_match(got, (js, ji), exact=exact and not rerank)

    # the port continues the JAX lineage; the JAX package reads the result
    w = IndexWriter.open(jpath, device=CPU)
    assert (w.rerank_store, w.primary_postings) == (
        knobs.get("rerank_store", "exact"), knobs.get("primary_postings", "fp32"))
    w.add(a[:40], metadata={"cat": cat[:40]})
    w.delete([1, 2, 3])
    assert w.commit() == 2
    back = JSegmentedAnnIndex.load(jpath)
    mine = SegmentedAnnIndex.load(jpath, device=CPU)
    assert back.num_segments == mine.num_segments == 3
    np.testing.assert_array_equal(back.live_global_ids(), mine.live_global_ids())
    js, ji = back.search(jnp.asarray(b[:8]), k=10, depth=50, rerank=rerank, use_kernel=False,
                         packed=False)
    assert_topk_match(mine.search(b[:8], k=10, depth=50, rerank=rerank), (js, ji),
                      exact=exact and not rerank)
