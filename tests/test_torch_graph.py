"""The port's proximity-graph encoding ("hnsw", ``repro_torch.core.graph``)
against the JAX package's (``repro.core.graph``): the build stage by stage,
the batched beam search with and without a filter, the facade, save and load
both ways, and graph segments through ``IndexWriter``.

Inputs are made from numpy seeds and go to both packages; every test makes
its own generator.  On integer-valued rows every product and sum is exact
in f32 in both packages, so the build (pools, prune, reverse edges, entry
points) and the search (ids, scores, scored rows) are held bit for bit.
The JAX side searches on its kernel path (``use_kernel=True``: K3 in
interpret mode), whose blocks come back sorted by (score desc, id asc) as
the port's K3 returns them; its XLA path leaves a block in gather order,
so equal scores can keep other ids.  On unit rows f32 products round
differently in the two packages: adjacency rows are held to >= 99%
equality (a differing row must sit at a near tie of its pool), ids on the
same adjacency exactly and scores within 1e-6.
"""
import dataclasses
import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_topk_match, to_torch

from repro.core import bruteforce as jbruteforce
from repro.core import graph as jgraph
from repro.core.index import AnnIndex as JAnnIndex
from repro.core.segments import IndexWriter as JIndexWriter
from repro.core.types import GraphConfig as JGraphConfig
from repro_torch.core import bruteforce, graph
from repro_torch.core import eval as ev
from repro_torch.core import pipeline as pl
from repro_torch.core.index import AnnIndex
from repro_torch.core.segments import IndexWriter
from repro_torch.core.types import GraphConfig

CPU = "cpu"
# (port config, JAX config): the defaults, and the reference tests' WIDE
# operating point (ef 320, beam 16: 512-row blocks, 40 iterations).
CONFIGS = {
    "default": (GraphConfig(), JGraphConfig()),
    "wide": (GraphConfig(ef=320, beam=16), JGraphConfig(ef=320, beam=16)),
}
# A small graph that exercises other degrees, a strict prune and fewer entries.
SMALL = dict(degree=6, reverse_degree=3, ef_construction=20, alpha=1.0, ef=24, beam=3,
             entries=3)


def _integer_rows(n=1000, dim=16, seed=0):
    """Rows with entries in {-2, ..., 2} and some duplicate rows (ties in
    every stage): every f32 product and sum over them is exact."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-2, 3, size=(n, dim)).astype(np.float32)
    x[n // 2:n // 2 + 20] = x[100:120]
    return x


def _unit_rows(n=2000, dim=64, seed=0):
    """Unit rows of the reference tests' corpus (a shared offset), as both
    packages normalise them."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, dim)).astype(np.float32)
    x += 0.5 * rng.normal(size=(1, dim)).astype(np.float32)
    return np.asarray(jbruteforce.l2_normalize(jnp.asarray(x)))


@functools.lru_cache(maxsize=None)
def _jax_integer_graph():
    """JAX's build of :func:`_integer_rows` at the default config (numpy)."""
    nb, entry = jgraph.build_graph(jnp.asarray(_integer_rows()), JGraphConfig())
    return np.asarray(nb), np.asarray(entry)


@functools.lru_cache(maxsize=None)
def _jax_unit_index():
    """JAX's index of :func:`_unit_rows` at the default config; the WIDE
    config builds the same graph (it changes only search knobs)."""
    return JAnnIndex.build(jnp.asarray(_unit_rows()), JGraphConfig(), use_kernel=True)


def _queries(b, dim, seed, integer=False):
    rng = np.random.default_rng(seed)
    if integer:
        return rng.integers(-2, 3, size=(b, dim)).astype(np.float32)
    return rng.normal(size=(b, dim)).astype(np.float32)


def _jax_search(v, nb, entry, q, depth, cfg, n, filt=None):
    return jgraph.search_graph(jnp.asarray(v), jnp.asarray(nb), jnp.asarray(entry),
                               jnp.asarray(q), depth, ef=cfg.ef, beam=cfg.beam,
                               iters=cfg.search_iters, n_docs=n, use_kernel=True,
                               filt=None if filt is None else jnp.asarray(filt),
                               with_stats=True)


# -- (a) the build, stage by stage, on integer-valued rows -------------------


@pytest.mark.parametrize("kind", ["default", "small"])
def test_integer_build_bit_equal_to_jax_stage_by_stage(kind):
    cfg = GraphConfig() if kind == "default" else GraphConfig(**SMALL)
    jcfg = JGraphConfig() if kind == "default" else JGraphConfig(**SMALL)
    x = _integer_rows()
    n = x.shape[0]
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    m = min(cfg.ef_construction, n - 1)
    js, ji = jgraph._knn_pools(jx, jnp.arange(n, dtype=jnp.int32), jx, 0, m, jcfg.build_tile)
    s, i = graph._knn_pools(tx, m)
    assert torch.equal(s, to_torch(js)) and torch.equal(i, to_torch(ji))
    # the prune on JAX's pools
    jfs, jfi = jgraph._prune_all(jx, js, ji, jx, jcfg.degree, jcfg.alpha)
    fs, fi = graph._prune_all(to_torch(js), to_torch(ji), tx, cfg.degree, cfg.alpha)
    assert torch.equal(fs, to_torch(jfs)) and torch.equal(fi, to_torch(jfi))
    # the reverse pass on JAX's forward lists
    jrev = jgraph._reverse_edges(jfi, jfs, n, jcfg.reverse_degree)
    rev = graph._reverse_edges(to_torch(jfi), to_torch(jfs), n, cfg.reverse_degree)
    assert torch.equal(rev, to_torch(jrev))
    assert torch.equal(graph._entry_points(tx, cfg.entries),
                       to_torch(jgraph._entry_points(jx, jcfg.entries)))
    # the whole build
    jnb, jentry = (_jax_integer_graph() if kind == "default"
                   else jgraph.build_graph(jx, jcfg))
    nb, entry = graph.build_graph(tx, cfg)
    assert nb.dtype == torch.int32 and nb.shape == (n, cfg.total_degree)
    assert torch.equal(nb, to_torch(jnb)) and torch.equal(entry, to_torch(jentry))


# -- (b) the search on JAX's adjacency, integer-valued rows ------------------


@pytest.mark.parametrize("mask", [None, "shared", "per-query"])
def test_integer_search_bit_equal_to_jax_kernel_path(mask):
    x = _integer_rows()
    n = x.shape[0]
    cfg = GraphConfig()
    jnb, jentry = _jax_integer_graph()
    q = _queries(6, x.shape[1], seed=1, integer=True)
    rng = np.random.default_rng(2)
    filt = None
    if mask == "shared":
        filt = rng.random(n) < 0.3
    elif mask == "per-query":
        filt = rng.random((q.shape[0], n)) < 0.3
    depth = 20
    js, ji, jscored = _jax_search(x, jnb, jentry, q, depth, cfg, n, filt)
    s, i, scored = graph.search_graph(
        torch.from_numpy(x), to_torch(jnb), to_torch(jentry), torch.from_numpy(q), depth,
        ef=cfg.ef, beam=cfg.beam, iters=cfg.search_iters, n_docs=n,
        filt=None if filt is None else torch.from_numpy(filt), with_stats=True)
    assert torch.equal(i, to_torch(ji)) and torch.equal(s, to_torch(js))
    assert torch.equal(scored, to_torch(jscored))
    if filt is not None:
        keep = torch.from_numpy(filt if filt.ndim == 2 else np.broadcast_to(filt, (6, n)).copy())
        assert bool(torch.gather(keep, 1, i.clamp_min(0).long())[i >= 0].all())


# -- (c) unit rows: both packages' builds, facade, the same adjacency --------


@pytest.mark.parametrize("kind", ["default", "wide"])
def test_unit_rows_match_jax(kind, tmp_path):
    cfg, jcfg = CONFIGS[kind]
    v = _unit_rows()
    n = v.shape[0]
    jidx = dataclasses.replace(_jax_unit_index(), config=jcfg)
    idx = AnnIndex.build(v, cfg, device=CPU)
    jnb = np.asarray(jidx.index.neighbors)
    same = (idx.index.neighbors.numpy() == jnb).all(axis=1)
    assert same.mean() >= 0.99, same.mean()
    m = min(cfg.ef_construction, n - 1)
    pool_s, _ = graph._knn_pools(torch.from_numpy(v), m)
    for row in np.flatnonzero(~same):  # a differing row sits at a near tie of its pool
        gaps = np.abs(np.diff(pool_s[row].numpy()))
        assert gaps.min() <= 1e-6, (row, gaps.min())
    assert torch.equal(idx.index.entry, to_torch(jidx.index.entry))

    q = _queries(16, v.shape[1], seed=3)
    _, truth = jbruteforce.exact_topk(jnp.asarray(v), jnp.asarray(q), 10, use_kernel=False)
    js, ji = jidx.search(jnp.asarray(q), k=10, depth=10)
    _, i = idx.search(q, k=10, depth=10)
    r_jax = float(ev.recall_at(to_torch(truth), to_torch(ji)))
    r_port = float(ev.recall_at(to_torch(truth), i))
    assert abs(r_jax - r_port) <= 0.01, (r_jax, r_port)
    # on JAX's own adjacency: ids equal, scores within 1e-6
    path = os.path.join(tmp_path, "jax.ann")
    jidx.save(path)
    carried = AnnIndex.load(path, device=CPU)
    assert carried.method == "hnsw" and carried.config == cfg
    s, i = carried.search(q, k=10, depth=10)
    assert torch.equal(i, to_torch(ji))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=0, atol=1e-6)


# -- (d) the reference's properties ------------------------------------------


def test_build_deterministic_and_search_properties():
    v = _unit_rows(n=1500, dim=32, seed=4)
    cfg = GraphConfig(ef=96, beam=6)
    tv = torch.from_numpy(v)
    nb1, e1 = graph.build_graph(tv, cfg)
    nb2, e2 = graph.build_graph(tv, cfg)
    assert torch.equal(nb1, nb2) and torch.equal(e1, e2)
    n = v.shape[0]
    assert bool(((nb1 >= -1) & (nb1 < n)).all())
    assert bool((nb1 != torch.arange(n, dtype=torch.int32)[:, None]).all())
    idx = AnnIndex.build(v, cfg, device=CPU)
    q = torch.from_numpy(v[:32] + 0.01)
    _, truth = bruteforce.exact_topk(tv, bruteforce.l2_normalize(q), 10)
    s, i, scored = graph.search_graph(
        idx.index.vectors, idx.index.neighbors, idx.index.entry, bruteforce.l2_normalize(q),
        10, ef=cfg.ef, beam=cfg.beam, iters=cfg.search_iters, n_docs=n, with_stats=True)
    assert float(ev.recall_at(truth, i)) >= 0.95
    assert bool((scored <= cfg.entries + cfg.search_iters * cfg.beam * cfg.total_degree).all())
    assert bool((s[:, 1:] <= s[:, :-1]).all()) and bool(((i >= 0) & (i < n)).all())
    assert torch.equal(idx.search(q, k=10, depth=10)[1], i)
    # rerank of the graph's candidates from the stored unit rows
    rs, ri = idx.search(q, k=10, depth=50, rerank=True)
    assert bool((rs[:, 1:] <= rs[:, :-1]).all()) and ri.shape == (32, 10)
    # a filter: masked nodes route the walk and are never emitted
    mask = np.random.default_rng(5).random(n) < 0.2
    fs, fi = idx.search(q, k=10, depth=10, filt=mask)
    assert mask[fi.numpy()[fi.numpy() >= 0]].all() and bool((fi >= 0).all())
    with pytest.raises(ValueError, match="not supported for hnsw"):
        AnnIndex(config=cfg, index=idx.index, blockmax_keep=4)
    with pytest.raises(ValueError, match="quantized primary postings"):
        AnnIndex.build(v, cfg, primary_postings="int8", device=CPU)
    assert isinstance(pl.make_matcher(cfg), pl.GraphMatcher)
    assert pl.make_matcher(cfg).iters == cfg.search_iters == 32  # ceil(2 ef / beam)


# -- (e) save and load, both ways --------------------------------------------


@pytest.mark.parametrize("store", ["exact", "int8"])
def test_save_load_both_ways(tmp_path, store):
    v = _unit_rows(n=800, dim=32, seed=6)
    cfg = GraphConfig(ef=48, beam=4)
    idx = AnnIndex.build(v, cfg, rerank_store=store, device=CPU)
    assert idx.nbytes() == sum(t.numel() * t.element_size() for t in (
        idx.index.vectors, idx.index.neighbors, idx.index.entry)) + (
        0 if idx.index.vq is None else idx.index.vq.nbytes())
    path = os.path.join(tmp_path, "port.ann")
    idx.save(path)
    q = _queries(8, v.shape[1], seed=7)
    want = idx.search(q, k=10, depth=20, rerank=True)
    back = AnnIndex.load(path, device=CPU)
    assert back.quantized_rerank == (store == "int8")
    got = back.search(q, k=10, depth=20, rerank=True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # the JAX package reads the port's save; its kernel path finds the same
    jidx = JAnnIndex.load(path, use_kernel=True)
    assert type(jidx.config).__name__ == "GraphConfig" and jidx.num_docs == 800
    np.testing.assert_array_equal(np.asarray(jidx.index.neighbors), idx.index.neighbors.numpy())
    if store == "int8":  # the int8 store's arrays; the search is the exact case's
        np.testing.assert_array_equal(np.asarray(jidx.index.vq.q), idx.index.vq.q.numpy())
        return
    js, ji = jidx.search(jnp.asarray(q), k=10, depth=20)
    s, i = idx.search(q, k=10, depth=20)
    assert torch.equal(i, to_torch(ji))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=0, atol=1e-6)


# -- (f) segments -------------------------------------------------------------


def test_segments_match_jax_reader_and_native_livedocs():
    v = _unit_rows(n=1200, dim=32, seed=8)
    n = v.shape[0]
    cfg, jcfg = GraphConfig(ef=96, beam=8), JGraphConfig(ef=96, beam=8)
    dead = np.random.default_rng(9).choice(n, n // 20, replace=False)
    w = IndexWriter(cfg, merge_policy=None, device=CPU)
    jw = JIndexWriter(jcfg, merge_policy=None, use_kernel=False)
    for part in np.array_split(v, 3):
        w.add(part)
        w.flush()
        jw.add(part)
        jw.flush()
    w.delete(dead.tolist())
    jw.delete(dead.tolist())
    reader, jreader = w.refresh(), jw.refresh()
    assert reader.num_segments == 3 and reader.packed_segments() is None
    assert "no packed layout" in reader._packed_err
    q = _queries(8, v.shape[1], seed=10)
    for rerank in (False, True):
        got = reader.search(q, k=10, depth=40, rerank=rerank)
        js, ji = jreader.search(jnp.asarray(q), k=10, depth=40, rerank=rerank,
                                use_kernel=False, packed=False)
        assert not np.isin(got[1].numpy(), dead).any()
        assert torch.equal(got[1], to_torch(ji))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(js), rtol=0, atol=1e-6)
    # native liveDocs (the traversal's filt) against depth inflation
    p = pl.SearchParams(k=10, depth=40)
    q_norm = bruteforce.l2_normalize(torch.from_numpy(q))
    views, matcher = reader._ensure_views()
    native = reader._loop(q_norm, p, None, matcher)
    inflated = reader._loop(q_norm, p, None, matcher, native=False)
    assert torch.equal(native[0], inflated[0]) and torch.equal(native[1], inflated[1])
    # force_merge(1): one fully-live segment, a fresh build of the live rows
    w.force_merge(1)
    jw.force_merge(1)
    merged, jmerged = w.refresh(), jw.refresh()
    assert merged.num_segments == 1 and merged.del_count == 0
    got = merged.search(q, k=10, depth=40)
    js, ji = jmerged.search(jnp.asarray(q), k=10, depth=40, use_kernel=False, packed=False)
    assert_topk_match(got, (js, ji), exact=False, rtol=0, atol=1e-6)
    mono = AnnIndex.build(v[np.setdiff1d(np.arange(n), dead)], cfg, device=CPU)
    want = mono.search(q, k=10, depth=40)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
