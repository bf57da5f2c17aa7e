"""Filtered search in the port (``DocMetadata``, ``search(filt=)``,
``FilterMask``, blockmax's stage-2 mask, the k-d tree's post-filter, and
metadata in save / load) against the JAX package's, on the CPU route.

The port's index is the JAX index carried across (``jann.save`` ->
``AnnIndex.load``), so both sides search the same arrays, and the match
stages are compared on the JAX encoder's query operand.  Integer-scored
modes (dot over the int8 tf, LSH) must be bit-equal; float modes follow
the near-tie rule of ``torch_parity.assert_topk_match``.  The JAX side runs
its plain (XLA) path.  Masks are "nonzero = keep" of any integer dtype, as
in ``tests/test_filtered.py``.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_topk_match, to_torch

from repro.core import bruteforce as jbruteforce
from repro.core import eval as jev
from repro.core import pipeline as jpl
from repro.core.index import AnnIndex as JAnnIndex
from repro.core.types import BruteForceConfig as JBruteForceConfig
from repro.core.types import DocMetadata as JDocMetadata
from repro.core.types import FakeWordsConfig as JFakeWordsConfig
from repro.core.types import KdTreeConfig as JKdTreeConfig
from repro.core.types import LexicalLshConfig as JLexicalLshConfig
from repro_torch.core import builder, bruteforce
from repro_torch.core import eval as ev
from repro_torch.core import pipeline as pl
from repro_torch.core.index import AnnIndex, index_from_numpy
from repro_torch.core.types import DocMetadata, FakeWordsConfig

SELECTIVITIES = (0.01, 0.1, 0.5)
N = 1024

# (id, JAX config, build knobs, integer match scores)
FILTER_CONFIGS = [
    ("fakewords-classic-fp32", JFakeWordsConfig(quantization=40), {}, False),
    ("fakewords-classic-int8", JFakeWordsConfig(quantization=40),
     {"primary_postings": "int8", "rerank_store": "int8"}, False),
    ("fakewords-classic-int4", JFakeWordsConfig(quantization=40),
     {"primary_postings": "int4", "rerank_store": "int8"}, False),
    ("fakewords-dot-fp32", JFakeWordsConfig(quantization=40, scoring="dot"), {}, True),
    ("fakewords-dot-int8", JFakeWordsConfig(quantization=40, scoring="dot"),
     {"primary_postings": "int8", "rerank_store": "int8"}, True),
    ("lsh-fp32", JLexicalLshConfig(buckets=64, hashes=2), {}, True),
    ("kdtree-scan-fp32", JKdTreeConfig(dims=8, backend="scan"), {}, False),
    ("bruteforce-fp32", JBruteForceConfig(), {}, False),
]
_IDS = [c[0] for c in FILTER_CONFIGS]


def _mask(n, ratio, rng=None, min_keep=16):
    """Random int32 keep bitmap at ``ratio`` selectivity with >= min_keep
    kept (``tests/test_filtered.py``'s)."""
    rng = rng or np.random.default_rng(int(ratio * 1000) + 7)
    m = (rng.random(n) < ratio).astype(np.int32)
    short = min_keep - int(m.sum())
    if short > 0:
        m[rng.choice(np.flatnonzero(m == 0), short, replace=False)] = 1
    return m


@pytest.fixture(scope="module")
def carried(small_corpus, tmp_path_factory):
    """(JAX index, the port's index loaded from its save), built once per
    (config id, N, extra knobs)."""
    cache = {}

    def get(name, jcfg=None, knobs=None, n=N):
        key = (name, n)
        if key not in cache:
            if jcfg is None:
                _, jcfg, knobs, _ = FILTER_CONFIGS[_IDS.index(name)]
            jidx = JAnnIndex.build(jnp.asarray(small_corpus[:n]), jcfg, **(knobs or {}))
            path = str(tmp_path_factory.mktemp("carried") / f"{name}.ann")
            jidx.save(path)
            cache[key] = (jidx, AnnIndex.load(path, device="cpu"))
        return cache[key]

    return get


def _query_rep(jidx, q):
    """The match stage's query operand from the JAX encoder: both packages'
    matchers then see the same bits."""
    jrep = jidx.pipeline.encoder(jidx.index, jbruteforce.l2_normalize(jnp.asarray(q)))
    return jrep, to_torch(jrep)


def _all_kept(ids, mask) -> bool:
    ids = np.asarray(ids)
    keep = np.asarray(mask)
    if keep.ndim == 1:
        keep = np.broadcast_to(keep, (ids.shape[0], keep.shape[0]))
    bits = np.take_along_axis(keep, np.maximum(ids, 0), axis=1)
    return bool(((ids < 0) | (bits != 0)).all())


@pytest.mark.parametrize("ratio", SELECTIVITIES)
@pytest.mark.parametrize("name,jcfg,knobs,exact", FILTER_CONFIGS, ids=_IDS)
def test_filtered_match_matches_jax(carried, small_corpus, name, jcfg, knobs, exact, ratio):
    """Every encoding's filtered match stage on the port's CPU route against
    the JAX one at 1% / 10% / 50% (masks with fewer kept docs than the
    depth pad with (-inf, -1)); the facade's ids are all kept."""
    jidx, idx = carried(name)
    q = small_corpus[:8]
    m = _mask(N, ratio)
    jrep, rep = _query_rep(jidx, q)
    want = jidx.pipeline.matcher(jidx.index, jrep, 64 if exact else 65, use_kernel=False,
                                 filt=jnp.asarray(m))
    got = idx.pipeline.matcher(idx.index, rep, 64, filt=torch.from_numpy(m) != 0)
    assert_topk_match(got, (to_torch(want[0]), to_torch(want[1])), exact=exact)
    assert _all_kept(got[1], m)
    if int(m.sum()) < 64:  # the kept docs, then padding
        assert (got[1][:, int(m.sum()):] == -1).all()
    s, i = idx.search(q, k=10, depth=64, filt=m)
    assert _all_kept(i, m) and not bool(s.isnan().any())
    js, ji = jidx.search(jnp.asarray(q), k=10, depth=64, use_kernel=False, filt=jnp.asarray(m))
    if name.startswith("kdtree"):  # the two encoders' reduced points differ by ~1e-6
        np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)
        assert float(ev.overlap(to_torch(ji), i)) >= 0.95
    else:
        assert_topk_match((s, i), (to_torch(js), to_torch(ji)), exact=exact)


@pytest.mark.parametrize("ratio", SELECTIVITIES)
@pytest.mark.parametrize("postings", ["fp32", "int4"])
def test_filtered_blockmax_every_block_equals_dense_and_jax(carried, small_corpus, postings,
                                                            ratio):
    """At every block kept, filtered blockmax equals the dense filtered
    search: stage 1's bounds stay unfiltered (admissible), stage 2 masks
    (K3 over fp32 rows, K5 over int4 ones).  The port's blockmax also
    matches the JAX package's."""
    knobs = {} if postings == "fp32" else {"primary_postings": "int4", "rerank_store": "int8"}
    jcfg = JFakeWordsConfig(quantization=40)
    jdense, dense = carried(f"classic-{postings}", jcfg, knobs, n=512)
    jbm, bm = carried(f"classic-{postings}-bm", jcfg,
                      dict(knobs, blockmax_keep=8, blockmax_block_size=64), n=512)
    assert bm.bm.num_blocks == 8 and bm.blockmax_keep == 8
    m = _mask(512, ratio)
    q = small_corpus[:8]
    got = bm.search(q, k=50, depth=50, filt=m)
    assert _all_kept(got[1], m)
    assert_topk_match(got, dense.search(q, k=51, depth=51, filt=m), exact=False)
    js, ji = jbm.search(jnp.asarray(q), k=51, depth=51, use_kernel=False, filt=jnp.asarray(m))
    assert_topk_match(got, (to_torch(js), to_torch(ji)), exact=False)


@pytest.mark.parametrize("ratio", SELECTIVITIES)
def test_filtered_bruteforce_is_exact_and_recall_matches_jax(carried, small_corpus, ratio):
    """Filtered brute force equals the exact top-k over the kept rows only,
    mapped back to global ids; ``recall_at(filter_mask=)`` equals JAX's."""
    jidx, idx = carried("bruteforce-fp32")
    q = small_corpus[:8]
    m = _mask(N, ratio)
    s, i = idx.search(q, k=10, depth=64, filt=m)
    kept = np.flatnonzero(m)
    kk = min(10, len(kept))
    ts, ti = bruteforce.exact_topk(torch.from_numpy(small_corpus[kept]), torch.from_numpy(q),
                                   kk)
    truth = torch.from_numpy(kept)[ti.long()].to(torch.int32)
    assert_topk_match((s[:, :kk], i[:, :kk]), (ts, truth), exact=False)
    assert float(ev.recall_at(truth, i[:, :kk], filter_mask=torch.from_numpy(m))) == 1.0
    full = idx.search(q, k=10, depth=64)[1]
    for truth_ids, got_ids in ((truth, i), (full, i), (full, truth)):
        want = jev.recall_at(jnp.asarray(truth_ids.numpy()), jnp.asarray(got_ids.numpy()),
                             filter_mask=jnp.asarray(m))
        assert float(ev.recall_at(truth_ids, got_ids, filter_mask=torch.from_numpy(m))) == \
            pytest.approx(float(want), abs=1e-7)


@pytest.mark.parametrize("name,jcfg,knobs,exact", FILTER_CONFIGS, ids=_IDS)
def test_all_ones_mask_matches_unfiltered_bitwise(carried, small_corpus, name, jcfg, knobs,
                                                  exact):
    """An all-keep mask reproduces the unfiltered search bit for bit."""
    _, idx = carried(name)
    q = small_corpus[:8]
    s0, i0 = idx.search(q, k=10, depth=64)
    s1, i1 = idx.search(q, k=10, depth=64, filt=np.ones(N, np.int32))
    assert torch.equal(i0, i1) and torch.equal(s0, s1)


@pytest.mark.parametrize("rerank", [False, True])
@pytest.mark.parametrize("name", ["fakewords-classic-fp32", "fakewords-classic-int8",
                                  "lsh-fp32"])
def test_all_docs_filtered_returns_padding_no_nans(carried, small_corpus, name, rerank):
    """An all-zeros mask gives only (-inf, -1), with no NaN, through the
    match stage and the rerank (exact or from the int8 store)."""
    _, idx = carried(name)
    s, i = idx.search(small_corpus[:4], k=10, depth=50, rerank=rerank,
                      filt=np.zeros(N, np.int32))
    assert (i == -1).all() and not bool(s.isnan().any()) and (s == -torch.inf).all()


@pytest.mark.parametrize("ratio", SELECTIVITIES)
def test_filter_mask_native_equals_inflated_and_jax(carried, small_corpus, ratio):
    """FilterMask native=True (the mask in the kernel) returns the ids of
    native=False (depth + extra candidates, masked and re-reduced), and both
    the JAX package's FilterMask's."""
    jidx, idx = carried("fakewords-classic-fp32")
    jrep, rep = _query_rep(jidx, small_corpus[:8])
    m = _mask(N, ratio)
    fm = pl.FilterMask(inner=idx.pipeline.matcher, extra=N)
    jfm = jpl.FilterMask(inner=jidx.pipeline.matcher, extra=N)
    native = fm(idx.index, rep, 50, m, native=True)
    inflated = fm(idx.index, rep, 50, torch.from_numpy(m), native=False)
    assert torch.equal(native[1], inflated[1]) and torch.equal(native[0], inflated[0])
    for nat in (True, False):
        js, ji = jfm(jidx.index, jrep, 51, jnp.asarray(m), use_kernel=False, native=nat)
        assert_topk_match(native, (to_torch(js), to_torch(ji)), exact=False)
    assert pl.LiveDocsMatcher is pl.FilterMask
    with pytest.raises(ValueError, match="filter mask"):
        fm(idx.index, rep, 50, m[:-1], native=True)


@pytest.mark.parametrize("name", ["fakewords-classic-fp32", "fakewords-dot-fp32"])
def test_per_query_masks_match_per_row_masks(carried, small_corpus, name):
    """A (B, N) mask gives row r what query r alone gives with its own (N,)
    mask."""
    _, idx = carried(name)
    q = small_corpus[:4]
    rows = [_mask(N, r, np.random.default_rng(i)) for i, r in enumerate((0.05, 0.1, 0.3, 0.8))]
    s_b, i_b = idx.search(q, k=10, depth=50, filt=np.stack(rows))
    assert _all_kept(i_b, np.stack(rows))
    for r in range(4):
        got = (s_b[r:r + 1], i_b[r:r + 1])
        want = idx.search(q[r:r + 1], k=11, depth=51, filt=rows[r])
        assert_topk_match(got, want, exact=name.endswith("dot-fp32"))


@pytest.mark.parametrize("shape", ["shared", "per-query"])
def test_mask_dtypes_and_containers_give_the_same_result(carried, small_corpus, shape):
    """bool, uint8 and int32 masks, as tensors or numpy arrays, search the
    same; a mask of another shape raises ValueError."""
    _, idx = carried("fakewords-classic-int8")
    q = small_corpus[:4]
    m = _mask(N, 0.1) if shape == "shared" else np.stack(
        [_mask(N, 0.1, np.random.default_rng(i)) for i in range(4)])
    m[..., :3] = 2  # nonzero, not one, still keeps
    base = idx.search(q, k=10, depth=50, filt=m)
    for other in (m != 0, (m != 0).astype(np.uint8), torch.from_numpy(m),
                  torch.from_numpy(m != 0), torch.from_numpy(m).to(torch.uint8)):
        s, i = idx.search(q, k=10, depth=50, filt=other)
        assert torch.equal(s, base[0]) and torch.equal(i, base[1])
    for bad in (m[..., :-1], np.ones((3, N), np.int32), np.ones((4, 2, N), np.int32)):
        with pytest.raises(ValueError, match="filter mask"):
            idx.search(q, k=10, depth=50, filt=bad)


@pytest.mark.parametrize("ratio", SELECTIVITIES)
def test_kd_tree_post_filter_matches_jax(carried, small_corpus, ratio):
    """The tree backend masks its depth candidates after the DFS: its result
    is ``mask_and_topk`` of its own unfiltered one, and the JAX package's."""
    jidx, idx = carried("kdtree-tree", JKdTreeConfig(dims=8, backend="tree"), {})
    jrep, rep = _query_rep(jidx, small_corpus[:8])
    m = _mask(N, ratio)
    filt = torch.from_numpy(m) != 0
    got = idx.pipeline.matcher(idx.index, rep, 50, filt=filt)
    s, i = idx.pipeline.matcher(idx.index, rep, 50)
    keep = (i >= 0) & pl.lookup_filt_bits(filt, i)
    post = pl.mask_and_topk(s, i, keep, 50, N)
    assert torch.equal(got[0], post[0]) and torch.equal(got[1], post[1])
    js, ji = jidx.pipeline.matcher(jidx.index, jrep, 50, use_kernel=False, filt=jnp.asarray(m))
    assert_topk_match(got, (to_torch(js), to_torch(ji)), exact=False)
    assert _all_kept(got[1], m)


def test_doc_metadata_masks_match_jax():
    """DocMetadata's predicates equal the JAX package's on the same fields;
    ``build_metadata`` stacks a mapping, keeps a DocMetadata and refuses a
    row-count mismatch."""
    rng = np.random.default_rng(3)
    fields = {"cat": rng.integers(0, 5, 300), "year": rng.integers(2000, 2020, 300)}
    md = DocMetadata.from_fields(fields)
    jmd = JDocMetadata.from_fields(fields)
    assert md.field_names == jmd.field_names == ("cat", "year") and md.num_docs == 300
    assert md.values.dtype == torch.int32 and md.nbytes() == jmd.nbytes()
    np.testing.assert_array_equal(md.values.numpy(), np.asarray(jmd.values))
    for got, want in ((md.eq_mask("cat", 2), jmd.eq_mask("cat", 2)),
                      (md.in_mask("cat", (0, 3)), jmd.in_mask("cat", (0, 3))),
                      (md.in_mask("cat", ()), jmd.in_mask("cat", ())),
                      (md.range_mask("year", 2005, 2010), jmd.range_mask("year", 2005, 2010)),
                      (md.range_mask("year", lo=2015), jmd.range_mask("year", lo=2015)),
                      (md.range_mask("year", hi=2003), jmd.range_mask("year", hi=2003)),
                      (md.range_mask("year"), jmd.range_mask("year"))):
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert builder.build_metadata(None, 300) is None
    assert builder.build_metadata(md, 300) is md
    assert torch.equal(builder.build_metadata(fields, 300).values, md.values)
    with pytest.raises(ValueError, match="metadata has 300 rows but the corpus has 299"):
        builder.build_metadata(fields, 299)


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_save_load_with_metadata_both_ways(small_corpus, tmp_path, direction):
    """A save with metadata opens in the other package, and the filtered
    ids built from the loaded metadata are the same."""
    n = 512
    v = small_corpus[:n]
    rng = np.random.default_rng(31)
    fields = {"cat": rng.integers(0, 4, n), "year": rng.integers(2000, 2020, n)}
    path = os.path.join(tmp_path, "md.ann")
    if direction == "jax-to-port":
        src = JAnnIndex.build(jnp.asarray(v), JFakeWordsConfig(quantization=40), metadata=fields)
        src.save(path)
        dst = AnnIndex.load(path, device="cpu")
        jidx, idx = src, dst
    else:
        src = AnnIndex.build(v, FakeWordsConfig(quantization=40), metadata=fields, device="cpu")
        src.save(path)
        meta = json.loads(open(os.path.join(path, "config.json")).read())
        assert meta["metadata"] == {"field_names": ["cat", "year"]}
        assert "metadata.values" not in meta["dtypes"]
        dst = JAnnIndex.load(path)
        jidx, idx = dst, src
    assert idx.metadata.field_names == tuple(jidx.metadata.field_names) == ("cat", "year")
    np.testing.assert_array_equal(idx.metadata.values.numpy(), np.asarray(jidx.metadata.values))
    filt = idx.metadata.eq_mask("cat", 2) & idx.metadata.range_mask("year", 2005, 2015)
    jfilt = jidx.metadata.eq_mask("cat", 2) & jidx.metadata.range_mask("year", 2005, 2015)
    s, i = idx.search(v[:4], k=10, depth=64, filt=filt)
    js, ji = jidx.search(jnp.asarray(v[:4]), k=11, depth=64, use_kernel=False,
                         filt=jfilt.astype(jnp.int32))
    assert_topk_match((s, i), (to_torch(js), to_torch(ji)), exact=False)
    assert _all_kept(i, filt.numpy())
    # values without the field names that say what they are: refused
    meta = json.loads(open(os.path.join(path, "config.json")).read())
    with np.load(os.path.join(path, "index.npz")) as z:
        arrays = {name: z[name] for name in z.files}
    with pytest.raises(ValueError, match="without the metadata field names"):
        index_from_numpy(meta["method"], meta["config"], arrays, meta["dtypes"], device="cpu")
    # a port-side round trip is bit for bit
    path2 = os.path.join(tmp_path, "again.ann")
    idx.save(path2)
    again = AnnIndex.load(path2, device="cpu")
    assert torch.equal(again.metadata.values, idx.metadata.values)
    s2, i2 = again.search(v[:4], k=10, depth=64, filt=filt)
    assert torch.equal(s, s2) and torch.equal(i, i2)
