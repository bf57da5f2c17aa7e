"""The six ANN helpers (``fakewords.doc_stats`` / ``build`` / ``search``,
``lexical_lsh.search``, ``blockmax.pruned_topk``, ``eval.recall_curve``)
against the JAX package's, on the CPU route.

The searches run over the port's index container holding the JAX index's
own arrays, so both sides score the same data; the JAX side runs its plain
(XLA) path.  Integer modes (df, dot, LSH) are held bit for bit; classic
match and the f32 rerank by the near-tie rule of ``torch_parity``
(``assert_topk_match``: scores within 1e-5, ids equal away from
near-ties).  The wrappers are held to the port's own ``AnnIndex.search``
bit for bit (``tests/test_pipeline.py:168-200``; its k-d tree part is in
``test_torch_kdtree.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_topk_match, to_torch

from repro.core import blockmax as jblockmax
from repro.core import bruteforce as jbruteforce
from repro.core import eval as jeval
from repro.core import fakewords as jfakewords
from repro.core import lexical_lsh as jlexical_lsh
from repro.core.index import AnnIndex as JAnnIndex
from repro.core.types import FakeWordsConfig as JFakeWordsConfig
from repro.core.types import LexicalLshConfig as JLexicalLshConfig
from repro_torch.core import blockmax, bruteforce, fakewords, lexical_lsh
from repro_torch.core import eval as ev
from repro_torch.core.index import AnnIndex
from repro_torch.core.types import FakeWordsConfig, FakeWordsIndex, LexicalLshConfig, LshIndex

CPU = "cpu"


def _port_index(jindex):
    """The port's index container holding the JAX index's arrays."""
    if hasattr(jindex, "sig"):
        return LshIndex(sig=to_torch(jindex.sig), vectors=to_torch(jindex.vectors))
    return FakeWordsIndex(
        tf=to_torch(jindex.tf), idf=to_torch(jindex.idf), norm=to_torch(jindex.norm),
        df=to_torch(jindex.df), vectors=to_torch(jindex.vectors),
        scored=None if jindex.scored is None else to_torch(jindex.scored))


def _queries(corpus, n=16):
    q = corpus[:n]
    return jbruteforce.l2_normalize(jnp.asarray(q)), bruteforce.l2_normalize(torch.from_numpy(q))


def test_doc_stats_equal_jax(small_corpus):
    """df bit for bit; idf and norm (a log and an rsqrt of the same
    integers: the packages' log and division differ) within 2 f32 steps."""
    tf = jfakewords.encode(jbruteforce.l2_normalize(jnp.asarray(small_corpus)), 50)
    want = jfakewords.doc_stats(tf)
    got = fakewords.doc_stats(to_torch(tf))
    assert got[0].dtype == torch.int32 and torch.equal(got[0], to_torch(want[0]))
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == torch.float32
        np.testing.assert_array_max_ulp(g.numpy(), np.asarray(w), maxulp=2)


@pytest.mark.parametrize("scoring", ["classic", "dot"])
def test_build_equals_jax_and_the_facade(small_corpus, scoring):
    """``fakewords.build``'s leaves: the facade's build bit for bit, and
    the JAX build's (tf, df bit for bit; idf, norm within 1 f32 step; the
    bf16 scored within one bf16 ulp of the reference value's own magnitude,
    2^(floor(log2 |want|) - 7): a sum rounded the other way sits one step
    apart, up to 2^-7 of itself just above a power of two)."""
    cfg = FakeWordsConfig(quantization=50, scoring=scoring)
    idx = fakewords.build(torch.from_numpy(small_corpus), cfg)
    facade = AnnIndex.build(small_corpus, cfg, device=CPU).index
    jidx = jfakewords.build(jnp.asarray(small_corpus), JFakeWordsConfig(quantization=50,
                                                                         scoring=scoring))
    for leaf in ("tf", "df", "idf", "norm", "scored", "vectors"):
        got, same, want = getattr(idx, leaf), getattr(facade, leaf), getattr(jidx, leaf)
        assert (got is None) == (same is None) == (want is None), leaf
        if got is None:
            continue
        assert torch.equal(got, same), leaf
        if leaf in ("tf", "df"):
            assert torch.equal(got, to_torch(want)), leaf
        elif got.dtype == torch.bfloat16:
            g, w = got.float().numpy(), to_torch(want).float().numpy()
            with np.errstate(divide="ignore"):
                ulp = np.exp2(np.floor(np.log2(np.abs(w))) - 7)
            assert (np.abs(g - w) <= np.maximum(ulp, 1e-7)).all(), leaf
        else:
            np.testing.assert_allclose(got.float().numpy(), to_torch(want).float().numpy(),
                                       rtol=2**-22, atol=1e-7, err_msg=leaf)
    assert fakewords.build(torch.from_numpy(small_corpus), cfg, keep_vectors=False).vectors is None


@pytest.mark.parametrize("rerank", [False, True])
@pytest.mark.parametrize("scoring", ["classic", "dot"])
def test_fakewords_search_equals_jax(small_corpus, scoring, rerank):
    jcfg = JFakeWordsConfig(quantization=50, scoring=scoring)
    jidx = jfakewords.build(jnp.asarray(small_corpus), jcfg)
    idx = _port_index(jidx)
    jq, q = _queries(small_corpus)
    jq_tf = jfakewords.encode_queries(jq, jcfg, normalized=True)
    kw = dict(k=10, depth=100, scoring=scoring, rerank=rerank)
    got = fakewords.search(idx, to_torch(jq_tf), q, **kw)
    want = jfakewords.search(jidx, jq_tf, jq, **dict(kw, k=11 if rerank else 10),
                             use_kernel=False)
    assert_topk_match(got, [np.asarray(a) for a in want], exact=scoring == "dot" and not rerank)
    # the df-prune keep mask below ratio 1
    got = fakewords.search(idx, to_torch(jq_tf), q, k=10, depth=100, scoring=scoring,
                           df_max_ratio=0.3)
    want = jfakewords.search(jidx, jq_tf, jq, k=10, depth=100, scoring=scoring,
                             df_max_ratio=0.3, use_kernel=False)
    assert_topk_match(got, [np.asarray(a) for a in want], exact=scoring == "dot")


@pytest.mark.parametrize("rerank", [False, True])
def test_lexical_lsh_search_equals_jax(small_corpus, rerank):
    jcfg = JLexicalLshConfig(buckets=64, hashes=2)
    jidx = jlexical_lsh.build(jnp.asarray(small_corpus), jcfg)
    idx = _port_index(jidx)
    jq, q = _queries(small_corpus)
    sig_q = jlexical_lsh.encode(jq, jcfg)
    assert torch.equal(lexical_lsh.encode(q, LexicalLshConfig(buckets=64, hashes=2)),
                       to_torch(sig_q))
    got = lexical_lsh.search(idx, to_torch(sig_q), q, k=10, depth=100, rerank=rerank)
    want = jlexical_lsh.search(jidx, sig_q, jq, k=11 if rerank else 10, depth=100,
                               rerank=rerank, use_kernel=False)
    assert_topk_match(got, [np.asarray(a) for a in want], exact=not rerank)


@pytest.mark.parametrize("mode", ["classic", "dot", "lsh"])
def test_pruned_topk_equals_jax(small_corpus, mode):
    """Below every block (n_keep 3 of 32 64-row blocks) and past the gathered
    rows (depth clamped and padded back), with a filter."""
    jcfg = (JLexicalLshConfig(buckets=64, hashes=2) if mode == "lsh"
            else JFakeWordsConfig(quantization=50, scoring=mode))
    jann = JAnnIndex.build(jnp.asarray(small_corpus), jcfg)
    idx = _port_index(jann.index)
    jbm = jblockmax.build_blockmax(jann.index, 64)
    bm = blockmax.build_blockmax(idx, 64)
    jrep = jann.pipeline.encoder(jann.index, _queries(small_corpus)[0])
    rep = to_torch(jrep)
    filt = np.random.default_rng(4).random(small_corpus.shape[0]) < 0.5
    for n_keep, depth, f in ((3, 40, None), (2, 200, None), (3, 40, filt)):
        got = blockmax.pruned_topk(idx, bm, rep, n_keep, depth,
                                   filt=None if f is None else torch.from_numpy(f))
        want = jblockmax.pruned_topk(jann.index, jbm, jrep, n_keep, depth + 1, use_kernel=False,
                                     filt=None if f is None else jnp.asarray(f.astype(np.int32)))
        assert got[0].shape == (16, depth)
        assert_topk_match(got, [np.asarray(a) for a in want], exact=mode != "classic")
        assert torch.equal(got[1], blockmax.pruned_search(
            idx, bm, rep, n_keep, depth, filt=None if f is None else torch.from_numpy(f))[1])


def test_recall_curve_equals_jax(small_corpus):
    rng = np.random.default_rng(6)
    truth = rng.integers(0, 50, (16, 10)).astype(np.int32)
    truth[0, 3] = -1
    got_ids = rng.integers(0, 50, (16, 100)).astype(np.int32)
    want = jeval.recall_curve(jnp.asarray(truth), jnp.asarray(got_ids), (1, 10, 50, 100))
    got = ev.recall_curve(torch.from_numpy(truth), torch.from_numpy(got_ids), (1, 10, 50, 100))
    assert list(got) == [1, 10, 50, 100]
    assert got == pytest.approx(want, rel=1e-6)  # f32 means, summed in another order


def test_wrappers_equal_the_facade(small_corpus):
    """``tests/test_pipeline.py:168``: the wrappers and ``AnnIndex.search``
    agree bit for bit (fake words reranked; LSH ids)."""
    q = torch.from_numpy(small_corpus[:16])
    qn = bruteforce.l2_normalize(q)
    cfg = FakeWordsConfig(quantization=50)
    ann = AnnIndex.build(small_corpus, cfg, device=CPU)
    q_tf = fakewords.encode_queries(qn, cfg, normalized=True)
    s_w, i_w = fakewords.search(ann.index, q_tf, qn, k=10, depth=100, rerank=True)
    s_p, i_p = ann.search(q, k=10, depth=100, rerank=True)
    assert torch.equal(i_w, i_p) and torch.equal(s_w, s_p)
    lcfg = LexicalLshConfig(buckets=64, hashes=2)
    ann_l = AnnIndex.build(small_corpus, lcfg, device=CPU)
    sig_q = lexical_lsh.encode(qn, lcfg)
    s_w, i_w = lexical_lsh.search(ann_l.index, sig_q, qn, k=10, depth=100, rerank=True)
    s_p, i_p = ann_l.search(q, k=10, depth=100, rerank=True)
    assert torch.equal(i_w, i_p) and torch.equal(s_w, s_p)
    ann_b = AnnIndex.build(small_corpus, cfg, device=CPU, blockmax_keep=4,
                           blockmax_block_size=64)
    s_b, i_b = ann_b.search(q, k=50, depth=50)
    s_t, i_t = blockmax.pruned_topk(ann_b.index, ann_b.bm, q_tf, 4, 50)
    assert torch.equal(i_b, i_t) and torch.equal(s_b, s_t)
