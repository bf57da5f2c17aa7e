"""The port's fake-words encoding, build statistics, brute force, eval and
data/config copies against the JAX package, on the same numpy inputs.

Tolerances: term frequencies, df, query operands, integer dot scores and
the corpus draws are exact.  idf and norm agree to rtol 1e-6 (log and rsqrt
differ from XLA's in the last ulp for some entries); ``scored`` to one bf16
ulp (it is rounded from those f32 values).  Float scores to rtol = atol =
1e-5 (summation order).  Encoding inputs are the reference's own unit
vectors, so a last-ulp difference in ``l2_normalize`` cannot flip a tf
rounding here; ``test_torch_index`` covers the path from raw vectors.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_topk_match, to_torch

from repro.configs import ann_glove as j_ann_glove
from repro.configs import ann_word2vec as j_ann_word2vec
from repro.core import bruteforce as jbruteforce
from repro.core import builder as jbuilder
from repro.core import eval as jeval
from repro.core import fakewords as jfakewords
from repro.core.types import FakeWordsConfig as JFakeWordsConfig
from repro.data import embeddings as jembeddings
from repro_torch.configs import ann_glove, ann_word2vec
from repro_torch.core import bruteforce, builder, fakewords
from repro_torch.core import eval as ev
from repro_torch.core.types import FakeWordsConfig
from repro_torch.data import embeddings


def _unit_vectors(n=500, m=48, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, m)).astype(np.float32)
    x += 0.5 * rng.normal(size=(1, m)).astype(np.float32)
    return x, np.array(jbruteforce.l2_normalize(jnp.asarray(x)))


def _both_indexes(scoring: str, v: np.ndarray):
    jidx = jbuilder.make_build_pipeline(
        JFakeWordsConfig(quantization=50, scoring=scoring)).build_local(
            jnp.asarray(v), normalized=True)
    idx = builder.make_build_pipeline(
        FakeWordsConfig(quantization=50, scoring=scoring)).build_local(
            torch.from_numpy(v), normalized=True)
    return jidx, idx


def _bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in bf16 ulps between two non-negative bf16 tensors."""
    return int((a.view(torch.int16).int() - b.view(torch.int16).int()).abs().max())


def test_corpus_and_queries_equal_reference():
    for name in ("WORD2VEC_LIKE", "GLOVE_LIKE"):
        cfg = dataclasses.replace(getattr(embeddings, name), n_vectors=300)
        jcfg = dataclasses.replace(getattr(jembeddings, name), n_vectors=300)
        x = embeddings.make_corpus(cfg)
        np.testing.assert_array_equal(x, jembeddings.make_corpus(jcfg))
        q, ids = embeddings.make_queries(x, 20, seed=1, jitter=0.1)
        jq, jids = jembeddings.make_queries(x, 20, seed=1, jitter=0.1)
        np.testing.assert_array_equal(q, jq)
        np.testing.assert_array_equal(ids, jids)


def test_paper_cells_equal_reference():
    for mine, theirs in ((ann_word2vec, j_ann_word2vec), (ann_glove, j_ann_glove)):
        assert (mine.ARCH.id, mine.ARCH.source) == (theirs.ARCH.id, theirs.ARCH.source)
        assert [dataclasses.astuple(c) for c in mine.CELLS] == [
            dataclasses.astuple(c) for c in theirs.CELLS]
        cfg, jcfg = mine.make_model(), theirs.make_model()
        assert (cfg.quantization, cfg.df_max_ratio, cfg.scoring) == (
            jcfg.quantization, jcfg.df_max_ratio, jcfg.scoring)


@pytest.mark.parametrize("scoring", ["classic", "dot"])
def test_build_statistics_match_reference(scoring):
    _, v = _unit_vectors()
    jidx, idx = _both_indexes(scoring, v)
    assert torch.equal(idx.tf, to_torch(jidx.tf)) and idx.tf.dtype == torch.int8
    assert torch.equal(idx.df, to_torch(jidx.df)) and idx.df.dtype == torch.int32
    np.testing.assert_allclose(idx.idf, np.asarray(jidx.idf), rtol=1e-6)
    np.testing.assert_allclose(idx.norm, np.asarray(jidx.norm), rtol=1e-6)
    assert torch.equal(idx.vectors, to_torch(jidx.vectors))
    if scoring == "classic":
        assert idx.scored.dtype == torch.bfloat16
        assert _bf16_ulps(idx.scored, to_torch(jidx.scored)) <= 1
    else:
        assert idx.scored is None and jidx.scored is None
    assert idx.num_docs == jidx.num_docs
    assert idx.nbytes() == jidx.nbytes()


def test_build_stages_match_reference_on_shared_inputs():
    _, v = _unit_vectors(seed=1)
    tf = jfakewords.encode(jnp.asarray(v), 50)
    assert torch.equal(fakewords.encode(torch.from_numpy(v), 50), to_torch(tf))
    live = np.random.default_rng(2).random(v.shape[0]) < 0.8
    df = builder.live_df(to_torch(tf), torch.from_numpy(live))
    jdf = jbuilder.live_df(tf, jnp.asarray(live))
    assert torch.equal(df, to_torch(jdf))
    idf = builder.idf_from_df(df, int(live.sum()))
    np.testing.assert_allclose(idf, np.asarray(jbuilder.idf_from_df(jdf, int(live.sum()))),
                               rtol=1e-6)
    jidf = jbuilder.idf_from_df(jdf, v.shape[0])
    norm = jnp.asarray(np.random.default_rng(3).random(v.shape[0]), jnp.float32)
    scored = builder.classic_scored(to_torch(tf), to_torch(jidf), to_torch(norm))
    assert _bf16_ulps(scored, to_torch(jbuilder.classic_scored(tf, jidf, norm))) <= 1


@pytest.mark.parametrize("df_max_ratio", [1.0, 0.5])
def test_query_operands_and_scores_match_reference(df_max_ratio):
    x, v = _unit_vectors(seed=4)
    jq = jbruteforce.l2_normalize(jnp.asarray(x[:7] + 0.1))
    jcfg, cfg = JFakeWordsConfig(quantization=50), FakeWordsConfig(quantization=50)
    jq_tf = jfakewords.encode_queries(jq, jcfg, normalized=True)
    q_tf = fakewords.encode_queries(to_torch(jq), cfg, normalized=True)
    assert torch.equal(q_tf, to_torch(jq_tf)) and q_tf.dtype == torch.int32
    for scoring in ("classic", "dot"):
        jidx, idx = _both_indexes(scoring, v)
        keep = fakewords.df_prune_mask(idx.df, idx.num_docs, df_max_ratio)
        assert torch.equal(keep, to_torch(jfakewords.df_prune_mask(
            jidx.df, jidx.num_docs, df_max_ratio)))
        assert torch.equal(fakewords.signed_query(q_tf), to_torch(jfakewords.signed_query(jq_tf)))
        for dtype, jdtype in ((torch.int32, jnp.int32), (torch.int8, jnp.int8)):
            assert torch.equal(
                fakewords.dot_query(idx, q_tf, df_max_ratio, dtype=dtype),
                to_torch(jfakewords.dot_query(jidx, jq_tf, df_max_ratio, dtype=jdtype)))
        np.testing.assert_array_equal(
            fakewords.dot_scores(idx, q_tf, df_max_ratio),
            np.asarray(jfakewords.dot_scores(jidx, jq_tf, df_max_ratio)))
        if scoring == "classic":
            qv = fakewords.classic_query(idx, q_tf, df_max_ratio)
            jqv = jfakewords.classic_query(jidx, jq_tf, df_max_ratio)
            assert torch.equal(qv.view(torch.int16), to_torch(jqv).view(torch.int16))
            np.testing.assert_allclose(
                fakewords.classic_scores(idx, q_tf, df_max_ratio),
                np.asarray(jfakewords.classic_scores(jidx, jq_tf, df_max_ratio)),
                rtol=1e-5, atol=1e-5)
        else:
            with pytest.raises(ValueError):
                fakewords.classic_query(idx, q_tf)


def test_l2_normalize_exact_topk_and_rerank_match_reference():
    x, v = _unit_vectors(n=800, seed=5)
    np.testing.assert_allclose(bruteforce.l2_normalize(torch.from_numpy(x)), v,
                               rtol=1e-6, atol=1e-7)
    q = x[:9] + 0.2
    want = jbruteforce.exact_topk(jnp.asarray(x), jnp.asarray(q), 11, use_kernel=False)
    got = bruteforce.exact_topk(torch.from_numpy(x), torch.from_numpy(q), 10)
    assert_topk_match(got, want, exact=False)

    rng = np.random.default_rng(6)
    cand = rng.integers(0, 800, (9, 40)).astype(np.int32)
    cand[:, -5:] = -1  # padding never ranks
    qn = np.array(jbruteforce.l2_normalize(jnp.asarray(q)))
    want = jbruteforce.rerank_exact(jnp.asarray(v), jnp.asarray(qn), jnp.asarray(cand), 36,
                                    normalized=True)
    got = bruteforce.rerank_exact(torch.from_numpy(v), torch.from_numpy(qn),
                                  torch.from_numpy(cand), 35, normalized=True)
    assert_topk_match(got, want, exact=False)
    assert (got[1] >= 0).all()


@pytest.mark.parametrize("mask_shape", [None, "shared", "per-query"])
def test_recall_and_overlap_match_reference(mask_shape):
    rng = np.random.default_rng(7)
    truth = rng.integers(0, 50, (6, 10)).astype(np.int32)
    truth[0, 7:] = -1
    got_ids = rng.integers(0, 50, (6, 30)).astype(np.int32)
    mask = None
    if mask_shape is not None:
        mask = rng.random(50 if mask_shape == "shared" else (6, 50)) < 0.6
    want = float(jeval.recall_at(jnp.asarray(truth), jnp.asarray(got_ids),
                                 None if mask is None else jnp.asarray(mask)))
    got = float(ev.recall_at(torch.from_numpy(truth), torch.from_numpy(got_ids),
                             None if mask is None else torch.from_numpy(mask)))
    assert got == pytest.approx(want, rel=1e-6)
    assert float(ev.overlap(torch.from_numpy(truth), torch.from_numpy(got_ids[:, :10]))) == (
        pytest.approx(float(jeval.overlap(jnp.asarray(truth), jnp.asarray(got_ids[:, :10]))),
                      rel=1e-6))


def test_configs_and_unported_options():
    assert FakeWordsConfig(store_dtype="int8").store_dtype is torch.int8
    assert FakeWordsConfig() == FakeWordsConfig(store_dtype=torch.int8)
    for bad in (dict(quantization=0), dict(scoring="bm25"), dict(store_dtype="float8")):
        with pytest.raises(ValueError):
            FakeWordsConfig(**bad)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        FakeWordsConfig(scoring="dot", signed_store=True)
    cfg = FakeWordsConfig()
    # the quantized read path is ported: its options build (parity in
    # test_torch_quantized.py); bad values still raise
    for kwargs in (dict(primary_postings="int8"), dict(primary_postings="int4"),
                   dict(rerank_store="int8")):
        assert builder.make_build_pipeline(cfg, **kwargs) is not None
    for kwargs in (dict(rerank_store="fp16"), dict(primary_postings="int2"),
                   dict(primary_postings="int4", postings_group=48)):
        with pytest.raises(ValueError):
            builder.make_build_pipeline(cfg, **kwargs)
    _, v = _unit_vectors(n=50)
    idx = builder.make_build_pipeline(cfg, "none").build_local(torch.from_numpy(v))
    assert idx.vectors is None and idx.scored is not None
