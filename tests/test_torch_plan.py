"""The port's query plans (``repro_torch.core.plan``) against the JAX
package's ``repro.core.plan`` on the same inputs: ``combine_by_id``, the RRF
and weighted fusions, ``aggregate_by_doc``, ``FusionStage`` and
``MultiVectorPlan`` with its refill.  Ids must be equal and scores within
1e-6 relative.  RRF totals of two docs can tie exactly in real arithmetic
and differ by an ulp after two summation orders, so fused ids are held by
the near-tie rule (``torch_parity.assert_topk_match``, here at 1e-6).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_topk_match, to_torch

from repro.core import plan as jplan
from repro.core.index import AnnIndex as JAnnIndex
from repro.core.types import BruteForceConfig as JBruteForceConfig
from repro.core.types import FakeWordsConfig as JFakeWordsConfig
from repro_torch.core import eval as ev
from repro_torch.core import plan
from repro_torch.core.index import AnnIndex
from repro_torch.core.types import BruteForceConfig, FakeWordsConfig

RTOL = 1e-6


def _held(got, want, exact: bool = True):
    """(scores, ids) of the port against the JAX package's."""
    s, i = got
    js, ji = to_torch(want[0]), to_torch(want[1])
    assert s.dtype == torch.float32 and i.shape == ji.shape
    if exact:
        np.testing.assert_array_equal(i.numpy(), ji.numpy())
        np.testing.assert_allclose(s.numpy(), js.numpy(), rtol=RTOL, atol=0)
    else:
        assert_topk_match((s, i), (js, ji), exact=False, rtol=RTOL, atol=1e-9)


def _lists(seed: int, b: int = 6, m: int = 24, n_ids: int = 30):
    """(B, M) ids with duplicates and -1 padding, and values with ties."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(-1, n_ids, (b, m)).astype(np.int32)
    vals = rng.integers(0, 8, (b, m)).astype(np.float32) / 4 - 0.5
    return ids, vals


def test_combine_by_id_sum_and_max_small():
    """The reference test's case, held to its numbers and to JAX."""
    ids = np.asarray([[3, 1, 3, -1]], np.int32)
    vals = np.asarray([[1.0, 5.0, 2.0, 9.0]], np.float32)
    s, i = plan.combine_by_id(torch.from_numpy(ids), torch.from_numpy(vals), k=2, agg="sum")
    assert i.tolist() == [[1, 3]] and s.tolist() == [[5.0, 3.0]]
    s, i = plan.combine_by_id(torch.from_numpy(ids), torch.from_numpy(vals), k=5, agg="max")
    assert i.tolist() == [[1, 3, -1, -1]] and s[0, :2].tolist() == [5.0, 2.0]
    assert (s[0, 2:] == -torch.inf).all()
    _held((s, i), jplan.combine_by_id(jnp.asarray(ids), jnp.asarray(vals), 5, agg="max"))
    with pytest.raises(ValueError, match="unknown agg"):
        plan.combine_by_id(torch.from_numpy(ids), torch.from_numpy(vals), k=2, agg="mean")


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("agg", ["sum", "max"])
@pytest.mark.parametrize("k", [5, 24, 40])
def test_combine_by_id_matches_jax(agg, k, seed):
    """Duplicates, padding, tied values and k past the entry count."""
    ids, vals = _lists(seed)
    got = plan.combine_by_id(torch.from_numpy(ids), torch.from_numpy(vals), k, agg=agg)
    _held(got, jplan.combine_by_id(jnp.asarray(ids), jnp.asarray(vals), k, agg=agg))


def test_rrf_formula_exact():
    """fuse(method='rrf') computes sum_p w_p / (rrf_k + rank_p), rank 1."""
    ids_a = torch.tensor([[7, 3, 5]], dtype=torch.int32)
    ids_b = torch.tensor([[3, 9, -1]], dtype=torch.int32)
    sc = torch.tensor([[0.9, 0.8, 0.7]])
    s, i = plan.fuse([(sc, ids_a), (sc, ids_b)], k=4, method="rrf", rrf_k=60.0)
    exp = {7: 1 / 61, 3: 1 / 62 + 1 / 61, 5: 1 / 63, 9: 1 / 62}
    order = sorted(exp, key=exp.get, reverse=True)
    assert i[0].tolist() == order
    np.testing.assert_allclose(s[0].numpy(), [exp[d] for d in order], rtol=1e-6)
    assert plan.DEFAULT_RRF_K == jplan.DEFAULT_RRF_K == 60.0
    _held((s, i), jplan.fuse([(jnp.asarray(sc.numpy()), jnp.asarray(ids_a.numpy())),
                              (jnp.asarray(sc.numpy()), jnp.asarray(ids_b.numpy()))],
                             k=4, method="rrf", rrf_k=60.0))
    with pytest.raises(ValueError, match="at least one"):
        plan.fuse([], k=4)
    with pytest.raises(ValueError, match="unknown fusion method"):
        plan.fuse([(sc, ids_a)], k=4, method="borda")


@pytest.mark.parametrize("method,weights,rrf_k", [
    ("rrf", None, 60.0), ("rrf", [2.0, 0.5, 1.0], 10.0), ("wsum", None, 60.0),
    ("wsum", [0.3, 1.0, 2.5], 60.0)])
def test_fuse_matches_jax(method, weights, rrf_k):
    """Three (B, 12) lists with shared ids, padding and scores of mixed sign."""
    rng = np.random.default_rng(5)
    results, jresults = [], []
    for _ in range(3):
        ids = np.stack([rng.permutation(40)[:12] for _ in range(6)]).astype(np.int32)
        ids[:, 10:] = -1
        s = -np.sort(-rng.normal(size=(6, 12)).astype(np.float32), axis=1)
        results.append((torch.from_numpy(s), torch.from_numpy(ids)))
        jresults.append((jnp.asarray(s), jnp.asarray(ids)))
    got = plan.fuse(results, 10, method=method, weights=weights, rrf_k=rrf_k)
    _held(got, jplan.fuse(jresults, 10, method=method, weights=weights, rrf_k=rrf_k),
          exact=method == "wsum")


@pytest.mark.parametrize("agg", ["max", "sum"])
def test_aggregate_by_doc_matches_jax(agg):
    """Vector hits map through ``doc_map`` and combine per doc; the
    reference test's case, then random lists."""
    doc_map = np.asarray([0, 0, 1, 1, 2, 2])
    scores = np.asarray([[0.9, 0.5, 0.8, 0.1]], np.float32)
    vec_ids = np.asarray([[0, 1, 2, 5]], np.int32)
    s, i = plan.aggregate_by_doc(torch.from_numpy(scores), torch.from_numpy(vec_ids),
                                 torch.from_numpy(doc_map), k=3, agg=agg)
    if agg == "max":
        assert i.tolist() == [[0, 1, 2]]
        np.testing.assert_allclose(s.numpy(), [[0.9, 0.8, 0.1]])
    else:
        assert i[0, 0] == 0 and s[0, 0] == pytest.approx(1.4)
    rng = np.random.default_rng(7)
    doc_map = rng.integers(0, 15, 60)
    vec_ids = np.stack([rng.permutation(60)[:20] for _ in range(5)]).astype(np.int32)
    vec_ids[:, -3:] = -1
    scores = -np.sort(-rng.random((5, 20)).astype(np.float32), axis=1)
    got = plan.aggregate_by_doc(torch.from_numpy(scores), torch.from_numpy(vec_ids), doc_map,
                                k=8, agg=agg)
    _held(got, jplan.aggregate_by_doc(jnp.asarray(scores), jnp.asarray(vec_ids),
                                      jnp.asarray(doc_map), k=8, agg=agg))


def test_fusion_stage_matches_jax_and_beats_the_weaker_retriever(small_corpus, tmp_path):
    """RRF of classic and dot fake words on the same arrays in both
    packages: the fused lists agree, and the fusion's R@10 is at least the
    weaker retriever's."""
    v = small_corpus
    q = small_corpus[:32]
    pairs = []
    for scoring in ("classic", "dot"):
        jidx = JAnnIndex.build(jnp.asarray(v), JFakeWordsConfig(quantization=30, scoring=scoring))
        jidx.save(str(tmp_path / scoring))
        pairs.append((jidx, AnnIndex.load(str(tmp_path / scoring), device="cpu")))
    plans = tuple(plan.QueryPlan(search=lambda qq, idx=idx: idx.search(qq, k=30, depth=100),
                                 label=jidx.config.scoring) for jidx, idx in pairs)
    jplans = tuple(jplan.QueryPlan(search=lambda qq, idx=jidx: idx.search(
        qq, k=30, depth=100, use_kernel=False)) for jidx, idx in pairs)
    s, i = plan.FusionStage(plans=plans, k=10).run(q)
    assert i.shape == (32, 10)
    js, ji = jplan.FusionStage(plans=jplans, k=10).run(jnp.asarray(q))
    _held((s, i), (js, ji), exact=False)
    _, truth = AnnIndex.build(v, BruteForceConfig(), device="cpu").search(q, k=10, depth=10)
    r_fused = float(ev.recall_at(truth, i))
    recalls = [float(ev.recall_at(truth, p.run(q)[1][:, :10])) for p in plans]
    assert r_fused >= min(recalls), (r_fused, recalls)


def test_multi_vector_plan_end_to_end_matches_jax(small_corpus):
    """Two vectors a doc: a doc's own vector surfaces that doc first under
    max-sim, and the aggregated lists equal the JAX package's."""
    vecs = small_corpus[:256]
    doc_map = np.arange(256) // 2
    idx = AnnIndex.build(vecs, BruteForceConfig(), device="cpu")
    jidx = JAnnIndex.build(jnp.asarray(vecs), JBruteForceConfig())
    mv = plan.MultiVectorPlan(inner=plan.QueryPlan(search=lambda qq: idx.search(
        qq, k=20, depth=20)), doc_map=torch.from_numpy(doc_map), k=5, agg="max")
    s, i = mv.run(small_corpus[:8])
    assert i[:, 0].tolist() == list(np.arange(8) // 2)
    jmv = jplan.MultiVectorPlan(inner=jplan.QueryPlan(search=lambda qq: jidx.search(
        qq, k=20, depth=20, use_kernel=False)), doc_map=jnp.asarray(doc_map), k=5, agg="max")
    _held((s, i), jmv.run(jnp.asarray(small_corpus[:8])), exact=False)


def test_multi_vector_underfill_refills_to_k():
    """A k_sub-deep vector list can fold into fewer than k docs; the plan
    runs the inner search again at twice the depth (``run_at``) until k docs
    fill, as the JAX package's does, and stops when the inner plan cannot go
    deeper."""
    rng = np.random.default_rng(0)
    n_docs, per, dim = 8, 8, 16
    base = np.eye(n_docs, dim, dtype=np.float32)
    rows = np.repeat(base, per, axis=0) + 0.01 * rng.standard_normal(
        (n_docs * per, dim)).astype(np.float32)
    doc_map = np.arange(n_docs * per) // per
    idx = AnnIndex.build(rows, BruteForceConfig(), device="cpu")
    jidx = JAnnIndex.build(jnp.asarray(rows), JBruteForceConfig())
    q = base[:1]  # doc 0's centroid: its 8 vectors rank first
    depths = []

    def search_at(qq, kk):
        depths.append(kk)
        return idx.search(qq, k=kk, depth=kk)

    inner = plan.QueryPlan(search=lambda qq: idx.search(qq, k=per, depth=per),
                           search_at=search_at)
    s_raw, i_raw = inner.run(q)
    _, agg_i = plan.aggregate_by_doc(s_raw, i_raw, doc_map, k=4)
    assert int((agg_i >= 0).sum()) < 4  # one pass fills a single doc
    s, i = plan.MultiVectorPlan(inner=inner, doc_map=doc_map, k=4).run(q)
    assert i.shape == (1, 4) and int((i >= 0).sum()) == 4 and i[0, 0] == 0
    assert len(set(i[0].tolist())) == 4 and depths == [16]
    jinner = jplan.QueryPlan(
        search=lambda qq: jidx.search(qq, k=per, depth=per, use_kernel=False),
        search_at=lambda qq, kk: jidx.search(qq, k=kk, depth=kk, use_kernel=False))
    _held((s, i), jplan.MultiVectorPlan(inner=jinner, doc_map=jnp.asarray(doc_map), k=4)
          .run(jnp.asarray(q)), exact=False)
    # A fixed-depth inner (no search_at) cannot go deeper: the loop ends with
    # the under-filled list.
    fixed = plan.QueryPlan(search=lambda qq: idx.search(qq, k=per, depth=per))
    _, i_fixed = plan.MultiVectorPlan(inner=fixed, doc_map=doc_map, k=4).run(q)
    assert int((i_fixed >= 0).sum()) == 1
