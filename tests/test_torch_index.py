"""The port's ``AnnIndex`` end to end against the JAX package's.

From raw vectors, each package normalizes and encodes on its own; a
last-ulp difference in ``l2_normalize`` may flip a tf rounding, so ids are
held to an overlap >= 0.99 and recall to within 0.01.  Through
``index_from_numpy`` the port searches the very index the JAX package
saved: dot ids must then be exact and classic ids equal away from
near-ties.  The JAX side runs its plain (XLA) match path, the reference
the tests of both packages use on the CPU.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_topk_match, to_torch

from repro.core import bruteforce as jbruteforce
from repro.core.index import AnnIndex as JAnnIndex
from repro.core.types import BruteForceConfig as JBruteForceConfig
from repro.core.types import FakeWordsConfig as JFakeWordsConfig
from repro_torch.core import eval as ev
from repro_torch.core.index import AnnIndex, index_from_numpy
from repro_torch.core.types import BruteForceConfig, FakeWordsConfig, SearchParams


def _data(n=2000, m=64, b=24, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, m)).astype(np.float32)
    x += 0.5 * rng.normal(size=(1, m)).astype(np.float32)
    q = x[rng.choice(n, b, replace=False)] + 0.05 * rng.normal(size=(b, m)).astype(np.float32)
    return x, q


def _configs(method: str):
    if method == "bruteforce":
        return BruteForceConfig(), JBruteForceConfig()
    return (FakeWordsConfig(quantization=50, scoring=method),
            JFakeWordsConfig(quantization=50, scoring=method))


@pytest.mark.parametrize("method", ["classic", "dot", "bruteforce"])
def test_build_and_search_from_raw_vectors_match_reference(method):
    x, q = _data()
    cfg, jcfg = _configs(method)
    idx = AnnIndex.build(x, cfg, device="cpu")
    jidx = JAnnIndex.build(jnp.asarray(x), jcfg)
    assert idx.method == jidx.method and idx.num_docs == jidx.num_docs
    assert idx.nbytes() == jidx.nbytes()
    _, truth = jbruteforce.exact_topk(jnp.asarray(x), jnp.asarray(q), 10, use_kernel=False)
    truth = to_torch(truth)
    for rerank in (False, True):
        s, i = idx.search(q, k=10, depth=100, rerank=rerank)
        js, ji = jidx.search(jnp.asarray(q), k=10, depth=100, rerank=rerank)
        assert s.shape == (24, 10) and i.dtype == torch.int32 and torch.isfinite(s).all()
        assert float(ev.overlap(to_torch(ji), i)) >= 0.99
        assert abs(float(ev.recall_at(truth, i)) - float(ev.recall_at(truth, to_torch(ji)))) <= 0.01


def _saved(tmp_path, method: str, x: np.ndarray):
    """What the reference's AnnIndex.save writes, read back as plain data."""
    _, jcfg = _configs(method)
    jidx = JAnnIndex.build(jnp.asarray(x), jcfg)
    jidx.save(str(tmp_path))
    meta = json.loads((tmp_path / "config.json").read_text())
    with np.load(tmp_path / "index.npz") as z:
        arrays = {name: z[name] for name in z.files}
    return jidx, meta, arrays


@pytest.mark.parametrize("method", ["classic", "dot", "bruteforce"])
def test_index_from_numpy_searches_a_jax_built_index_identically(tmp_path, method):
    x, q = _data(seed=1)
    jidx, meta, arrays = _saved(tmp_path, method, x)
    idx = index_from_numpy(meta["method"], meta["config"], arrays, meta["dtypes"], device="cpu")
    assert idx.method == meta["method"] and idx.device == torch.device("cpu")
    if method != "bruteforce":
        assert idx.index.scored is None or idx.index.scored.dtype == torch.bfloat16
        assert torch.equal(idx.index.tf, to_torch(jidx.index.tf))
    # match stage on the same query operand: exact for integer scores
    jq = jbruteforce.l2_normalize(jnp.asarray(q))
    jrep = jidx.pipeline.encoder(jidx.index, jq)
    want = jidx.pipeline.matcher(jidx.index, jrep, 101, use_kernel=False)
    got = idx.pipeline.matcher(idx.index, to_torch(jrep), 100)
    assert_topk_match(got, want, exact=method == "dot")
    # the whole search from raw queries
    for rerank in (False, True):
        s, i = idx.search(q, params=SearchParams(k=10, depth=100, rerank=rerank))
        js, ji = jidx.search(jnp.asarray(q), k=10, depth=100, rerank=rerank)
        if method == "dot" and not rerank:
            assert torch.equal(i, to_torch(ji))
        assert float(ev.overlap(to_torch(ji), i)) >= 0.99
        np.testing.assert_allclose(s, np.asarray(js), rtol=1e-5, atol=1e-5)


def test_index_from_numpy_rejects_unported_stores(tmp_path):
    """Every method is ported: "hnsw" (the graph) loads, an unknown method
    raises ValueError as the reference's ``_rebuild_index`` does, and so do
    arrays that belong to no store of the method (named) and packed arrays
    without the ``pq`` metadata that ``config.json`` records."""
    x, _ = _data(n=300)
    _, meta, arrays = _saved(tmp_path, "classic", x)
    extra = dict(arrays, **{"neighbors": np.zeros((300, 8), np.int32)})
    with pytest.raises(ValueError, match="'neighbors'"):
        index_from_numpy(meta["method"], meta["config"], extra,
                         dict(meta["dtypes"], **{"neighbors": "int32"}), device="cpu")
    packed = dict(arrays, **{"pq.q": np.zeros((300, 128), np.int8),
                             "pq.scale": np.ones((300, 1), np.float32)})
    with pytest.raises(ValueError, match="pq metadata"):
        index_from_numpy(meta["method"], meta["config"], packed,
                         dict(meta["dtypes"], **{"pq.q": "int8", "pq.scale": "float32"}),
                         device="cpu")
    with pytest.raises(ValueError, match="unknown method 'ivf'"):
        index_from_numpy("ivf", {}, {}, {}, device="cpu")
    v = x / np.linalg.norm(x, axis=1, keepdims=True)
    graph_arrays = {"vectors": v, "neighbors": np.full((300, 4), -1, np.int32),
                    "entry": np.arange(2, dtype=np.int32)}
    graph_arrays["neighbors"][:, 0] = (np.arange(300) + 1) % 300
    idx = index_from_numpy("hnsw", {"degree": 2, "reverse_degree": 2, "ef_construction": 4,
                                    "entries": 2},
                           graph_arrays, {"vectors": "float32", "neighbors": "int32",
                                          "entry": "int32"}, device="cpu")
    assert idx.method == "hnsw" and idx.num_docs == 300 and idx.config.total_degree == 4
    s, i = idx.search(v[:3], k=5, depth=5)
    assert i.shape == (3, 5) and bool((i >= 0).all()) and bool((s[:, 1:] <= s[:, :-1]).all())
    with pytest.raises(ValueError, match="'pq.q'"):
        index_from_numpy("hnsw", {}, dict(graph_arrays, **{"pq.q": packed["pq.q"]}),
                         {"vectors": "float32", "neighbors": "int32", "entry": "int32",
                          "pq.q": "int8"}, device="cpu")


def test_default_device_is_cuda_and_raises_without_one(monkeypatch):
    x, q = _data(n=200)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        AnnIndex.build(x, FakeWordsConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        index_from_numpy("bruteforce", {}, {"vectors": x}, {"vectors": "float32"})


def test_search_rerank_needs_stored_vectors():
    x, q = _data(n=300)
    idx = AnnIndex.build(x, FakeWordsConfig(), keep_vectors=False, device="cpu")
    idx.search(q, k=5, depth=20)
    with pytest.raises(ValueError, match="original vectors"):
        idx.search(q, k=5, depth=20, rerank=True)
    # depth is clamped to the corpus size, as in the reference
    s, i = AnnIndex.build(x[:30], FakeWordsConfig(), device="cpu").search(q, k=50, depth=100)
    assert s.shape == (24, 30) and sorted(i[0].tolist()) == list(range(30))

