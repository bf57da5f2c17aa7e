"""The port's lexical LSH encoding and search against the JAX package's.

Tokens and MinHash signatures must be equal bit for bit, for n-grams 1-3 and
the paper's (b, h) settings, including values whose scaled form sits on a
.5 rounding edge (both packages round half to even).  LSH scores are
integer collision counts, so ids and scores of the match stage must be
exact; the JAX side runs its fused top-k in Pallas interpret mode
(bn = bk = 128) or its plain path.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_topk_match, to_torch

from repro.core import bruteforce as jbruteforce
from repro.core import lexical_lsh as jlsh
from repro.core.index import AnnIndex as JAnnIndex
from repro.core.types import LexicalLshConfig as JLexicalLshConfig
from repro.kernels.fused_topk import ops as jops
from repro_torch.core import lexical_lsh
from repro_torch.core.index import AnnIndex, index_from_numpy
from repro_torch.core.types import LexicalLshConfig, LshIndex


def _vectors(n=300, m=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, m)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    # scaled by 10 these land on (or one ulp beside) .5: rounding edges
    x[0, :8] = [0.05, 0.15, 0.25, 0.35, -0.45, -0.25, 0.55, -0.05]
    x[1, :4] = [0.249999, 0.250001, -0.349999, 0.950001]
    return x


def _data(n=600, m=32, b=12, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, m)).astype(np.float32)
    x += 0.5 * rng.normal(size=(1, m)).astype(np.float32)
    q = x[rng.choice(n, b, replace=False)] + 0.05 * rng.normal(size=(b, m)).astype(np.float32)
    return x, q


def _u32(a) -> np.ndarray:
    """uint32 signatures (JAX array or torch tensor) as int32 bits."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int32).numpy()
    return np.asarray(a).view(np.int32)


@pytest.mark.parametrize("ngram", [1, 2, 3])
@pytest.mark.parametrize("buckets,hashes", [(300, 1), (50, 30)])
def test_tokens_and_signatures_bit_exact(ngram, buckets, hashes):
    x = _vectors()
    kw = dict(buckets=buckets, hashes=hashes, ngram=ngram)
    jcfg, cfg = JLexicalLshConfig(**kw), LexicalLshConfig(**kw)
    jt = np.asarray(jlsh.tokenize(jnp.asarray(x), jcfg)).astype(np.int64)
    tt = lexical_lsh.tokenize(torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(tt.numpy(), jt)
    sig = lexical_lsh.encode(torch.from_numpy(x), cfg)
    assert sig.dtype == torch.uint32 and sig.shape == (x.shape[0], buckets * hashes)
    np.testing.assert_array_equal(_u32(sig), _u32(jlsh.encode(jnp.asarray(x), jcfg)))


def test_hash_helpers_and_match_scores_match_jax():
    seeds = lexical_lsh.hash_seeds(30, 0x5EED)
    np.testing.assert_array_equal(seeds.numpy(),
                                  np.asarray(jlsh.hash_seeds(30, 0x5EED)).astype(np.int64))
    x = np.arange(0, 2**32, 2**32 // 1000 + 7, dtype=np.int64)
    np.testing.assert_array_equal(
        lexical_lsh.mix32(torch.from_numpy(x)).numpy(),
        np.asarray(jlsh.mix32(jnp.asarray(x.astype(np.uint32)))).astype(np.int64))
    cfg, jcfg = LexicalLshConfig(buckets=64, hashes=2), JLexicalLshConfig(buckets=64, hashes=2)
    v = _vectors(n=200)
    sig, jsig = lexical_lsh.encode(torch.from_numpy(v), cfg), jlsh.encode(jnp.asarray(v), jcfg)
    counts = lexical_lsh.match_scores(sig[:7], sig)
    assert counts.dtype == torch.int32
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jlsh.match_scores(jsig[:7], jsig)))


def test_lsh_match_on_k2_matches_jax_kernel():
    """The LSH match stage (K1's lsh mode) against the JAX fused kernel."""
    cfg, jcfg = LexicalLshConfig(buckets=64, hashes=2), JLexicalLshConfig(buckets=64, hashes=2)
    v = _vectors(n=260)
    sig = lexical_lsh.encode(torch.from_numpy(v), cfg)
    jsig = jlsh.encode(jnp.asarray(v), jcfg)
    idx = LshIndex(sig=sig)
    got = AnnIndex(config=cfg, index=idx).pipeline.matcher(idx, sig[:6], 30)
    want = jops.lsh_topk(jsig[:6], jsig, 30, interpret=True)
    assert_topk_match(got, [np.asarray(a) for a in want], exact=True)


def test_lsh_facade_build_and_search_match_jax():
    x, q = _data()
    kw = dict(buckets=50, hashes=4)
    idx = AnnIndex.build(x, LexicalLshConfig(**kw), device="cpu")
    jidx = JAnnIndex.build(jnp.asarray(x), JLexicalLshConfig(**kw))
    assert idx.method == jidx.method == "lexical-lsh"
    assert idx.nbytes() == jidx.nbytes() and idx.num_docs == jidx.num_docs
    np.testing.assert_array_equal(_u32(idx.index.sig), _u32(jidx.index.sig))
    built = lexical_lsh.build(torch.from_numpy(x), LexicalLshConfig(**kw), keep_vectors=False)
    assert built.vectors is None and torch.equal(built.sig.view(torch.int32),
                                                 idx.index.sig.view(torch.int32))
    s, i = idx.search(q, k=20, depth=60)
    js, ji = jidx.search(jnp.asarray(q), k=20, depth=60, use_kernel=False)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    s, i = idx.search(q, k=10, depth=60, rerank=True)
    js, ji = jidx.search(jnp.asarray(q), k=10, depth=60, rerank=True, use_kernel=False)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)


def test_index_from_numpy_searches_a_jax_saved_lsh_index(tmp_path):
    x, q = _data(seed=2)
    jidx = JAnnIndex.build(jnp.asarray(x), JLexicalLshConfig(buckets=64, hashes=2))
    jidx.save(str(tmp_path))
    meta = json.loads((tmp_path / "config.json").read_text())
    with np.load(tmp_path / "index.npz") as z:
        arrays = {name: z[name] for name in z.files}
    assert meta["dtypes"]["sig"] == "uint32"
    idx = index_from_numpy(meta["method"], meta["config"], arrays, meta["dtypes"],
                           device="cpu")
    assert idx.method == "lexical-lsh" and idx.config == LexicalLshConfig(buckets=64, hashes=2)
    assert torch.equal(idx.index.sig.view(torch.int32), to_torch(_u32(jidx.index.sig)))
    jq = jbruteforce.l2_normalize(jnp.asarray(q))
    for rerank in (False, True):
        s, i = idx.search(q, k=10, depth=50, rerank=rerank)
        js, ji = jidx.search(jq, k=10, depth=50, rerank=rerank, use_kernel=False)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)


def test_lsh_config_checks():
    with pytest.raises(ValueError, match="ngram"):
        LexicalLshConfig(ngram=4)
    with pytest.raises(ValueError, match="buckets"):
        LexicalLshConfig(buckets=0)
