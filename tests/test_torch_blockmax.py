"""The port's blockmax pruning (``repro_torch.core.blockmax``) against the JAX
package's, in the classic, dot and lsh bound modes.

The port's indexes are made from the JAX index's own arrays, so both sides
prune the same data.  Block bounds ``ub`` must be equal bit for bit.  Dot
and lsh scores are integers: bounds, ids and scores must be exact.  Classic
scores are f32 sums of bf16 products taken in another order: bounds to
rtol = 1e-5, and ids equal away from near-ties (``torch_parity``).  The JAX
side runs its plain (XLA) path, which its own tests hold equal to its
kernel path.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_topk_match, to_torch

from repro.core import blockmax as jblockmax
from repro.core import bruteforce as jbruteforce
from repro.core.index import AnnIndex as JAnnIndex
from repro.core.types import FakeWordsConfig as JFakeWordsConfig
from repro.core.types import LexicalLshConfig as JLexicalLshConfig
from repro_torch.core import blockmax
from repro_torch.core import pipeline as pl
from repro_torch.core.index import AnnIndex, index_from_numpy
from repro_torch.core.types import (
    BruteForceConfig,
    FakeWordsConfig,
    FakeWordsIndex,
    LexicalLshConfig,
    LshIndex,
)

MODES = ["classic", "dot", "lsh"]
BLOCK = 64


def _data(n=500, m=32, b=8, seed=0):
    """N = 500 is not a multiple of the 64-row block."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, m)).astype(np.float32)
    x += 0.5 * rng.normal(size=(1, m)).astype(np.float32)
    q = x[rng.choice(n, b, replace=False)] + 0.05 * rng.normal(size=(b, m)).astype(np.float32)
    return x, q


def _configs(mode):
    if mode == "lsh":
        return LexicalLshConfig(buckets=64, hashes=2), JLexicalLshConfig(buckets=64, hashes=2)
    return (FakeWordsConfig(quantization=40, scoring=mode),
            JFakeWordsConfig(quantization=40, scoring=mode))


def _port_index(jindex):
    """The port's index container holding the JAX index's arrays."""
    if hasattr(jindex, "sig"):
        return LshIndex(sig=to_torch(jindex.sig), vectors=to_torch(jindex.vectors))
    return FakeWordsIndex(
        tf=to_torch(jindex.tf), idf=to_torch(jindex.idf), norm=to_torch(jindex.norm),
        df=to_torch(jindex.df), vectors=to_torch(jindex.vectors),
        scored=None if jindex.scored is None else to_torch(jindex.scored))


def _pair(mode, x):
    cfg, jcfg = _configs(mode)
    jidx = JAnnIndex.build(jnp.asarray(x), jcfg)
    return jidx, AnnIndex(config=cfg, index=_port_index(jidx.index))


def _bits(ub) -> np.ndarray:
    """Block bounds (torch or JAX) as integers of the same bits."""
    a = ub if isinstance(ub, torch.Tensor) else to_torch(ub)
    same_bits = {torch.bfloat16: torch.int16, torch.uint32: torch.int32}
    return a.view(same_bits.get(a.dtype, a.dtype)).numpy()


def _query_rep(jidx, q):
    """The match-stage query operand, from the JAX encoder (both ports
    encode identically; tests of that are in the fakewords and lsh files)."""
    jrep = jidx.pipeline.encoder(jidx.index, jbruteforce.l2_normalize(jnp.asarray(q)))
    return jrep, to_torch(jrep)


@pytest.mark.parametrize("mode", MODES)
def test_block_bounds_equal_jax(mode):
    x, q = _data()
    jidx, idx = _pair(mode, x)
    jbm = jblockmax.build_blockmax(jidx.index, BLOCK)
    bm = blockmax.build_blockmax(idx.index, BLOCK)
    assert bm.mode == jbm.mode == mode and bm.num_blocks == jbm.num_blocks == 8
    # classic and dot hold the maxima widened to f32: narrowed back to the
    # reference's dtype they must be its bits (so the widening was exact).
    if mode != "lsh":
        assert bm.ub.dtype == torch.float32
        ub = bm.ub.to(to_torch(jbm.ub).dtype)
        assert torch.equal(ub.float(), bm.ub)
    else:
        ub = bm.ub
    np.testing.assert_array_equal(_bits(ub), _bits(jbm.ub))
    jrep, rep = _query_rep(jidx, q)
    got = blockmax.block_bounds(bm, rep)
    want = np.asarray(jblockmax.block_bounds(jbm, jrep))
    assert got.dtype == torch.float32
    if mode == "classic":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", MODES)
def test_every_block_kept_equals_dense_jax(mode):
    x, q = _data(seed=1)
    jidx, idx = _pair(mode, x)
    bm = blockmax.build_blockmax(idx.index, BLOCK)
    jrep, rep = _query_rep(jidx, q)
    got = blockmax.pruned_search(idx.index, bm, rep, bm.num_blocks, 50)
    want = jidx.pipeline.matcher(jidx.index, jrep, 51, use_kernel=False)
    assert_topk_match(got, [np.asarray(a) for a in want], exact=mode != "classic")


@pytest.mark.parametrize("mode", MODES)
def test_pruned_search_matches_jax_below_every_block(mode):
    x, q = _data(seed=2)
    jidx, idx = _pair(mode, x)
    bm = blockmax.build_blockmax(idx.index, BLOCK)
    jbm = jblockmax.build_blockmax(jidx.index, BLOCK)
    jrep, rep = _query_rep(jidx, q)
    got = blockmax.pruned_search(idx.index, bm, rep, 3, 40)
    want = jblockmax.pruned_search(jidx.index, jbm, jrep, n_keep=3, depth=41, use_kernel=False)
    assert_topk_match(got, [np.asarray(a) for a in want], exact=mode != "classic")


def test_pruned_search_clamps_n_keep_and_depth():
    x, q = _data(seed=3)
    jidx, idx = _pair("dot", x)
    bm = blockmax.build_blockmax(idx.index, BLOCK)
    jbm = jblockmax.build_blockmax(jidx.index, BLOCK)
    jrep, rep = _query_rep(jidx, q)
    for n_keep, depth in ((100, 30), (2, 200)):
        s, i = blockmax.pruned_search(idx.index, bm, rep, n_keep, depth)
        js, ji = jblockmax.pruned_search(jidx.index, jbm, jrep, n_keep=n_keep, depth=depth,
                                         use_kernel=False)
        assert s.shape == (8, depth)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert (i[:, 2 * BLOCK:] == -1).all() and (s[:, 2 * BLOCK:] == -torch.inf).all()


@pytest.mark.parametrize("mode", MODES)
def test_facade_with_blockmax_keep_matches_jax_facade(mode):
    x, q = _data(n=512, seed=4)
    cfg, jcfg = _configs(mode)
    jann = JAnnIndex.build(jnp.asarray(x), jcfg, blockmax_keep=4, blockmax_block_size=BLOCK)
    ann = AnnIndex(config=cfg, index=_port_index(jann.index), blockmax_keep=4,
                   blockmax_block_size=BLOCK)
    assert isinstance(ann.pipeline.matcher, pl.BlockMaxMatcher)
    got = ann.search(q, k=50, depth=50)
    want = jann.search(jnp.asarray(q), k=51, depth=51, use_kernel=False)
    assert_topk_match(got, [np.asarray(a) for a in want], exact=mode != "classic")
    _, rep = _query_rep(jann, q)
    direct = blockmax.pruned_search(ann.index, ann.bm, rep, 4, 50)
    assert torch.equal(got[1], direct[1]) and torch.equal(got[0], direct[0])
    # from raw vectors, each package encodes on its own
    built = AnnIndex.build(x, cfg, blockmax_keep=4, blockmax_block_size=BLOCK, device="cpu")
    assert built.bm.num_blocks == 8
    s, i = built.search(q, k=10, depth=50, rerank=True)
    js, ji = jann.search(jnp.asarray(q), k=10, depth=50, rerank=True, use_kernel=False)
    hits = (i.numpy()[:, :, None] == np.asarray(ji)[:, None, :]).any(-1).mean()
    assert hits >= 0.99


def test_index_from_numpy_keeps_blockmax_knobs(tmp_path):
    x, q = _data(n=512, seed=5)
    jann = JAnnIndex.build(jnp.asarray(x), JFakeWordsConfig(quantization=40),
                           blockmax_keep=4, blockmax_block_size=BLOCK)
    jann.save(str(tmp_path))
    meta = json.loads((tmp_path / "config.json").read_text())
    with np.load(tmp_path / "index.npz") as z:
        arrays = {name: z[name] for name in z.files}
    idx = index_from_numpy(meta["method"], meta["config"], arrays, meta["dtypes"],
                           device="cpu", blockmax_keep=meta["blockmax_keep"],
                           blockmax_block_size=meta["blockmax_block_size"])
    assert idx.blockmax_keep == 4 and idx.blockmax_block_size == BLOCK
    assert idx.bm is not None and idx.bm.num_blocks == jann.bm.num_blocks
    jloaded = JAnnIndex.load(str(tmp_path))
    got = idx.search(q, k=10, depth=50)
    want = jloaded.search(jnp.asarray(q), k=11, depth=50, use_kernel=False)
    assert_topk_match(got, [np.asarray(a) for a in want], exact=False)
    dense = index_from_numpy(meta["method"], meta["config"], arrays, meta["dtypes"],
                             device="cpu")
    assert dense.bm is None and not isinstance(dense.pipeline.matcher, pl.BlockMaxMatcher)


def test_unported_blockmax_variants_raise(tmp_path):
    """A signed store never reaches blockmax: the config refuses it; nor do
    arrays of no store of the method: the loader refuses them, naming them
    (quantized blockmax is in test_torch_quantized.py)."""
    x, _ = _data(n=300)
    with pytest.raises(NotImplementedError, match="signed_store"):
        FakeWordsConfig(scoring="dot", signed_store=True)
    jann = JAnnIndex.build(jnp.asarray(x), JFakeWordsConfig(quantization=40, scoring="dot"),
                           blockmax_keep=2, blockmax_block_size=BLOCK)
    jann.save(str(tmp_path))
    meta = json.loads((tmp_path / "config.json").read_text())
    with np.load(tmp_path / "index.npz") as z:
        arrays = {name: z[name] for name in z.files}
    arrays["pq.codes"] = np.zeros((300, 64), np.int8)
    dtypes = dict(meta["dtypes"], **{"pq.codes": "int8"})
    with pytest.raises(ValueError, match="pq.codes"):
        index_from_numpy(meta["method"], meta["config"], arrays, dtypes, device="cpu",
                         blockmax_keep=meta["blockmax_keep"],
                         blockmax_block_size=meta["blockmax_block_size"])
    with pytest.raises(ValueError, match="not supported"):
        AnnIndex.build(x, BruteForceConfig(), blockmax_keep=2, device="cpu")
