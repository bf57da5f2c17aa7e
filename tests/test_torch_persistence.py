"""``AnnIndex.save`` / ``load`` in the port, and across packages: the port
writes the reference's single-index format (``config.json`` +
``index.npz``, format_version 1), so each package loads what the other
saved.

A round trip within the port is bit for bit: the same arrays, the same
search output.  Across packages the two searches run their own code on
the same arrays: ids are held under the near-tie rule of
``torch_parity.assert_topk_match`` (scores within 1e-5; integer-scored
methods, dot and LSH, bit for bit without rerank).  The JAX side runs its
plain (XLA) search path.
"""
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_topk_match, to_torch

from repro.core.index import AnnIndex as JAnnIndex
from repro.core.types import BruteForceConfig as JBruteForceConfig
from repro.core.types import FakeWordsConfig as JFakeWordsConfig
from repro.core.types import KdTreeConfig as JKdTreeConfig
from repro.core.types import LexicalLshConfig as JLexicalLshConfig
from repro_torch.core.index import FORMAT_VERSION, AnnIndex, _named_arrays
from repro_torch.core.types import (
    BruteForceConfig,
    FakeWordsConfig,
    KdTreeConfig,
    LexicalLshConfig,
    SearchParams,
)

# (id, port config, JAX config, build knobs, integer scores)
CASES = [
    ("fakewords-classic", FakeWordsConfig(quantization=50),
     JFakeWordsConfig(quantization=50), {}, False),
    ("fakewords-dot", FakeWordsConfig(quantization=50, scoring="dot"),
     JFakeWordsConfig(quantization=50, scoring="dot"), {}, True),
    ("lsh", LexicalLshConfig(buckets=64, hashes=2), JLexicalLshConfig(buckets=64, hashes=2),
     {}, True),
    ("kdtree-pca-scan", KdTreeConfig(dims=8), JKdTreeConfig(dims=8), {}, False),
    ("kdtree-ppa-tree", KdTreeConfig(dims=8, backend="tree", reduction="ppa-pca-ppa"),
     JKdTreeConfig(dims=8, backend="tree", reduction="ppa-pca-ppa"), {}, False),
    ("bruteforce", BruteForceConfig(), JBruteForceConfig(), {}, False),
    ("classic-int8-postings", FakeWordsConfig(quantization=50),
     JFakeWordsConfig(quantization=50), {"primary_postings": "int8", "rerank_store": "int8"},
     False),
    ("dot-int4-postings", FakeWordsConfig(quantization=50, scoring="dot"),
     JFakeWordsConfig(quantization=50, scoring="dot"),
     {"primary_postings": "int4", "rerank_store": "int8"}, False),
    ("bruteforce-int4-postings", BruteForceConfig(), JBruteForceConfig(),
     {"primary_postings": "int4", "postings_group": 64, "rerank_store": "none"}, False),
    ("kdtree-no-rerank-store", KdTreeConfig(dims=4), JKdTreeConfig(dims=4),
     {"rerank_store": "none"}, False),
]
_IDS = [c[0] for c in CASES]


def _corpus(n=1000, m=64, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, m)).astype(np.float32)
    x += 0.5 * rng.normal(size=(1, m)).astype(np.float32)
    return x, x[:16] + 0.05 * rng.normal(size=(16, m)).astype(np.float32)


def _params(knobs: dict):
    """The searches a case runs: without rerank, and with it where the
    index keeps a rerank store."""
    out = [SearchParams(k=10, depth=100)]
    if knobs.get("rerank_store") != "none":
        out.append(SearchParams(k=10, depth=100, rerank=True))
    return out


@pytest.mark.parametrize("name,cfg,jcfg,knobs,exact", CASES, ids=_IDS)
def test_round_trip_bit_for_bit(tmp_path, name, cfg, jcfg, knobs, exact):
    x, q = _corpus()
    idx = AnnIndex.build(x, cfg, device="cpu", **knobs)
    path = os.path.join(tmp_path, "idx.ann")
    idx.save(path)
    loaded = AnnIndex.load(path, device="cpu")
    assert loaded.method == idx.method and loaded.config == idx.config
    assert loaded.quantized_rerank == idx.quantized_rerank and loaded.nbytes() == idx.nbytes()
    assert type(loaded.pipeline.matcher) is type(idx.pipeline.matcher)
    before, after = _named_arrays(idx.index), _named_arrays(loaded.index)
    assert before.keys() == after.keys()
    for key, t in before.items():
        assert after[key].dtype == t.dtype and torch.equal(after[key], t), key
    if getattr(idx.index, "pq", None) is not None:
        pq, lpq = idx.index.pq, loaded.index.pq
        assert (lpq.bits, lpq.group, lpq.cols) == (pq.bits, pq.group, pq.cols)
    for params in _params(knobs):
        s0, i0 = idx.search(q, params=params)
        s1, i1 = loaded.search(q, params=params)
        assert torch.equal(i0, i1) and torch.equal(s0, s1)


@pytest.mark.parametrize("name,cfg,jcfg,knobs,exact", CASES, ids=_IDS)
def test_jax_written_index_loads_and_searches_the_same(tmp_path, name, cfg, jcfg, knobs,
                                                       exact):
    x, q = _corpus(seed=1)
    jidx = JAnnIndex.build(jnp.asarray(x), jcfg, **knobs)
    path = os.path.join(tmp_path, "jax.ann")
    jidx.save(path)
    idx = AnnIndex.load(path, device="cpu")
    assert idx.method == jidx.method and idx.config == cfg
    assert idx.quantized_rerank == jidx.quantized_rerank and idx.nbytes() == jidx.nbytes()
    for params in _params(knobs):
        s, i = idx.search(q, params=params)
        js, ji = jidx.search(jnp.asarray(q), params=params, use_kernel=False)
        if exact and not params.rerank:  # integer match scores; a rerank's are cosines
            np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
            np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        else:
            assert_topk_match((s, i), (to_torch(js), to_torch(ji)), exact=False)


@pytest.mark.parametrize("name,cfg,jcfg,knobs,exact", CASES, ids=_IDS)
def test_port_written_index_loads_in_jax(tmp_path, name, cfg, jcfg, knobs, exact):
    """The JAX package's unchanged ``AnnIndex.load`` reads the port's save."""
    x, q = _corpus(seed=2)
    idx = AnnIndex.build(x, cfg, device="cpu", **knobs)
    path = os.path.join(tmp_path, "port.ann")
    idx.save(path)
    meta = json.loads(open(os.path.join(path, "config.json")).read())
    assert meta["format_version"] == FORMAT_VERSION == 1 and meta["use_kernel"] is None
    if isinstance(cfg, FakeWordsConfig):
        assert meta["config"]["store_dtype"] == "int8"
    jidx = JAnnIndex.load(path)
    assert jidx.method == idx.method and jidx.config == jcfg
    assert jidx.quantized_rerank == idx.quantized_rerank and jidx.nbytes() == idx.nbytes()
    for params in _params(knobs):
        s, i = idx.search(q, params=params)
        js, ji = jidx.search(jnp.asarray(q), params=params, use_kernel=False)
        if exact and not params.rerank:  # integer match scores; a rerank's are cosines
            np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
            np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        else:
            assert_topk_match((s, i), (to_torch(js), to_torch(ji)), exact=False)


@pytest.mark.parametrize("cfg", [FakeWordsConfig(quantization=40),
                                 LexicalLshConfig(buckets=64, hashes=2)],
                         ids=["fakewords", "lsh"])
def test_blockmax_knobs_kept_and_overridden(tmp_path, cfg):
    x, q = _corpus(n=512, seed=3)
    idx = AnnIndex.build(x, cfg, blockmax_keep=4, blockmax_block_size=64, device="cpu")
    path = os.path.join(tmp_path, "bm.ann")
    idx.save(path)
    loaded = AnnIndex.load(path, device="cpu")
    assert loaded.blockmax_keep == 4 and loaded.blockmax_block_size == 64
    assert loaded.bm is not None and loaded.bm.num_blocks == idx.bm.num_blocks
    s0, i0 = idx.search(q[:8], k=10, depth=50)
    s1, i1 = loaded.search(q[:8], k=10, depth=50)
    assert torch.equal(i0, i1) and torch.equal(s0, s1)
    # the knobs can be overridden at load time
    dense = AnnIndex.load(path, device="cpu", blockmax_keep=None)
    assert dense.bm is None and dense.blockmax_keep is None
    wider = AnnIndex.load(path, device="cpu", blockmax_keep=2, blockmax_block_size=128)
    assert wider.bm.num_blocks == 4 and wider.blockmax_keep == 2
    # and the JAX package reads them too
    jidx = JAnnIndex.load(path)
    assert jidx.blockmax_keep == 4 and jidx.blockmax_block_size == 64
    assert jidx.bm.num_blocks == idx.bm.num_blocks


def _edit_meta(path: str, **changes) -> None:
    meta_path = os.path.join(path, "config.json")
    meta = json.loads(open(meta_path).read())
    meta.update(changes)
    with open(meta_path, "w") as f:
        json.dump(meta, f)


@pytest.mark.parametrize("fault", ["newer-format", "older-format", "metadata", "segments",
                                   "nothing"])
def test_load_refuses_what_is_not_format_1(tmp_path, fault):
    x, _ = _corpus(n=200, seed=4)
    path = os.path.join(tmp_path, "idx.ann")
    AnnIndex.build(x, BruteForceConfig(), device="cpu").save(path)
    if fault in ("newer-format", "older-format"):
        version = 2 if fault == "newer-format" else 0
        _edit_meta(path, format_version=version)
        with pytest.raises(ValueError, match=f"format_version {version}") as err:
            AnnIndex.load(path, device="cpu")
        assert ("newer version" in str(err.value)) == (fault == "newer-format")
    elif fault == "metadata":  # names metadata fields, but the npz has no values
        _edit_meta(path, metadata={"field_names": ["year"]})
        with pytest.raises(KeyError, match="metadata.values"):
            AnnIndex.load(path, device="cpu")
    elif fault == "segments":
        commit = os.path.join(tmp_path, "seg")
        os.makedirs(commit)
        open(os.path.join(commit, "segments_3.json"), "w").write("{}")
        with pytest.raises(ValueError, match="SegmentedAnnIndex.load"):
            AnnIndex.load(commit, device="cpu")
    else:
        with pytest.raises(FileNotFoundError):
            AnnIndex.load(os.path.join(tmp_path, "missing"), device="cpu")


def test_load_defaults_to_cuda_and_raises_without_it(tmp_path, monkeypatch):
    x, _ = _corpus(n=200, seed=5)
    path = os.path.join(tmp_path, "kd.ann")
    AnnIndex.build(x, KdTreeConfig(dims=4), device="cpu").save(path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        AnnIndex.load(path)
    with pytest.raises(RuntimeError, match="CUDA"):
        AnnIndex.build(x, KdTreeConfig(dims=4))


def test_save_writes_bf16_as_uint16_and_overwrites(tmp_path):
    x, q = _corpus(n=300, seed=6)
    cfg = FakeWordsConfig(quantization=50)
    path = os.path.join(tmp_path, "idx.ann")
    AnnIndex.build(x[:100], cfg, device="cpu").save(path)
    idx = AnnIndex.build(x, cfg, device="cpu")
    idx.save(path)  # a second save over the first
    meta = json.loads(open(os.path.join(path, "config.json")).read())
    assert meta["dtypes"]["scored"] == "bfloat16"
    with np.load(os.path.join(path, "index.npz")) as z:
        assert z["scored"].dtype == np.uint16 and z["scored"].shape == (300, 128)
        assert sorted(z.files) == sorted(meta["dtypes"])
    loaded = AnnIndex.load(path, device="cpu")
    assert loaded.num_docs == 300
    assert torch.equal(loaded.index.scored.view(torch.int16), idx.index.scored.view(torch.int16))
    assert dataclasses.asdict(loaded.config) == dataclasses.asdict(cfg)
