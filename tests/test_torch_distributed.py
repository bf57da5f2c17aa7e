"""The port's sharded build and search (``repro_torch.core.distributed``, a
single-process device mesh) against the JAX package's ``shard_map`` path.

The JAX side runs as the reference's own sharded tests run it: in a
subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=8``
(``tests/test_distributed.py:17-33``).  It runs once for the module
(:func:`jref`) and writes every reference output to one ``.npz``; the port
runs here on a mesh of 8 x ``cpu`` (or (4, 2)) over the same numpy inputs.

Anchors: ``test_distributed.py:36,61,108``, ``test_builder.py:113,174``,
``test_quantized.py:346``, ``test_graph.py:186,219``, ``test_packed.py:286``
and ``test_segments.py:537``.  Where the reference test is red on this tree
(the blockmax padding mask: an API error under the installed jax; the build
parity: ``ppa-pca-ppa`` over its 1e-4 tolerance) the port is held to the
JAX single-device build and to the test's own assertions.  Tolerances:

  * integer modes and classic, and every row-local leaf: bit for bit;
  * f32 scores: the near-tie rule (``assert_topk_match``, 1e-5);
  * the reduction (psum'd moments, eigenvector signs free): sign-aligned
    within ``atol=1e-4`` (the reference's own tolerance);
  * reranked sharded searches see S x depth candidates, so their ids are
    held to JAX's sharded search (same candidate set) under the near-tie
    rule, and their recall to the reference's bars.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from torch_parity import assert_topk_match, to_torch

from repro.core import pca as jpca
from repro_torch.core import bruteforce, distributed, fakewords, graph, pca
from repro_torch.core import eval as ev
from repro_torch.core import pipeline as pl
from repro_torch.core.index import AnnIndex
from repro_torch.core.segments import IndexWriter
from repro_torch.core.types import (
    BruteForceConfig,
    FakeWordsConfig,
    GraphConfig,
    KdTreeConfig,
    LexicalLshConfig,
)
from repro_torch.serve.ann_service import AnnService, AnnServiceConfig

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CPU = "cpu"
AXES2 = ("data", "model")

# The encodings of test_builder.py:113, by id.
ENCODINGS = {
    "classic": FakeWordsConfig(quantization=50),
    "dot": FakeWordsConfig(quantization=50, scoring="dot"),
    "lsh": LexicalLshConfig(buckets=64, hashes=2),
    "kd-pca": KdTreeConfig(dims=8, backend="scan"),
    "kd-ppa-pca-ppa": KdTreeConfig(dims=8, backend="scan", reduction="ppa-pca-ppa"),
    "bruteforce": BruteForceConfig(),
}
FILTER_RATIOS = (0.01, 0.1, 0.5)

# Every reference output the tests below read, written by the JAX package
# under 8 fake host devices.  Keys are "<anchor>/<name>".
_JAX_SCRIPT = r'''
import dataclasses, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.core import bruteforce, distributed, fakewords, graph, pca
from repro.core import eval as ev
from repro.core import pipeline as pl
from repro.core.index import AnnIndex
from repro.core.segments import IndexWriter
from repro.core.types import (BruteForceConfig, FakeWordsConfig, GraphConfig,
                              KdTreeConfig, LexicalLshConfig)
from repro.serve.ann_service import AnnService, AnnServiceConfig
out = {}
def put(key, x):
    x = np.asarray(x)
    out[key] = x.astype(np.float32) if x.dtype.name == "bfloat16" else x
mesh42 = jax.make_mesh((4, 2), ("data", "model"))
mesh8 = jax.make_mesh((8,), ("data",))

# test_distributed.py:36
rng = np.random.default_rng(0)
vecs = jnp.asarray(rng.normal(size=(1024, 32)).astype(np.float32))
qs = vecs[:8]
cfg = FakeWordsConfig(quantization=50)
idx_sh = distributed.build_sharded(mesh42, vecs, cfg, ("data", "model"))
search = distributed.make_sharded_search(mesh42, cfg, ("data", "model"), k=10, depth=50,
                                         rerank=True)
q_tf = fakewords.encode_queries(qs, cfg)
s, i = search(idx_sh, q_tf, bruteforce.l2_normalize(qs))
put("fw/idf", idx_sh.idf); put("fw/s", s); put("fw/i", i)
idx = fakewords.build(vecs, cfg)
s1, i1 = fakewords.search(idx, q_tf, bruteforce.l2_normalize(qs), k=10, depth=50, rerank=True)
put("fw/s1", s1); put("fw/i1", i1)

# test_distributed.py:61 (red under this jax: its single-device reference)
rng = np.random.default_rng(0)
v = rng.normal(size=(1024, 32)).astype(np.float32)
q = rng.normal(size=(1, 32)).astype(np.float32)
for sh in range(8):
    v[sh * 128] = q[0]
qn = bruteforce.l2_normalize(jnp.asarray(q))
idx = fakewords.build(jnp.asarray(v), cfg)
s1, i1 = fakewords.search(idx, fakewords.encode_queries(qn, cfg), qn, k=20, depth=200,
                          rerank=True)
put("bm/i1", i1)

# test_distributed.py:108
rng = np.random.default_rng(5)
vecs = jnp.asarray(rng.normal(size=(1024, 32)).astype(np.float32))
qn = bruteforce.l2_normalize(vecs[:8])
q_tf = fakewords.encode_queries(qn, cfg)
fsearch = distributed.make_sharded_search(mesh8, cfg, ("data",), k=10, depth=64, rerank=True,
                                          filtered=True)
idx_sh = distributed.build_sharded(mesh8, vecs, cfg, ("data",))
for ratio in (0.01, 0.1, 0.5):
    m = (rng.random(1024) < ratio).astype(np.int32)
    m[:16] = 1
    s, i = fsearch(idx_sh, q_tf, qn, jnp.asarray(m))
    put(f"filt/{ratio}/mask", m); put(f"filt/{ratio}/s", s); put(f"filt/{ratio}/i", i)

# the df-prune keep mask on a shard (ROADMAP C1): columns nonzero at rates
# from 5% to 100%, so the global df spreads over (ratio N / S, ratio N]
rng = np.random.default_rng(17)
x = rng.normal(size=(1024, 32)).astype(np.float32)
x *= (rng.random((1024, 32)) < np.linspace(0.05, 1.0, 32)).astype(np.float32)
c1 = FakeWordsConfig(quantization=50, df_max_ratio=0.3)
sh = distributed.build_sharded(mesh8, jnp.asarray(x), c1, ("data",))
srch = distributed.make_sharded_search(mesh8, c1, ("data",), k=10, depth=50, rerank=False)
s, i = srch(sh, fakewords.encode_queries(jnp.asarray(x[:8]), c1), None)
put("c1/x", x); put("c1/df", sh.df); put("c1/s", s); put("c1/i", i)

# test_builder.py:113 (red: ppa-pca-ppa over 1e-4); the leaves and searches
rng = np.random.default_rng(0)
vecs = jnp.asarray(rng.normal(size=(1024, 32)).astype(np.float32))
qs = vecs[:8]
qn = bruteforce.l2_normalize(qs)
encodings = {
    "classic": FakeWordsConfig(quantization=50),
    "dot": FakeWordsConfig(quantization=50, scoring="dot"),
    "lsh": LexicalLshConfig(buckets=64, hashes=2),
    "kd-pca": KdTreeConfig(dims=8, backend="scan"),
    "kd-ppa-pca-ppa": KdTreeConfig(dims=8, backend="scan", reduction="ppa-pca-ppa"),
    "bruteforce": BruteForceConfig(),
}
for name, c in encodings.items():
    sh = distributed.build_sharded(mesh42, vecs, c, ("data", "model"))
    for f in dataclasses.fields(sh):
        x = getattr(sh, f.name)
        if x is not None and f.name != "reduction":
            put(f"parity/{name}/{f.name}", x)
    srch = distributed.make_sharded_search(mesh42, c, ("data", "model"), k=10, depth=50,
                                           rerank=True)
    s, i = srch(sh, AnnIndex(config=c, index=sh).encode_queries(qs), qn)
    put(f"parity/{name}/s", s); put(f"parity/{name}/i", i)

# test_builder.py:174
rng = np.random.default_rng(0)
vecs = jnp.asarray(rng.normal(size=(2048, 32)).astype(np.float32))
qs = np.asarray(vecs[:64]) + 0.01 * rng.normal(size=(64, 32)).astype(np.float32)
put("svc/qs", qs)
scfg = AnnServiceConfig(k=10, depth=100, rerank=True, max_batch=32)
_, gt = bruteforce.exact_topk(vecs, jnp.asarray(qs), 10)
put("svc/gt", gt)
for store in ("exact", "int8"):
    ann = AnnIndex.build(vecs, cfg, rerank_store=store, mesh=mesh8, shard_axes=("data",))
    s, i = AnnService(ann, scfg, mesh=mesh8, shard_axes=("data",)).search_batch(qs)
    put(f"svc/{store}/s", s); put(f"svc/{store}/i", i)

# test_quantized.py:346
rng = np.random.default_rng(13)
V = rng.normal(size=(512, 64)).astype(np.float32)
Q = rng.normal(size=(8, 64)).astype(np.float32)
mesh = Mesh(np.array(jax.devices()).reshape(8), ("doc",))
idx = distributed.build_sharded(mesh, jnp.asarray(V), cfg, ("doc",), rerank_store="int8",
                                primary_postings="int4")
put("int4/pq.q", idx.pq.q); put("int4/pq.scale", idx.pq.scale)
put("int4/vq.q", idx.vq.q); put("int4/vq.scale", idx.vq.scale)
fn = distributed.make_sharded_search(mesh, cfg, ("doc",), k=10, depth=512, rerank=True,
                                     rerank_store="int8", postings_bits=4)
q = bruteforce.l2_normalize(jnp.asarray(Q))
s, i = fn(idx, AnnIndex(config=cfg, index=idx).pipeline.encoder(idx, q), q)
put("int4/s", s); put("int4/i", i)

# test_graph.py:186 on integer-valued rows (exact products: ties in every
# stage), the JAX single-device build the sharded one must equal
rng = np.random.default_rng(0)
x = rng.integers(-2, 3, size=(1000, 16)).astype(np.float32)
x[500:520] = x[100:120]
nb, entry = graph.build_graph(jnp.asarray(x), GraphConfig())
put("graph/int_nb", nb); put("graph/int_entry", entry)

# test_packed.py:286
rng = np.random.default_rng(0)
w = IndexWriter(FakeWordsConfig(quantization=50), merge_policy=None, use_kernel=False)
w.add(rng.normal(size=(300, 32)).astype(np.float32)); w.flush()
w.add(rng.normal(size=(212, 32)).astype(np.float32)); w.flush()
dead = rng.choice(512, size=40, replace=False)
w.delete(dead)
reader = w.refresh()
queries = jnp.asarray(rng.normal(size=(4, 32)).astype(np.float32))
fn, idx_sh, filt_sh = distributed.make_packed_segmented_search(
    jax.make_mesh((4,), ("data",)), reader, ("data",), k=10, depth=50, rerank=True,
    use_kernel=False)
s, i = fn(idx_sh, reader.encode_queries(queries), bruteforce.l2_normalize(queries), filt_sh)
put("packed/dead", dead); put("packed/s", s); put("packed/i", i)

# the sharded reduction fits, 8 shards (pca.py:32-52)
rng = np.random.default_rng(3)
x = rng.normal(size=(1024, 32)).astype(np.float32)
x[:, :4] *= 4.0
x = x / np.linalg.norm(x, axis=1, keepdims=True)
xs = jnp.asarray(x)
from repro import compat
from jax.sharding import PartitionSpec as P
for kind in ("pca", "ppa-pca-ppa"):
    def fit(xl, kind=kind):
        model, red = pca.fit_reduction(xl, 8, kind, 3, axes=("data",), n_total=1024)
        return red
    red = compat.shard_map(fit, mesh=mesh8, in_specs=P("data", None),
                           out_specs=P("data", None), check_vma=False)(xs)
    put(f"pca/{kind}/sharded", red)
    put(f"pca/{kind}/local", pca.fit_reduction(xs, 8, kind, 3)[1])
np.savez(sys.argv[1], **out)
print("jax reference ok")
'''


@pytest.fixture(scope="module")
def jref(tmp_path_factory):
    """The JAX package's sharded outputs for every anchor below (one
    subprocess under 8 fake host devices)."""
    path = str(tmp_path_factory.mktemp("jax-sharded") / "ref.npz")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_JAX_SCRIPT), path],
                       capture_output=True, text=True, timeout=600,
                       env=dict(os.environ, PYTHONPATH=SRC))
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr[-3000:]}"
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _mesh(shape=(8,), axes=("data",)):
    return distributed.make_mesh(shape, axes, device=CPU)


def _rows(seed, n, dim):
    return np.random.default_rng(seed).normal(size=(n, dim)).astype(np.float32)


def _gathered_leaves(index):
    g = distributed.gather(index)
    return {f.name: getattr(g, f.name) for f in dataclasses.fields(g)}


def _close_to_jax(got: torch.Tensor, want: np.ndarray, leaf: str) -> None:
    """A leaf against the JAX sharded build's: integer leaves bit for bit,
    f32 leaves within rtol 1e-6 (the two packages' ``l2_normalize`` and
    ``log`` differ in the last bit), bf16 ones (saved widened to f32)
    within one bf16 step, 2**-8."""
    w = to_torch(want)
    if got.dtype.is_floating_point:
        rtol = 2.0**-8 if got.dtype == torch.bfloat16 else 1e-6
        np.testing.assert_allclose(got.float().numpy(), w.numpy(), rtol=rtol, atol=1e-7,
                                   err_msg=leaf)
    else:
        assert torch.equal(got, w), leaf


def _leaf_tensors(name, leaf):
    """(dotted name, tensor) of a leaf, through a nested store."""
    if isinstance(leaf, torch.Tensor):
        return [(name, leaf)]
    return [(f"{name}.{f.name}", getattr(leaf, f.name)) for f in dataclasses.fields(leaf)
            if isinstance(getattr(leaf, f.name), torch.Tensor)]


# -- the mesh -----------------------------------------------------------------


def test_flat_axis_index_is_row_major():
    mesh = _mesh((4, 2), AXES2)
    assert distributed.flat_axis_size(mesh, AXES2) == 8
    assert mesh.shape == {"data": 4, "model": 2}
    got = [distributed.flat_axis_index(mesh, AXES2, {"data": i, "model": j})
           for i in range(4) for j in range(2)]
    assert got == list(range(8))  # (i, j) -> 2i + j
    assert distributed.flat_axis_index(mesh, ("model", "data"), {"data": 3, "model": 1}) == 7
    assert distributed.shard_devices(mesh, ("data",)) == [torch.device(CPU)] * 4


def test_make_mesh_places_and_refuses():
    mesh = distributed.make_mesh((2, 4), AXES2, device=CPU)
    assert mesh.devices == (torch.device(CPU),) * 8 and mesh.size == 8
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            distributed.make_mesh((4,), ("data",))
    with pytest.raises(ValueError, match="needs 8 devices"):
        distributed.Mesh((torch.device(CPU),), AXES2, (4, 2))


def test_collectives_over_shard_lists():
    xs = [torch.full((2, 3), float(s)) for s in range(4)]
    assert torch.equal(distributed.psum(xs), torch.full((2, 3), 6.0))
    assert distributed.psum([1] * 4) == 4
    assert torch.equal(distributed.all_gather(xs, axis=1), torch.cat(xs, dim=1))
    assert distributed.all_gather(xs, tiled=False).shape == (4, 2, 3)
    ring = distributed.ppermute(xs, [(i, (i - 1) % 4) for i in range(4)])
    assert [int(r[0, 0]) for r in ring] == [1, 2, 3, 0]
    assert ring[0] is xs[1]  # one device: a reference, no copy
    partial = distributed.ppermute(xs, [(0, 1)])
    assert int(partial[1][0, 0]) == 0 and not partial[2].any()


# -- test_distributed.py:36: fake words, sharded == single device -------------


def test_sharded_fakewords_search_equals_single_device(jref):
    vecs = _rows(0, 1024, 32)
    qs = torch.from_numpy(vecs[:8])
    cfg = ENCODINGS["classic"]
    mesh = _mesh((4, 2), AXES2)
    idx_sh = distributed.build_sharded(mesh, vecs, cfg, AXES2)
    assert len(idx_sh.shards) == 8 and idx_sh.n_local == 128
    search = distributed.make_sharded_search(mesh, cfg, AXES2, k=10, depth=50, rerank=True)
    qn = bruteforce.l2_normalize(qs)
    s_sh, i_sh = search(idx_sh, fakewords.encode_queries(qs, cfg), qn)
    # idf from the psum'd df equals the JAX sharded build's
    np.testing.assert_allclose(idx_sh.shards[3].idf.numpy(), jref["fw/idf"], rtol=1e-6)
    assert idx_sh.shards[0].idf is idx_sh.shards[7].idf  # one copy a device
    # the same sharded search as JAX's (same per-shard candidates)
    assert_topk_match((s_sh, i_sh), (jref["fw/s"], jref["fw/i"]), exact=False)
    local = AnnIndex.build(vecs, cfg, device=CPU)
    _, i_1 = local.search(qs, k=10, depth=50, rerank=True)
    assert float(ev.overlap(i_1, i_sh)) > 0.95
    assert float(ev.overlap(to_torch(jref["fw/i1"]), i_sh)) > 0.95


# -- test_distributed.py:61: blockmax over ragged shards, the padding mask ----


def test_sharded_blockmax_search_and_rerank_padding_mask(jref):
    rng = np.random.default_rng(0)
    vecs = rng.normal(size=(1024, 32)).astype(np.float32)
    q = rng.normal(size=(1, 32)).astype(np.float32)
    for sh in range(8):  # shard-local doc 0 == the query on every shard
        vecs[sh * 128] = q[0]
    cfg = ENCODINGS["classic"]
    mesh = _mesh()
    idx_sh = distributed.build_fakewords_sharded(mesh, vecs, cfg, ("data",))
    # 128 docs a shard, block 48: 3 blocks, 16 pad rows a shard
    bm_sh = distributed.build_blockmax_sharded(mesh, idx_sh, ("data",), block_size=48)
    assert distributed.gather(bm_sh).ub.shape[0] == 24 and bm_sh.shards[0].mode == "classic"
    qn = bruteforce.l2_normalize(torch.from_numpy(q))
    search = distributed.make_sharded_search(mesh, cfg, ("data",), k=20, depth=200,
                                             rerank=True, blockmax_keep=3)
    s, i = search(idx_sh, bm_sh, fakewords.encode_queries(qn, cfg, normalized=True), qn)
    ii, ss = i.numpy()[0], s.numpy()[0]
    assert ((ii >= -1) & (ii < 1024)).all()
    # exactly the 8 planted docs score ~1.0; no fake ids (-1 + shard * 128)
    assert set(ii[ss > 0.999].tolist()) == set(range(0, 1024, 128))
    vn = bruteforce.l2_normalize(torch.from_numpy(vecs)).numpy()
    for idd, sc in zip(ii, ss):
        if idd >= 0:  # every score is the true cosine of its id
            np.testing.assert_allclose(sc, qn.numpy()[0] @ vn[idd], rtol=1e-4, atol=1e-5)
    # keep-all blockmax against the dense search (the JAX single-device one)
    assert float(ev.overlap(to_torch(jref["bm/i1"]), i)) > 0.9


# -- test_distributed.py:108: the (N,) bitmap split with the rows -------------


@pytest.mark.parametrize("ratio", FILTER_RATIOS)
def test_sharded_filtered_search_equals_local_filtered(jref, ratio):
    vecs = _rows(5, 1024, 32)
    cfg = ENCODINGS["classic"]
    mesh = _mesh()
    idx_sh = distributed.build_sharded(mesh, vecs, cfg, ("data",))
    search = distributed.make_sharded_search(mesh, cfg, ("data",), k=10, depth=64,
                                             rerank=True, filtered=True)
    qn = bruteforce.l2_normalize(torch.from_numpy(vecs[:8]))
    q_tf = fakewords.encode_queries(qn, cfg, normalized=True)
    m = jref[f"filt/{ratio}/mask"]
    s_sh, i_sh = search(idx_sh, q_tf, qn, m)
    local = AnnIndex.build(vecs, cfg, device=CPU)
    s_l, i_l = pl.match_rerank(pl.make_matcher(cfg), local.index, q_tf, qn, k=10, depth=64,
                               rerank=True, filt=pl.as_filter(m, 1024, 8, CPU))
    assert torch.equal(i_sh, i_l)
    assert ((i_sh < 0) | torch.from_numpy(m[np.maximum(i_sh.numpy(), 0)] != 0)).all()
    assert_topk_match((s_sh, i_sh), (jref[f"filt/{ratio}/s"], jref[f"filt/{ratio}/i"]),
                      exact=False)


def test_sharded_filtered_all_ones_and_all_zeros():
    vecs = _rows(5, 1024, 32)
    cfg = ENCODINGS["classic"]
    mesh = _mesh()
    idx_sh = distributed.build_sharded(mesh, vecs, cfg, ("data",))
    qn = bruteforce.l2_normalize(torch.from_numpy(vecs[:8]))
    q_tf = fakewords.encode_queries(qn, cfg, normalized=True)
    kw = dict(k=10, depth=64, rerank=True)
    search = distributed.make_sharded_search(mesh, cfg, ("data",), filtered=True, **kw)
    s0, i0 = distributed.make_sharded_search(mesh, cfg, ("data",), **kw)(idx_sh, q_tf, qn)
    s1, i1 = search(idx_sh, q_tf, qn, torch.ones(1024, dtype=torch.int32))
    assert torch.equal(i0, i1) and torch.equal(s0, s1)
    s2, i2 = search(idx_sh, q_tf, qn, np.zeros(1024, np.int32))
    assert (i2 == -1).all() and not torch.isnan(s2).any()
    with pytest.raises(ValueError, match=r"shared \(N,\) mask"):
        search(idx_sh, q_tf, qn, torch.ones((8, 1024), dtype=torch.bool))


# -- ROADMAP C1: the sharded df-prune mask counts the shard's own rows --------


def test_sharded_df_prune_counts_local_rows(jref):
    """At ``df_max_ratio`` 0.3 over 8 shards of 128 rows, a term is kept
    when its collection df is at most 0.3 x 128 on each shard (the
    reference's ``index.num_docs`` inside ``shard_map``), not 0.3 x 1024:
    the match-only search equals the JAX sharded one bit for bit, and
    differs from the monolithic search, which keeps more terms."""
    x = jref["c1/x"]
    cfg = FakeWordsConfig(quantization=50, df_max_ratio=0.3)
    mesh = _mesh()
    idx_sh = distributed.build_sharded(mesh, x, cfg, ("data",))
    df = idx_sh.shards[0].df
    assert torch.equal(df, to_torch(jref["c1/df"]))
    bites = (df > 0.3 * 128) & (df <= 0.3 * 1024)
    assert bites.any() and (df <= 0.3 * 128).any()  # the mask bites, and keeps some terms
    search = distributed.make_sharded_search(mesh, cfg, ("data",), k=10, depth=50,
                                             rerank=False)
    q_tf = fakewords.encode_queries(torch.from_numpy(x[:8]), cfg)
    s_sh, i_sh = search(idx_sh, q_tf, None)
    assert torch.equal(i_sh, to_torch(jref["c1/i"]))
    assert torch.equal(s_sh, to_torch(jref["c1/s"]))
    mono = AnnIndex.build(x, cfg, device=CPU)
    s_m, _ = pl.match_rerank(pl.make_matcher(cfg), mono.index, q_tf, None, k=10, depth=50,
                             rerank=False)
    assert not torch.equal(s_m, s_sh)


# -- test_builder.py:113: sharded build == local build, every encoding --------


@pytest.mark.parametrize("name", list(ENCODINGS))
def test_sharded_build_parity_all_encodings(jref, name):
    vecs = _rows(0, 1024, 32)
    qs = torch.from_numpy(vecs[:8])
    qn = bruteforce.l2_normalize(qs)
    cfg = ENCODINGS[name]
    mesh = _mesh((4, 2), AXES2)
    local = AnnIndex.build(vecs, cfg, device=CPU)
    sh = distributed.build_sharded(mesh, vecs, cfg, AXES2)
    got = _gathered_leaves(sh)
    exact = not isinstance(cfg, KdTreeConfig)
    for f in dataclasses.fields(local.index):
        want = getattr(local.index, f.name)
        if f.name == "reduction" or want is None:
            continue
        for leaf, t in _leaf_tensors(f.name, want):
            g = dict(_leaf_tensors(f.name, got[f.name]))[leaf]
            ref = jref[f"parity/{name}/{leaf}"]
            if exact or leaf == "vectors":
                assert torch.equal(g, t), leaf  # against the port's local build
                _close_to_jax(g, ref, leaf)
            else:  # eigenvector signs are free: align columns first
                a, b = t.numpy(), g.numpy()
                sign = np.sign(np.sum(a * b, axis=0))
                sign[sign == 0] = 1.0
                # the port's figure: kd-pca 7.9e-6, kd-ppa-pca-ppa 9.2e-5
                np.testing.assert_allclose(a, b * sign, atol=1e-4, err_msg=leaf)
    # the same sharded search over both builds, each encoding its queries
    # through its own model (the reference test's check)
    search = distributed.make_sharded_search(mesh, cfg, AXES2, k=10, depth=50, rerank=True)
    s_a, i_a = search(sh, AnnIndex(config=cfg, index=sh).encode_queries(qs), qn)
    s_b, i_b = search(distributed.shard_index(mesh, local.index, AXES2),
                      local.encode_queries(qs), qn)
    assert_topk_match((s_a, i_a), (s_b, i_b), exact=exact)
    # and JAX's sharded search over its own sharded build
    assert_topk_match((s_a, i_a), (jref[f"parity/{name}/s"], jref[f"parity/{name}/i"]),
                      exact=False)


def test_sharded_build_refuses_the_tree_backend_and_ragged_shards():
    vecs = _rows(0, 1024, 32)
    with pytest.raises(ValueError, match="backend='scan'"):
        distributed.build_sharded(_mesh(), vecs, KdTreeConfig(dims=8, backend="tree"),
                                  ("data",))
    with pytest.raises(ValueError, match="not divisible"):
        distributed.build_sharded(_mesh(), vecs[:1020], ENCODINGS["classic"], ("data",))
    tree = AnnIndex.build(vecs, KdTreeConfig(dims=8, backend="tree"), device=CPU)
    with pytest.raises(ValueError, match="backend='scan'"):
        distributed.shard_index(_mesh(), tree.index, ("data",))
    with pytest.raises(ValueError, match="backend='scan'"):
        distributed.make_sharded_search(_mesh(), KdTreeConfig(dims=8, backend="tree"),
                                        ("data",))


# -- match only: the merge is the monolithic top-k ---------------------------


MATCH_ONLY = {
    **ENCODINGS,
    "classic-int8": (FakeWordsConfig(quantization=50), "int8"),
    "classic-int4": (FakeWordsConfig(quantization=50), "int4"),
    "dot-int4": (FakeWordsConfig(quantization=50, scoring="dot"), "int4"),
    "bruteforce-int8": (BruteForceConfig(), "int8"),
}


@pytest.mark.parametrize("name", list(MATCH_ONLY))
def test_match_only_merge_equals_monolithic(name):
    """Each shard's list is sorted (score desc, id asc) and shard s's ids lie
    below shard s + 1's, so one stable top-k over the gathered lists is the
    monolithic top-k: bit for bit (the reduced rows are the monolithic
    build's, split, so the kd scan's f32 scores are the same products)."""
    cfg, postings = MATCH_ONLY[name] if isinstance(MATCH_ONLY[name], tuple) else (
        MATCH_ONLY[name], "fp32")
    vecs = _rows(7, 2048, 48)
    vecs[1000:1016] = vecs[:16]  # duplicate rows across shards: exact ties
    q = torch.from_numpy(_rows(8, 16, 48))
    q[:4] = torch.from_numpy(vecs[:4])
    local = AnnIndex.build(vecs, cfg, primary_postings=postings, device=CPU)
    mesh = _mesh()
    sh = AnnIndex(config=cfg, index=distributed.shard_index(mesh, local.index, ("data",)))
    for k, depth in ((10, 100), (50, 50), (5, 300)):
        want = local.search(q, k=k, depth=depth)
        got = sh.search(q, k=k, depth=depth)
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0]), (k, depth)


# -- test_builder.py:174: the int8 store, served over the mesh ----------------


def test_sharded_quantized_rerank_end_to_end(jref):
    vecs = _rows(0, 2048, 32)
    qs = jref["svc/qs"]
    cfg = ENCODINGS["classic"]
    mesh = _mesh()
    scfg = AnnServiceConfig(k=10, depth=100, rerank=True, max_batch=32)
    gt = to_torch(jref["svc/gt"])
    recalls = {}
    for store in ("exact", "int8"):
        ann = AnnIndex.build(vecs, cfg, rerank_store=store, mesh=mesh, shard_axes=("data",))
        local = distributed.first_shard(ann.index)
        assert (local.vq is None) == (store == "exact")
        assert isinstance(ann.index, distributed.ShardedIndex)
        s, ids = AnnService(ann, scfg, mesh=mesh, shard_axes=("data",)).search_batch(qs)
        assert_topk_match((s, ids), (jref[f"svc/{store}/s"], jref[f"svc/{store}/i"]),
                          exact=False)
        recalls[store] = float(ev.recall_at(gt, torch.from_numpy(ids)))
    assert recalls["exact"] > 0.9, recalls
    assert abs(recalls["exact"] - recalls["int8"]) <= 0.01, recalls


def test_service_over_mesh_equals_make_sharded_search():
    """AnnService(mesh=) == make_sharded_search on the same rows: a
    monolithic AnnIndex is split at bind, blockmax runs the shards' own
    bounds, an (N,) filter is split with the rows, and the async path
    serves the same results."""
    vecs = _rows(2, 1024, 32)
    qs = _rows(3, 40, 32)
    cfg = ENCODINGS["classic"]
    mesh = _mesh((4,), ("data",))
    ann = AnnIndex.build(vecs, cfg, device=CPU)
    qn = bruteforce.l2_normalize(torch.from_numpy(qs))
    mask = (np.random.default_rng(4).random(1024) < 0.3).astype(np.int32)
    for keep in (None, 2):
        svc = AnnService(ann, AnnServiceConfig(k=10, depth=50, max_batch=16,
                                               blockmax_keep=keep), mesh=mesh)
        assert isinstance(svc.index, distributed.ShardedIndex)
        sh = svc.index
        bm = (distributed.build_blockmax_sharded(mesh, sh, ("data",), 256)
              if keep is not None else None)
        for filt in (None, mask):
            fn = distributed.make_sharded_search(mesh, cfg, ("data",), k=10, depth=50,
                                                 rerank=True, blockmax_keep=keep,
                                                 filtered=filt is not None)
            want = fn(*((sh,) + ((bm,) if bm is not None else ()) + (
                ann.encode_queries(qs), qn) + (() if filt is None else (filt,))))
            got = svc.search_batch(qs, filter=filt)
            assert np.array_equal(got[1], want[1].numpy())
            assert np.array_equal(got[0], want[0].numpy())
        svc.start_async()
        res = [f.result(timeout=60) for f in [svc.search_async(row) for row in qs[:8]]]
        svc.stop_async()
        assert np.array_equal(np.concatenate([r[1] for r in res]),
                              svc.search_batch(qs[:8])[1])
    with pytest.raises(ValueError, match=r"shared \(N,\) mask"):
        svc.search_batch(qs[:4], filter=np.ones((4, 1024), np.int32))


# -- test_quantized.py:346: int4 postings, sharded ----------------------------


def test_sharded_int4_build_and_search_parity(jref):
    rng = np.random.default_rng(13)
    V = rng.normal(size=(512, 64)).astype(np.float32)
    Q = torch.from_numpy(rng.normal(size=(8, 64)).astype(np.float32))
    mesh = distributed.make_mesh((8,), ("doc",), device=CPU)
    cfg = ENCODINGS["classic"]
    local = AnnIndex.build(V, cfg, rerank_store="int8", primary_postings="int4", device=CPU)
    idx = distributed.build_sharded(mesh, V, cfg, ("doc",), rerank_store="int8",
                                    primary_postings="int4")
    g = distributed.gather(idx)
    for leaf in ("pq.q", "pq.scale", "vq.q", "vq.scale"):
        store, field = leaf.split(".")
        t = getattr(getattr(g, store), field)
        assert torch.equal(t, getattr(getattr(local.index, store), field)), leaf
        _close_to_jax(t, jref[f"int4/{leaf}"], leaf)
    fn = distributed.make_sharded_search(mesh, cfg, ("doc",), k=10, depth=512, rerank=True,
                                         rerank_store="int8", postings_bits=4)
    q = bruteforce.l2_normalize(Q)
    s, i = fn(idx, AnnIndex(config=cfg, index=idx).pipeline.encoder(idx.shards[0], q), q)
    ls, li = local.search(Q, k=10, depth=512, rerank=True)
    assert torch.equal(i, li)
    np.testing.assert_allclose(s.numpy(), ls.numpy(), rtol=1e-5, atol=1e-5)
    assert_topk_match((s, i), (jref["int4/s"], jref["int4/i"]), exact=False)
    with pytest.raises(ValueError, match="4-bit"):
        distributed.make_sharded_search(mesh, cfg, ("doc",), rerank_store="int8",
                                        postings_bits=8)(idx, q, q)


# -- test_graph.py:186,219: the ring build; shard-local search refused --------


def _integer_rows():
    rng = np.random.default_rng(0)
    x = rng.integers(-2, 3, size=(1000, 16)).astype(np.float32)
    x[500:520] = x[100:120]
    return x


@pytest.mark.parametrize("layout", ["ring-8", "ring-2", "gathered-4x2"])
def test_graph_sharded_build_parity(jref, layout):
    """The reference test's rows (1024 x 64, ef 128, beam 8): the sharded
    adjacency and entry points equal ``build_graph``'s (its
    ``array_equal``); and on integer-valued rows with duplicates (exact
    ties in every stage) the ring build equals the JAX single-device
    build bit for bit."""
    shape, axes = {"ring-8": ((8,), ("data",)), "ring-2": ((2,), ("data",)),
                   "gathered-4x2": ((4, 2), AXES2)}[layout]
    mesh = _mesh(shape, axes)
    v = _rows(0, 1024, 64)
    cfg = GraphConfig(ef=128, beam=8)
    idx = distributed.build_sharded(mesh, v, cfg, axes)
    nb, entry = graph.build_graph(bruteforce.l2_normalize(torch.from_numpy(v)), cfg)
    g = distributed.gather(idx)
    assert torch.equal(g.neighbors, nb) and torch.equal(g.entry, entry)
    assert idx.shards[0].entry is idx.shards[-1].entry
    # integer-valued rows: every product exact, ties everywhere
    x = _integer_rows()
    if x.shape[0] % distributed.flat_axis_size(mesh, axes) == 0:
        rows = distributed.shard_rows(mesh, x, axes)
        nbs, entries = graph.build_graph_sharded(rows, GraphConfig(), axes, x.shape[0])
        assert torch.equal(torch.cat(nbs), to_torch(jref["graph/int_nb"]))
        assert torch.equal(entries[0], to_torch(jref["graph/int_entry"]))


def test_graph_sharded_search_raises():
    with pytest.raises(TypeError, match="shard-local"):
        distributed.make_sharded_search(None, GraphConfig(), ("data",))


# -- test_packed.py:286: packed segments over the mesh ------------------------


def test_packed_sharded_composition(jref):
    rng = np.random.default_rng(0)
    w = IndexWriter(FakeWordsConfig(quantization=50), merge_policy=None, device=CPU)
    w.add(rng.normal(size=(300, 32)).astype(np.float32))
    w.flush()
    w.add(rng.normal(size=(212, 32)).astype(np.float32))
    w.flush()
    dead = rng.choice(512, size=40, replace=False)
    np.testing.assert_array_equal(dead, jref["packed/dead"])
    w.delete(dead)
    reader = w.refresh()  # 512 rows -> bucket 512: divisible by 4
    queries = torch.from_numpy(rng.normal(size=(4, 32)).astype(np.float32))
    mesh = _mesh((4,), ("data",))
    fn, idx_sh, filt_sh = distributed.make_packed_segmented_search(
        mesh, reader, ("data",), k=10, depth=50, rerank=True)
    s_sh, i_sh = fn(idx_sh, reader.encode_queries(queries), bruteforce.l2_normalize(queries),
                    filt_sh)
    s_1, i_1 = reader.search(queries, k=10, depth=50, rerank=True, packed=False)
    assert float(ev.overlap(i_1, i_sh)) >= 0.95
    np.testing.assert_allclose(s_1[:, :8].numpy(), s_sh[:, :8].numpy(), rtol=1e-4, atol=1e-5)
    assert not np.isin(i_sh.numpy(), dead).any()
    assert_topk_match((s_sh, i_sh), (jref["packed/s"], jref["packed/i"]), exact=False)
    # a predicate over global ids, and a bucket the shard count does not divide
    keep = np.zeros(512, np.int32)
    keep[::3] = 1
    fn, idx_sh, filt_sh = distributed.make_packed_segmented_search(
        mesh, reader, ("data",), k=10, depth=50, filter_mask=keep)
    _, i_f = fn(idx_sh, reader.encode_queries(queries), None, filt_sh)
    assert ((i_f.numpy() % 3 == 0) | (i_f.numpy() < 0)).all()
    with pytest.raises(ValueError, match="not divisible"):
        distributed.make_packed_segmented_search(_mesh((3,), ("data",)), reader, ("data",))


# -- test_segments.py:537: a segmented reader refuses a mesh ------------------


def test_segmented_service_refuses_a_mesh():
    w = IndexWriter(BruteForceConfig(), merge_policy=None, device=CPU)
    w.add(_rows(0, 64, 16))
    reader = w.refresh()
    with pytest.raises(ValueError, match="single-process"):
        AnnService(reader, mesh=_mesh())


# -- the sharded reduction fits (pca.py:32-52) --------------------------------


def _fit_rows():
    """Unit rows (as the k-d build fits them) with four dominant columns."""
    x = _rows(3, 1024, 32)
    x[:, :4] *= 4.0
    return torch.from_numpy(x / np.linalg.norm(x, axis=1, keepdims=True))


@pytest.mark.parametrize("kind", ["pca", "ppa-pca-ppa"])
def test_sharded_fit_one_shard_is_the_local_fit(kind):
    x = _fit_rows()
    model, red = pca.fit_reduction(x, 8, kind, 3)
    model1, red1 = pca.fit_reduction([x], 8, kind, 3, axes=("data",), n_total=x.shape[0])
    assert torch.equal(red1[0], red)
    assert all(torch.equal(a, b) for a, b in zip(_model_tensors(model1), _model_tensors(model)))


def _model_tensors(model):
    if isinstance(model, pca.PcaModel):
        return [model.mean, model.components]
    return [t for part in (model.ppa1, model.pca, model.ppa2)
            for t in dataclasses.astuple(part)]


@pytest.mark.parametrize("kind", ["pca", "ppa-pca-ppa"])
def test_sharded_fit_on_eight_shards(jref, kind):
    """Eight shards against the JAX sharded fit and the JAX local fit
    (``repro.core.pca``), columns sign-aligned, within 1e-4."""
    x = _fit_rows()
    _, red = pca.fit_reduction(list(x.chunk(8)), 8, kind, 3, axes=("data",), n_total=1024)
    got = torch.cat(red).numpy()
    for want in (jref[f"pca/{kind}/sharded"], jref[f"pca/{kind}/local"],
                 np.asarray(jpca.fit_reduction(x.numpy(), 8, kind, 3)[1])):
        sign = np.sign(np.sum(want * got, axis=0))
        np.testing.assert_allclose(got * sign, want, atol=1e-4)
    with pytest.raises(ValueError, match="n_total"):
        pca.pca_fit(list(x.chunk(8)), 8, axes=("data",))


# -- the facade, save and nbytes ---------------------------------------------


def test_annindex_over_a_mesh_saves_gathered(tmp_path):
    vecs = _rows(1, 512, 32)
    cfg = KdTreeConfig(dims=8, backend="scan")
    ann = AnnIndex.build(vecs, cfg, mesh=_mesh(), shard_axes=("data",))
    assert ann.method == "kd-tree" and ann.num_docs == 512
    local = distributed.gather(ann.index)
    assert ann.nbytes() == local.nbytes()
    path = str(tmp_path / "idx")
    ann.save(path)
    back = AnnIndex.load(path, device=CPU)
    assert torch.equal(back.index.reduced, local.reduced)
    q = _rows(9, 8, 32)
    assert torch.equal(back.search(q, k=10, depth=50)[1], ann.search(q, k=10, depth=50)[1])
