"""The port's k-d tree encoding against the JAX package's: the reductions
(``core/pca.py``), the host tree build, the lifted L2 scan on K1 f32's plain
route, the batched tree DFS, the facade, and ``exact_topk_tiled``.

Inputs are made from a numpy seed and go to both packages.  An
eigenvector's sign is fixed by neither ``eigh``, so fitted components are
held sign-invariantly (|diag(C_jax^T C_port)| >= 1 - 1e-4) on data with a
distinct spectrum; means within 1e-5, reduced pairwise distances within
1e-4.  Top-k results are held under the near-tie rule of
``torch_parity.assert_topk_match`` (scores within 1e-5; ids equal wherever
the wanted score stands 1e-5 clear of its neighbours).  The JAX side runs
its Pallas top-k in interpret mode, or its plain (XLA) search path.
"""
import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_topk_match, to_torch

from repro.core import bruteforce as jbruteforce
from repro.core import kdtree as jkdtree
from repro.core import pca as jpca
from repro.core.index import AnnIndex as JAnnIndex
from repro.core.types import KdTreeConfig as JKdTreeConfig
from repro.kernels.fused_topk import ops as jops
from repro_torch.core import bruteforce, kdtree, pca
from repro_torch.core import eval as ev
from repro_torch.core.index import AnnIndex, index_from_numpy
from repro_torch.core.types import KdTreeConfig
from repro_torch.kernels.fused_topk import ops

DIM = 32


def _spectral(n=1500, dim=DIM, seed=0):
    """Rows with a distinct spectrum (variances 2^-j/2 along a random basis)
    and a common mean, as float32."""
    rng = np.random.default_rng(seed)
    basis, _ = np.linalg.qr(rng.normal(size=(dim, dim)))
    z = rng.normal(size=(n, dim)) * np.sqrt(2.0 ** (-np.arange(dim) / 2.0))
    return (z @ basis.T + 0.3 * rng.normal(size=(1, dim))).astype(np.float32)


def _corpus(n=2000, m=64, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, m)).astype(np.float32)
    x += 0.5 * rng.normal(size=(1, m)).astype(np.float32)
    return x


def _same_columns(got: torch.Tensor, want) -> None:
    """Unit columns equal up to sign: |diag(want^T got)| >= 1 - 1e-4."""
    dots = np.abs(np.sum(np.asarray(want) * got.numpy(), axis=0))
    assert dots.min() >= 1 - 1e-4, dots


def _pairwise(a) -> np.ndarray:
    a = np.asarray(a, np.float64)
    return np.linalg.norm(a[:, None] - a[None], axis=-1)


# -- the reductions ----------------------------------------------------------


@pytest.mark.parametrize("kind", ["pca", "ppa", "ppa-pca-ppa"])
def test_fits_match_jax_sign_invariantly(kind):
    x = _spectral()
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if kind == "pca":
        jm, m = jpca.pca_fit(jx, 8), pca.pca_fit(tx, 8)
        pairs = [(m.mean, jm.mean, m.components, jm.components)]
        jout, out = jpca.pca_apply(jm, jx), pca.pca_apply(m, tx)
    elif kind == "ppa":
        jm, m = jpca.ppa_fit(jx, 3), pca.ppa_fit(tx, 3)
        pairs = [(m.mean, jm.mean, m.top, jm.top)]
        jout, out = jpca.ppa_apply(jm, jx), pca.ppa_apply(m, tx)
        # the projection removed is sign-invariant: outputs agree outright
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-4, atol=1e-4)
    else:
        jm, m = jpca.ppa_pca_ppa_fit(jx, 8, 3), pca.ppa_pca_ppa_fit(tx, 8, 3)
        pairs = [(m.ppa1.mean, jm.ppa1.mean, m.ppa1.top, jm.ppa1.top),
                 (m.pca.mean, jm.pca.mean, m.pca.components, jm.pca.components),
                 (m.ppa2.mean, jm.ppa2.mean, m.ppa2.top, jm.ppa2.top)]
        assert m.ppa2.top.shape == (8, 3)  # r2 = max(1, min(remove, out_dim - 1))
        jout, out = jpca.ppa_pca_ppa_apply(jm, jx), pca.ppa_pca_ppa_apply(m, tx)
    for mean, jmean, comps, jcomps in pairs:
        assert comps.shape == tuple(jcomps.shape) and comps.dtype == torch.float32
        np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=1e-5, atol=1e-5)
        _same_columns(comps, jcomps)
    assert out.shape == tuple(jout.shape)
    np.testing.assert_allclose(_pairwise(out[:200]), _pairwise(jout[:200]), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind", ["pca", "ppa-pca-ppa"])
def test_fit_reduction_dispatch_matches_apply(kind):
    x = torch.from_numpy(_spectral(n=600, seed=1))
    model, reduced = pca.fit_reduction(x, 4, kind, ppa_remove=2)
    assert reduced.shape == (600, 4)
    assert torch.equal(pca.apply_reduction(model, x), reduced)
    with pytest.raises(ValueError, match="unknown reduction"):
        pca.fit_reduction(x, 4, "svd")
    with pytest.raises(TypeError, match="unknown reduction model"):
        pca.apply_reduction(object(), x)


def test_pca_reconstruction_quality():
    """Mirror of the reference's test: PCA to the true rank keeps distances."""
    rng = np.random.default_rng(0)
    w = rng.normal(size=(5, 32)).astype(np.float32)
    z = rng.normal(size=(500, 5)).astype(np.float32)
    x = torch.from_numpy(z @ w)
    proj = pca.pca_apply(pca.pca_fit(x, 5), x)
    np.testing.assert_allclose(_pairwise(proj[:50]), _pairwise(x[:50]), rtol=1e-3, atol=1e-3)


def test_ppa_removes_common_mean():
    """Mirror of the reference's test."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(400, 32)).astype(np.float32)
    x += 5.0 * rng.normal(size=(1, 32)).astype(np.float32)
    x = torch.from_numpy(x)
    out = pca.ppa_apply(pca.ppa_fit(x, remove=2), x)
    assert float(torch.linalg.vector_norm(out.mean(dim=0))) < 1e-3


# -- the host tree build -----------------------------------------------------


@pytest.mark.parametrize("n,leaf_size,grow", [(256, 32, False), (300, 32, False),
                                              (1000, 16, False), (300, 32, True),
                                              (1, 32, False)])
def test_build_arrays_bit_equal_to_jax(n, leaf_size, grow, monkeypatch):
    """N a multiple of ``leaf_size``, not a multiple, and (``grow``) the
    branch where the leaves are too few for the points and ``leaf_size``
    grows: both copies reach it when ``math.log2`` rounds down."""
    pts = np.random.default_rng(n).normal(size=(n, 8)).astype(np.float32)
    pts[: n // 3, 2] = pts[0, 2]  # ties at the medians: the stable sort decides
    if grow:
        log2 = math.log2
        monkeypatch.setattr(math, "log2", lambda v: float(math.floor(log2(v))))
    got = kdtree._build_arrays(pts, leaf_size)
    want = jkdtree._build_arrays(pts, leaf_size)
    if grow:
        assert got[2].shape[1] > leaf_size
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[3] == want[3]
    ids = got[2][got[2] >= 0]
    assert sorted(ids.tolist()) == list(range(n))


# -- the lifted L2 scan (K1 f32) -----------------------------------------------


@pytest.mark.parametrize("dims,b,n,depth", [(8, 6, 700, 50), (4, 9, 513, 100), (8, 1, 300, 300)])
def test_lift_and_scan_l2_topk_match_jax(dims, b, n, depth):
    rng = np.random.default_rng(dims + n)
    pts = rng.normal(size=(n, dims)).astype(np.float32) * 0.4
    q = rng.normal(size=(b, dims)).astype(np.float32) * 0.4
    jlifted = jops.lift_l2(jnp.asarray(pts))
    lifted = ops.lift_l2(torch.from_numpy(pts))
    assert lifted.shape == (n, dims + 1) and lifted.is_contiguous()
    np.testing.assert_allclose(lifted.numpy(), np.asarray(jlifted), rtol=1e-6, atol=1e-6)
    want = jops.scan_l2_topk(jlifted, jnp.asarray(q), min(depth + 1, n), interpret=True)
    got = ops.scan_l2_topk(lifted, torch.from_numpy(q), depth)
    assert_topk_match(got, want, exact=False)
    # the lifted score is -||q - d||^2 + ||q||^2
    d2 = ((pts[None] - q[:, None]) ** 2).sum(-1)
    s, i = got
    np.testing.assert_allclose(
        s.numpy(), -np.take_along_axis(d2, i.numpy().astype(np.int64), 1)
        + (q * q).sum(-1, keepdims=True), rtol=1e-5, atol=1e-5)


# -- the index: built by JAX, carried across ----------------------------------


def _carried(tmp_path, cfg: JKdTreeConfig, x: np.ndarray, keep_vectors=True):
    """The JAX index, and the port's from the arrays its save wrote."""
    jidx = JAnnIndex.build(jnp.asarray(x), cfg, keep_vectors=keep_vectors)
    jidx.save(str(tmp_path))
    meta = json.loads((tmp_path / "config.json").read_text())
    with np.load(tmp_path / "index.npz") as z:
        arrays = {name: z[name] for name in z.files}
    idx = index_from_numpy(meta["method"], meta["config"], arrays, meta["dtypes"], device="cpu")
    return jidx, idx


@pytest.mark.parametrize("reduction", ["pca", "ppa-pca-ppa"])
def test_tree_search_on_jax_arrays_matches_jax(tmp_path, reduction):
    """The lock-step DFS over the JAX index's own arrays: ids equal, scores
    within 1e-5, at k within one leaf and past several."""
    x = _corpus(seed=2)
    jidx, idx = _carried(tmp_path, JKdTreeConfig(dims=8, backend="tree", reduction=reduction), x)
    assert idx.method == "kd-tree" and idx.nbytes() == jidx.nbytes()
    assert isinstance(idx.index.reduction, pca.PcaModel if reduction == "pca"
                      else pca.PpaPcaPpaModel)
    for name in ("split_dim", "split_val", "perm", "reduced", "lifted"):
        assert torch.equal(getattr(idx.index, name), to_torch(getattr(jidx.index, name)))
    jqr = jkdtree.reduce_queries(jidx.index, jnp.asarray(x[:8] + 0.05))
    for k in (5, 32, 100):
        js, ji = jkdtree.tree_search(jidx.index, jqr, k)
        s, i = kdtree.tree_search(idx.index, to_torch(jqr), k)
        assert s.shape == (8, k) and i.dtype == torch.int32
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)


def test_tree_equals_scan():
    """Mirror of the reference's test_kdtree_tree_equals_scan, in the port:
    the same neighbours; the tree's score is -||q - d||^2, the scan's that
    plus ||q||^2."""
    rng = np.random.default_rng(0)
    v = rng.normal(size=(500, 32)).astype(np.float32)
    for reduction in ("pca", "ppa-pca-ppa"):
        it = AnnIndex.build(v, KdTreeConfig(dims=8, backend="tree", reduction=reduction),
                            device="cpu")
        is_ = AnnIndex.build(v, KdTreeConfig(dims=8, backend="scan", reduction=reduction),
                             device="cpu")
        st, idt = it.search(v[:8], k=5, depth=5)
        ss, ids = is_.search(v[:8], k=5, depth=5)
        assert float(ev.overlap(idt, ids)) > 0.99
        qr = kdtree.reduce_queries(is_.index, torch.from_numpy(v[:8]))
        np.testing.assert_allclose(st + (qr * qr).sum(-1, keepdim=True), ss,
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("backend", ["scan", "tree"])
@pytest.mark.parametrize("reduction", ["pca", "ppa-pca-ppa"])
def test_facade_search_on_a_carried_index_matches_jax(tmp_path, reduction, backend):
    x = _corpus(seed=3)
    q = x[:24] + 0.05 * np.random.default_rng(4).normal(size=(24, x.shape[1])).astype(np.float32)
    jidx, idx = _carried(tmp_path, JKdTreeConfig(dims=8, reduction=reduction, backend=backend), x)
    # the encoder: the same reduced points, up to rounding
    jqr = jidx.pipeline.encoder(jidx.index, jbruteforce.l2_normalize(jnp.asarray(q)))
    qr = idx.pipeline.encoder(idx.index, bruteforce.l2_normalize(torch.from_numpy(q)))
    np.testing.assert_allclose(qr.numpy(), np.asarray(jqr), rtol=1e-5, atol=1e-5)
    # the match stage on the same reduced queries
    want = jidx.pipeline.matcher(jidx.index, jqr, 51, use_kernel=False)
    got = idx.pipeline.matcher(idx.index, to_torch(jqr), 50)
    assert_topk_match(got, want, exact=False)
    for rerank in (False, True):
        js, ji = jidx.search(jnp.asarray(q), k=10, depth=100, rerank=rerank, use_kernel=False)
        s, i = idx.search(q, k=10, depth=100, rerank=rerank)
        assert s.shape == (24, 10) and bool(torch.isfinite(s).all())
        assert float(ev.overlap(to_torch(ji), i)) >= 0.99
        np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("backend", ["scan", "tree"])
def test_module_wrappers_match_the_facade(backend):
    """``kdtree.build`` / ``search`` / ``scan_search`` are the facade's stages
    (as ``test_pipeline_matches_method_wrappers`` holds in the reference)."""
    x = _corpus(n=800, seed=6)
    cfg = KdTreeConfig(dims=6, reduction="ppa-pca-ppa", backend=backend)
    idx = AnnIndex.build(x, cfg, device="cpu")
    index = kdtree.build(torch.from_numpy(x), cfg)
    assert torch.equal(index.reduced, idx.index.reduced)
    assert (index.perm is None) == (backend == "scan")
    q = torch.from_numpy(x[:12] + 0.05)
    for rerank in (False, True):
        got = kdtree.search(index, q, k=10, depth=50, backend=backend, rerank=rerank)
        want = idx.search(q, k=10, depth=50, rerank=rerank)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    qr = kdtree.reduce_queries(index, q)
    assert all(torch.equal(a, b) for a, b in zip(
        kdtree.scan_search(index, qr, 20), idx.pipeline.matcher(idx.index, qr, 20)
        if backend == "scan" else kdtree.scan_search(idx.index, qr, 20)))


def test_build_from_raw_vectors_matches_jax():
    """Built by each package from the same vectors: the same bytes, and the
    scan's neighbours agree (the fits' signs do not matter)."""
    x = _corpus(seed=5)
    for reduction in ("pca", "ppa-pca-ppa"):
        idx = AnnIndex.build(x, KdTreeConfig(dims=8, reduction=reduction), device="cpu")
        jidx = JAnnIndex.build(jnp.asarray(x), JKdTreeConfig(dims=8, reduction=reduction))
        assert idx.nbytes() == jidx.nbytes() and idx.method == jidx.method == "kd-tree"
        _, i = idx.search(x[:16], k=10, depth=10)
        _, ji = jidx.search(jnp.asarray(x[:16]), k=10, depth=10, use_kernel=False)
        assert float(ev.overlap(to_torch(ji), i)) >= 0.99


@pytest.mark.parametrize("bad,match", [({"dims": 9}, "at most 8 dims"),
                                       ({"reduction": "svd"}, "unknown reduction"),
                                       ({"backend": "ball"}, "unknown backend")])
def test_config_checks_as_the_reference(bad, match):
    with pytest.raises(ValueError, match=match):
        KdTreeConfig(**bad)
    with pytest.raises(ValueError, match=match):
        JKdTreeConfig(**bad)


def test_tree_search_needs_the_tree_arrays():
    idx = AnnIndex.build(_corpus(n=100), KdTreeConfig(dims=4), device="cpu")
    with pytest.raises(ValueError, match="no tree arrays"):
        kdtree.tree_search(idx.index, torch.zeros((2, 4)), 5)


def test_kd_refuses_quantized_postings_and_plans_as_the_reference():
    from repro.core import memory_budget as jmb
    from repro_torch.core import memory_budget as mb

    x = _corpus(n=200)
    with pytest.raises(ValueError, match="kd-tree reduced store"):
        AnnIndex.build(x, KdTreeConfig(), primary_postings="int8", device="cpu")
    for dims in (4, 8):
        cfg, jcfg = KdTreeConfig(dims=dims), JKdTreeConfig(dims=dims)
        assert (mb.postings_bytes_per_doc(cfg, 300, "fp32")
                == jmb.postings_bytes_per_doc(jcfg, 300, "fp32") == 8 * dims)
        assert (mb.plan_for_budget(cfg, 10_000, 300, 10**9)
                == jmb.plan_for_budget(jcfg, 10_000, 300, 10**9))
        with pytest.raises(ValueError, match="no quantized primary postings"):
            mb.postings_bytes_per_doc(cfg, 300, "int8")


# -- exact_topk_tiled ----------------------------------------------------------


@pytest.mark.parametrize("n,tile,k", [(1000, 256, 10), (1000, 64, 100), (100, 4096, 10),
                                      (30, 16, 40)])
def test_exact_topk_tiled_matches_jax(n, tile, k):
    rng = np.random.default_rng(n + tile)
    x = rng.normal(size=(n, 48)).astype(np.float32)
    q = rng.normal(size=(7, 48)).astype(np.float32)
    want = jbruteforce.exact_topk_tiled(jnp.asarray(x), jnp.asarray(q), k + 1, tile=tile)
    got = bruteforce.exact_topk_tiled(torch.from_numpy(x), torch.from_numpy(q), k, tile=tile)
    assert got[0].shape == (7, k) and got[1].dtype == torch.int32
    if k > n:  # slots past the corpus: -inf, ids as the reference pads them
        np.testing.assert_array_equal(got[1].numpy()[:, n:], np.asarray(want[1])[:, n:k])
        assert bool(torch.isinf(got[0][:, n:]).all())
        got = (got[0][:, :n], got[1][:, :n])
    assert_topk_match(got, want, exact=False)
    # and the same ids as the kernel route's exact top-k
    s, i = bruteforce.exact_topk(torch.from_numpy(x), torch.from_numpy(q), min(k, n))
    assert_topk_match((s, i), (got[0][:, :min(k, n)], got[1][:, :min(k, n)]), exact=False)
