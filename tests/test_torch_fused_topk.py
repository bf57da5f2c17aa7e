"""The port's fused streaming top-k (``repro_torch.kernels.fused_topk``)
against the JAX package's.

On the CPU the port's wrapper runs its plain version; the JAX kernel runs in
Pallas interpret mode with small tiles (bn = bk = 128), so several doc and
reduce tiles stream through its running merge.  Integer modes (int8, lsh,
0/1 ties) must agree bit for bit, ids and scores; float modes to
rtol = atol = 1e-5 with ids equal away from near-ties (summation order
differs).  ``test_torch_gpu.py`` holds the CUDA kernel against the plain
version on a card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_topk_match, to_torch

from repro.core import fakewords as jfakewords
from repro.core.types import FakeWordsConfig as JFakeWordsConfig
from repro.kernels.fused_topk import ref as jref
from repro.kernels.fused_topk.kernel import fused_topk as jfused_topk
from repro_torch.core import fakewords
from repro_torch.core.index import index_from_numpy
from repro_torch.kernels import common
from repro_torch.kernels.fused_topk import ops, ref
from repro_torch.kernels.fused_topk.kernel import fused_topk


def _operands(dtype: str, b: int, n: int, t: int, seed: int):
    rng = np.random.default_rng(seed)
    if dtype == "int8":
        q = jnp.asarray(rng.integers(-50, 50, (b, t)), jnp.int8)
        d = jnp.asarray(rng.integers(-50, 50, (n, t)), jnp.int8)
    elif dtype == "int8-full":  # every int8 value, -128 and 127 included
        q = jnp.asarray(rng.integers(-128, 128, (b, t)), jnp.int8)
        d = jnp.asarray(rng.integers(-128, 128, (n, t)), jnp.int8)
    elif dtype == "int8-dot":  # the dot path's [u; -u] query over term counts 0..127
        u = rng.integers(0, 128, (b, t // 2))
        q = jnp.asarray(np.concatenate([u, -u], 1), jnp.int8)
        d = jnp.asarray(rng.integers(0, 128, (n, t)), jnp.int8)
    elif dtype == "ties":
        q = jnp.asarray(rng.integers(0, 2, (b, t)), jnp.int8)
        d = jnp.asarray(rng.integers(0, 2, (n, t)), jnp.int8)
    elif dtype == "lsh":
        d = jnp.asarray(rng.integers(0, 7, (n, t)), jnp.uint32)
        q = d[:b].at[:, ::5].set(jnp.uint32(0xFFFFFFFF))
    else:
        jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
        q = jnp.asarray(rng.normal(size=(b, t)), jdt)
        d = jnp.asarray(rng.normal(size=(n, t)), jdt)
    return (q, d), (to_torch(q), to_torch(d))


def _jax_topk(q, d, depth, mode="gemm", filt=None, n_docs=None):
    s, i = jfused_topk(q, d, depth, mode=mode, bn=128, bk=128, interpret=True,
                       filt=filt, n_docs=n_docs)
    return np.asarray(s), np.asarray(i)


@pytest.mark.parametrize(
    "dtype,b,n,t,depth",
    [
        ("bf16", 3, 513, 257, 37),   # everything unaligned, ragged last tile
        ("int8", 3, 513, 257, 37),
        ("f32", 8, 300, 100, 100),   # depth == paper default
        # The int8 (dot) operands of the tensor-core pass 1: the full range at
        # 600-byte rows (8-byte copies) and 256-byte rows (16-byte copies),
        # and the [u; -u] sign pattern at the cell's T.
        ("int8-full", 3, 300, 600, 100),
        ("int8-full", 5, 400, 256, 60),
        ("int8-dot", 4, 300, 600, 100),
    ],
)
def test_fused_topk_matches_jax(dtype, b, n, t, depth):
    (jq, jd), (tq, td) = _operands(dtype, b, n, t, seed=13)
    want = _jax_topk(jq, jd, depth + 1)
    got = fused_topk(tq, td, depth)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    assert_topk_match(got, want, exact=dtype.startswith("int8"))


def test_lsh_topk_matches_jax():
    (jq, jd), (tq, td) = _operands("lsh", 5, 357, 96, seed=3)
    assert tq.dtype == torch.uint32
    got = ops.lsh_topk(tq, td, 40)
    assert_topk_match(got, _jax_topk(jq, jd, 40, mode="lsh"), exact=True)


def test_fused_topk_ties_at_depth_n_and_ragged_n_docs():
    """Massive 0/1 ties at depth = n_docs: ids follow the lowest-id order,
    and rows >= n_docs never surface."""
    (jq, jd), (tq, td) = _operands("ties", 3, 130, 16, seed=5)
    got = fused_topk(tq, td, 101, n_docs=101)
    assert_topk_match(got, _jax_topk(jq, jd, 101, n_docs=101), exact=True)
    assert int(got[1].max()) < 101


@pytest.mark.parametrize("dtype,shared", [("int8", True), ("bf16", False)])
def test_fused_topk_filt_matches_jax(dtype, shared):
    b, n, t, depth = 4, 300, 64, 60
    (jq, jd), (tq, td) = _operands(dtype, b, n, t, seed=7)
    rng = np.random.default_rng(11)
    filt = rng.random(n if shared else (b, n)) < (0.3 if shared else 0.1)
    got = fused_topk(tq, td, depth, filt=torch.from_numpy(filt))
    want = _jax_topk(jq, jd, depth + 1, filt=jnp.asarray(filt))
    assert_topk_match(got, want, exact=dtype == "int8")
    if not shared:  # fewer than depth docs survive in some rows
        assert (got[1] == -1).any()
        assert (got[0][got[1] == -1] == -torch.inf).all()


def test_scores_ref_and_apply_filt_match_jax():
    for dtype, mode in (("int8", "gemm"), ("bf16", "gemm"), ("f32", "gemm"), ("lsh", "lsh")):
        (jq, jd), (tq, td) = _operands(dtype, 3, 70, 33, seed=17)
        want = np.array(jref.scores_ref(jq, jd, mode))
        got = ref.scores_ref(tq, td, mode).numpy()
        if dtype in ("int8", "lsh"):
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    filt = np.random.default_rng(1).random((3, 70)) < 0.5
    np.testing.assert_array_equal(
        ref.apply_filt(torch.from_numpy(want), torch.from_numpy(filt)).numpy(),
        np.asarray(jref.apply_filt(jnp.asarray(want), jnp.asarray(filt))))
    assert ref.apply_filt(torch.from_numpy(want), None) is not None


def _jax_and_port_index(scoring: str):
    rng = np.random.default_rng(21)
    x = rng.normal(size=(600, 48)).astype(np.float32)
    cfg = JFakeWordsConfig(quantization=50, scoring=scoring)
    jidx = jfakewords.build(jnp.asarray(x), cfg, keep_vectors=True)
    names = ("tf", "idf", "norm", "df", "scored", "vectors")
    arrays = {k: np.asarray(getattr(jidx, k)) for k in names if getattr(jidx, k) is not None}
    dtypes = {k: a.dtype.name for k, a in arrays.items()}
    arrays = {k: (a.view(np.uint16) if dtypes[k] == "bfloat16" else a) for k, a in arrays.items()}
    config = {"quantization": 50, "df_max_ratio": 1.0, "scoring": scoring,
              "store_dtype": "int8", "signed_store": False}
    tidx = index_from_numpy("fake-words", config, arrays, dtypes, device="cpu")
    q_tf = jfakewords.encode_queries(jnp.asarray(x[:6] + 0.05), cfg)
    return jidx, tidx.index, q_tf, to_torch(q_tf)


@pytest.mark.parametrize("scoring", ["classic", "dot"])
def test_ops_match_jax(scoring):
    """classic_topk / dot_topk stream the same operand as the JAX wrappers
    (bf16 classic query, int8 [u; -u] dot query) and return what the JAX
    kernel's plain reference returns for it."""
    jidx, tidx, jq_tf, tq_tf = _jax_and_port_index(scoring)
    if scoring == "classic":
        jqv, jdocs = jfakewords.classic_query(jidx, jq_tf), jidx.scored
        qv = fakewords.classic_query(tidx, tq_tf)
        got = ops.classic_topk(tidx, tq_tf, 50)
    else:
        jqv, jdocs = jfakewords.dot_query(jidx, jq_tf, dtype=jnp.int8), jidx.tf
        qv = fakewords.dot_query(tidx, tq_tf, dtype=torch.int8)
        got = ops.dot_topk(tidx, tq_tf, 50)
    assert qv.dtype == to_torch(jqv).dtype
    assert torch.equal(qv.view(torch.int16) if scoring == "classic" else qv,
                       to_torch(jqv).view(torch.int16) if scoring == "classic" else to_torch(jqv))
    assert_topk_match(got, jref.fused_topk_ref(jqv, jdocs, 51), exact=scoring == "dot")


def test_cosine_topk_matches_jax_with_ragged_n_docs():
    (jq, jd), _ = _operands("f32", 4, 400, 32, seed=23)
    jd = jd / jnp.linalg.norm(jd, axis=1, keepdims=True)
    jq = jq / jnp.linalg.norm(jq, axis=1, keepdims=True)
    want = jref.fused_topk_ref(jq, jd, 21, n_docs=390)
    got = ops.cosine_topk(to_torch(jd), to_torch(jq), 20, n_docs=390)
    assert_topk_match(got, want, exact=False)
    assert int(got[1].max()) < 390


def test_cpu_tensors_take_the_plain_version():
    (_, _), (tq, td) = _operands("f32", 2, 64, 8, seed=31)
    before = fused_topk.launches
    got = fused_topk(tq, td, 5)
    assert fused_topk.launches == before
    want = ref.fused_topk_ref(tq, td, 5)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize(
    "kwargs,err",
    [
        (dict(depth=0), ValueError),
        (dict(depth=65), ValueError),             # > N
        (dict(depth=5, n_docs=0), ValueError),
        (dict(depth=5, n_docs=65), ValueError),
        (dict(depth=5, mode="dense"), ValueError),
        (dict(depth=5, filt=torch.ones(3, dtype=torch.bool)), ValueError),
    ],
)
def test_fused_topk_rejects_bad_arguments(kwargs, err):
    (_, _), (tq, td) = _operands("f32", 2, 64, 8, seed=37)
    depth = kwargs.pop("depth")
    with pytest.raises(err):
        fused_topk(tq, td, depth, **kwargs)
    with pytest.raises(ValueError):
        fused_topk(tq, td[:, :7], 5)


def test_tiling_helpers():
    assert common.round_up(100, 32) == 128 and common.round_up(128, 32) == 128
    assert common.next_pow2(100) == 128 and common.next_pow2(1) == 1

