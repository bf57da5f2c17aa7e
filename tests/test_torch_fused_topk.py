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
import dataclasses
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (
    assert_topk_match,
    lsh_split_topk,
    sorted_topk,
    split_tf32x3_scores,
    to_torch,
)

from repro.core import bruteforce as jbruteforce
from repro.core import fakewords as jfakewords
from repro.core.types import FakeWordsConfig as JFakeWordsConfig
from repro.kernels.fused_topk import ref as jref
from repro.kernels.fused_topk.kernel import fused_topk as jfused_topk
from repro_torch.core import bruteforce, fakewords
from repro_torch.core.index import index_from_numpy
from repro_torch.data.embeddings import WORD2VEC_LIKE, make_corpus, make_queries
from repro_torch.kernels import common
from repro_torch.kernels.fused_topk import ops, ref
from repro_torch.kernels.fused_topk.kernel import fused_topk

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)


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


def _lsh_case(case: str, seed: int):
    """(q (B, S), docs (N, S) uint32 numpy, depth, filt, n_docs) of an lsh
    case: "ties" copies 3 doc rows (sentinels in docs too) and takes the
    queries from the docs, so the depth-th count is held by docs of every
    split (~32 of each row in a split of 96 docs, depth 25); "empty" all-sentinel queries (every count 0); "n_docs",
    "shared-filt", "per-query-filt" random signatures with rows past n_docs
    or a keep bitmap (N,) or (B, N) (some queries keep fewer than depth
    docs); "s37" 37 slots; "depth-n" depth = N."""
    rng = np.random.default_rng(seed)
    b, n, s, depth = 4, 600, 40, 100
    filt, n_docs = None, None
    if case == "s37":
        s, depth = 37, 60
    if case == "depth-n":
        n, s, depth = 160, 24, 160
    d = rng.integers(0, 7, (n, s)).astype(np.uint32)
    if case == "ties":
        base = rng.integers(0, 7, (3, s)).astype(np.uint32)
        base[:, ::5] = 0xFFFFFFFF
        d = base[rng.integers(0, 3, n)]
        depth = 25
    q = d[rng.integers(0, n, b)].copy()
    if case != "ties":
        q[:, ::5] = 0xFFFFFFFF
    if case == "empty":
        q[:] = 0xFFFFFFFF
        d[:, ::3] = 0xFFFFFFFF
    if case == "n_docs":
        n_docs = 530
    if case == "shared-filt":
        filt = rng.random(n) < 0.3
    if case == "per-query-filt":
        filt = rng.random((b, n)) < 0.12
    return q, d, depth, filt, n_docs


_LSH_CASES = ["ties", "empty", "n_docs", "shared-filt", "per-query-filt", "s37", "depth-n"]


@pytest.mark.parametrize("case", _LSH_CASES)
def test_lsh_plain_version_matches_jax(case):
    """K2's plain version (what the card's kernel is held to, bit for bit)
    against JAX's interpret-mode ``fused_topk(mode="lsh")``: ids and scores
    bit-equal at ties, all-zero counts, n_docs, filt, S = 37 and depth = N."""
    q, d, depth, filt, n_docs = _lsh_case(case, seed=43)
    jfilt = None if filt is None else jnp.asarray(filt)
    want = _jax_topk(jnp.asarray(q), jnp.asarray(d), depth, mode="lsh", filt=jfilt,
                     n_docs=n_docs)
    tfilt = None if filt is None else torch.from_numpy(filt)
    got = fused_topk(torch.from_numpy(q), torch.from_numpy(d), depth, mode="lsh", filt=tfilt,
                     n_docs=n_docs)
    assert_topk_match(got, want, exact=True)
    if case == "empty":  # every count 0: the lowest ids, past the masked rows
        assert (got[0] == 0).all() and (got[1] == torch.arange(depth)).all()


@pytest.mark.parametrize("case", _LSH_CASES)
def test_lsh_split_selection_matches_jax(case):
    """K2's selection emulated on the CPU (``torch_parity.lsh_split_topk``:
    16-doc tiles in 7 splits, a count threshold without the id that is
    stale between merges, buffers merged by counting, then pass 2) gives
    JAX's ids and scores bit for bit, ties across splits included."""
    q, d, depth, filt, n_docs = _lsh_case(case, seed=47)
    jfilt = None if filt is None else jnp.asarray(filt)
    want = _jax_topk(jnp.asarray(q), jnp.asarray(d), depth, mode="lsh", filt=jfilt,
                     n_docs=n_docs)
    tfilt = None if filt is None else torch.from_numpy(filt)
    got = lsh_split_topk(torch.from_numpy(q), torch.from_numpy(d), depth, bn=16, splits=7,
                         filt=tfilt, n_docs=n_docs)
    assert_topk_match(got, want, exact=True)


def test_lsh_ties_case_sees_the_tie_rule():
    """The "ties" case holds the depth-th count in docs of every split, so a
    pass 2 that cuts its lists at that count without its id (chip_smoke.py's
    planted K2_STRICT, emulated) loses ranks the reference keeps."""
    q, d, depth, _, _ = _lsh_case("ties", seed=47)
    want = _jax_topk(jnp.asarray(q), jnp.asarray(d), depth, mode="lsh")
    bad = lsh_split_topk(torch.from_numpy(q), torch.from_numpy(d), depth, bn=16, splits=7,
                         tau_id=False)
    with pytest.raises(AssertionError):
        assert_topk_match(bad, want, exact=True)


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


@pytest.mark.parametrize("entry", ["exact_topk", "cosine_topk"])
@pytest.mark.parametrize("b", [1, 8, 65])
def test_exact_cosine_matches_jax_at_the_cells_width(entry, b):
    """K1 f32 as the ground truth calls it, at the ann-word2vec cell's width
    (T = 300, depth 10): WORD2VEC_LIKE vectors and queries drawn from them,
    unit-normalized, against JAX's exact_topk without its kernel."""
    corpus = make_corpus(dataclasses.replace(WORD2VEC_LIKE, n_vectors=3000))
    queries, _ = make_queries(corpus, b, seed=1)
    assert corpus.shape[1] == 300
    want = jbruteforce.exact_topk(jnp.asarray(corpus), jnp.asarray(queries), 11, use_kernel=False)
    if entry == "exact_topk":
        got = bruteforce.exact_topk(torch.from_numpy(corpus), torch.from_numpy(queries), 10)
    else:
        unit = [bruteforce.l2_normalize(torch.from_numpy(a)) for a in (corpus, queries)]
        got = ops.cosine_topk(*unit, 10)
    assert got[1].dtype == torch.int32
    assert_topk_match(got, want, exact=False)


def _unit_rows(rng, n: int, t: int) -> torch.Tensor:
    x = rng.normal(size=(n, t))
    return torch.from_numpy((x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32))


@pytest.mark.parametrize("doc_lo", [True, False])
def test_split_tf32_over_f32_rows_error_budget(doc_lo):
    """The arithmetic K1 f32's tensor-core pass 1 rests on (MmaTf32x3 in
    csrc/mma_topk.cuh): q and doc rows split by bit masks into two tf32
    parts, three products a 32-column chunk, each chunk's sum folded in f32.
    On unit vectors at T = 300 every score is within 3 2^-20 |q| |d| (plus
    the f32 sums' rounding) of the float64 truth, so inside the near-tie
    rule (rtol = atol = 1e-5), and the top 10 keep its ids away from
    near-ties.  Without the doc's low part (doc hi x q lo + doc hi x q hi:
    the doc cut to tf32) the scores leave the rule."""
    rng = np.random.default_rng(29)
    q, d = _unit_rows(rng, 16, 300), _unit_rows(rng, 4000, 300)
    truth = q.double() @ d.double().T
    got = split_tf32x3_scores(q, d, doc_lo=doc_lo)
    err = (got.double() - truth).abs()
    inside = err <= 1e-5 + 1e-5 * truth.abs()
    if doc_lo:
        budget = 3 * 2.0**-20 * (q.double().abs() @ d.double().abs().T) + 1e-6
        assert bool((err <= budget).all()) and bool(inside.all()), float(err.max())
        assert_topk_match(sorted_topk(got, 10), sorted_topk(truth.float(), 11), exact=False)
    else:
        assert float(inside.double().mean()) < 0.5, float(err.max())
        with pytest.raises(AssertionError):
            assert_topk_match(sorted_topk(got, 10), sorted_topk(truth.float(), 11), exact=False)


def test_split_tf32_over_integer_f32_rows_is_exact():
    """Integer f32 values below 2^11 are their own high tf32 part (the low
    part is 0), so K1 f32's split-TF32 sums of them are exact: the integer
    cases of chip_smoke.py's check_kernels hold the kernel bit for bit."""
    rng = np.random.default_rng(31)
    q = torch.from_numpy(rng.integers(-1024, 1025, (5, 300)).astype(np.float32))
    d = torch.from_numpy(rng.integers(-30, 31, (700, 300)).astype(np.float32))
    assert torch.equal(split_tf32x3_scores(q, d), (q.double() @ d.double().T).float())


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


_EDIT_SETS = ("ABLATIONS", "TF32_ABLATIONS", "LOADERS", "PLANTED", "K1_DOC_HI_ONLY", "K3_STRICT",
              "K3_ABLATIONS", "K1F32_ABLATIONS", "K2_ABLATIONS", "K2_COUNT", "K2_STRICT",
              "K2_VARIANTS", "K8_ABLATIONS", "K8_VARIANTS", "K8_NO_SENTINEL")


@pytest.mark.parametrize("name", _EDIT_SETS)
def test_chip_smoke_source_edits_match_the_sources(name):
    """chip_smoke.py builds its planted faults and ablations by editing a
    copy of a kernel's sources and of the shared headers by text
    (``_tree_kernels`` for the fused top-k sources, ``_library_copy`` for
    K8's ``lsh_match.cu``); each edit (a pair of texts, or a tuple of pairs
    of which one must apply) must still find its text in this tree's
    ``csrc`` and ``kernels/csrc``."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    kernels = os.path.join(ROOT, "src", "repro_torch", "kernels")
    source = "lsh_match" if name.startswith("K8") else "fused_topk"
    text = "".join(open(os.path.join(d, f)).read()
                   for d in (os.path.join(kernels, source, "csrc"), os.path.join(kernels, "csrc"))
                   for f in sorted(os.listdir(d)))
    edits = getattr(chip_smoke, name)
    if name == "PLANTED":
        edits = {kind: [edit] for kind, (_, edit) in edits.items()}
    elif not isinstance(edits, dict):
        edits = {name: [edits]}
    for label, group in edits.items():
        for edit in group:
            pairs = edit if isinstance(edit[0], tuple) else (edit,)
            assert any(old in text for old, _ in pairs), (label, [old for old, _ in pairs])


def test_tiling_helpers():
    assert common.round_up(100, 32) == 128 and common.round_up(128, 32) == 128
    assert common.next_pow2(100) == 128 and common.next_pow2(1) == 1

