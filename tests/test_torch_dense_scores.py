"""The port's dense score kernels -- K6 ``cosine_scores``, K7 ``score_matmul``
and K8 ``lsh_match_scores`` -- and their entry points (``cosine_topk``,
``classic_scores`` / ``dot_scores``, ``lsh_topk``) against the JAX package's.

The same numpy inputs go to both packages, at the shapes of
``tests/test_kernels.py`` (unaligned sizes included).  The port runs its CPU
route (the plain versions); the JAX side runs its Pallas kernels with
``interpret=True`` and its ``ref.py``.  Integer modes (K7 int8, K8) must be
bit-equal.  Float modes (K7 bf16, K6) are f32 sums taken in another order:
within rtol = atol = 1e-5 of the score scale (the largest |score| of the
query's row).  Top-k
ids: bit-equal for integer scores, else under the near-tie rule of
``torch_parity.assert_topk_match``; ties go to the lowest id.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_rows_close, assert_topk_match, split_tf32x3_scores, to_torch

from repro.core import fakewords as jfakewords
from repro.core import lexical_lsh as jlsh
from repro.core.types import FakeWordsConfig as JFakeWordsConfig
from repro.core.types import LexicalLshConfig as JLexicalLshConfig
from repro.core.types import LshIndex as JLshIndex
from repro.kernels.cosine_score import ops as jcos_ops
from repro.kernels.cosine_score.kernel import cosine_scores as jcosine_scores
from repro.kernels.cosine_score.ref import cosine_scores_ref as jcosine_ref
from repro.kernels.fakewords_score import ops as jfw_ops
from repro.kernels.fakewords_score.kernel import score_matmul as jscore_matmul
from repro.kernels.fakewords_score.ref import classic_scores_ref as jclassic_ref
from repro.kernels.fakewords_score.ref import score_matmul_ref as jscore_ref
from repro.kernels.lsh_match import ops as jlsh_ops
from repro.kernels.lsh_match.kernel import lsh_match_scores as jlsh_match
from repro.kernels.lsh_match.ref import lsh_match_scores_ref as jlsh_ref
from repro_torch.core import fakewords
from repro_torch.core.types import FakeWordsIndex, LshIndex
from repro_torch.kernels import common
from repro_torch.kernels.cosine_score import cosine_scores, cosine_topk
from repro_torch.kernels.fakewords_score import classic_scores, dot_scores, score_matmul
from repro_torch.kernels.fakewords_score.ref import classic_scores_ref
from repro_torch.kernels.lsh_match import lsh_match_scores, lsh_topk

TOL = 1e-5
SENTINEL = 0xFFFFFFFF


def _close(got: torch.Tensor, want, tol: float = TOL) -> None:
    """Within rtol = tol and atol = tol x the query row's score scale."""
    assert_rows_close(got, want, tol)


@pytest.mark.parametrize("b,n,t", [(4, 64, 32), (8, 300, 100), (3, 513, 257),
                                   # the card's 128 x 256 tile and 32 / 64-column
                                   # chunks one past their edges, and T = 600
                                   (129, 257, 65), (129, 257, 129), (129, 257, 600)])
@pytest.mark.parametrize("dtype", ["int8", "int8/int32", "bf16"])
def test_score_matmul_matches_jax(b, n, t, dtype):
    rng = np.random.default_rng(b * 1000 + t)
    if dtype.startswith("int8"):  # the whole int8 range, extremes included
        q = rng.integers(-128, 128, (b, t)).astype(np.int8)
        d = rng.integers(-128, 128, (n, t)).astype(np.int8)
        q[0, :4], d[0, :4] = [-128, 127, -128, 127], [-128, -128, 127, 127]
        jq, jd = jnp.asarray(q), jnp.asarray(d)
        jout = jnp.int32 if dtype == "int8/int32" else jnp.float32
        tout = torch.int32 if dtype == "int8/int32" else torch.float32
        got = score_matmul(torch.from_numpy(q), torch.from_numpy(d), out_dtype=tout)
        assert got.dtype == tout
        want = jscore_matmul(jq, jd, out_dtype=jout, interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got.numpy(), np.asarray(jscore_ref(jq, jd)).astype(
            np.asarray(want).dtype))
    else:
        jq = jnp.asarray(rng.normal(size=(b, t)), jnp.bfloat16)
        jd = jnp.asarray(rng.normal(size=(n, t)), jnp.bfloat16)
        got = score_matmul(to_torch(jq), to_torch(jd))
        assert got.dtype == torch.float32 and got.shape == (b, n)
        _close(got, jscore_matmul(jq, jd, interpret=True))
        _close(got, jscore_ref(jq, jd))


@pytest.mark.parametrize("b,n,dim", [(4, 128, 64), (2, 300, 33), (5, 1000, 300)])
def test_cosine_scores_matches_jax(b, n, dim):
    rng = np.random.default_rng(dim)
    q = rng.normal(size=(b, dim)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    docs = (rng.normal(size=(n, dim)) * rng.uniform(0.1, 10, (n, 1))).astype(np.float32)
    inv = (1.0 / np.linalg.norm(docs, axis=-1)).astype(np.float32)
    got = cosine_scores(*(torch.from_numpy(a) for a in (q, docs, inv)))
    jargs = [jnp.asarray(a) for a in (q, docs, inv)]
    _close(got, jcosine_scores(*jargs, interpret=True))
    _close(got, jcosine_ref(*jargs))


@pytest.mark.parametrize("b,n,dim", [(4, 128, 64), (3, 513, 257)])
def test_cosine_scores_bf16_cpu_route_matches_jax(b, n, dim):
    """bf16 queries and documents: the kernel takes f32 only, the CPU route
    sums the exact bf16 products in f32, as the reference does."""
    rng = np.random.default_rng(dim + 1)
    q = rng.normal(size=(b, dim))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    docs = rng.normal(size=(n, dim)) * rng.uniform(0.1, 10, (n, 1))
    jq, jd = jnp.asarray(q, jnp.bfloat16), jnp.asarray(docs, jnp.bfloat16)
    inv = (1.0 / np.linalg.norm(np.asarray(jd, np.float32), axis=-1)).astype(np.float32)
    got = cosine_scores(to_torch(jq), to_torch(jd), torch.from_numpy(inv))
    assert got.dtype == torch.float32 and got.shape == (b, n)
    _close(got, jcosine_scores(jq, jd, jnp.asarray(inv), interpret=True))
    _close(got, jcosine_ref(jq, jd, jnp.asarray(inv)))


# f32 columns of a chunk of the card's K6 (cosine_score.cu: 64 bytes), whose
# split-TF32 products are summed from zero and then folded into the row's sum.
K6_CHUNK = 16
K6_EMULATION_T = (300, 257, 16, 17, 321)


def _cosine_operands(b: int, n: int, t: int, seed: int):
    """Unit queries, raw rows of norms spread over 0.01-10 (as
    chip_smoke._dense_inputs makes them) and the rows' inverse norms."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, t)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    docs = (rng.normal(size=(n, t)) * (10 * rng.uniform(size=(n, 1)) + 0.01)).astype(np.float32)
    inv = (1.0 / np.linalg.norm(docs, axis=-1)).astype(np.float32)
    return q, docs, inv


def _cosine_emulation_vs_jax(t: int, doc_lo: bool) -> None:
    """The card's K6 arithmetic, emulated (both sides split by bit masks
    into two tf32 parts, three products a chunk summed from zero and folded
    into the row's f32 sum, times the doc's inverse norm), against JAX's
    ``cosine_scores`` under the 1e-5 row rule."""
    q, docs, inv = _cosine_operands(9, 300, t, t)
    got = split_tf32x3_scores(torch.from_numpy(q), torch.from_numpy(docs), doc_lo=doc_lo,
                              chunk=K6_CHUNK) * torch.from_numpy(inv)
    _close(got, jcosine_scores(*(jnp.asarray(a) for a in (q, docs, inv)), interpret=True))


@pytest.mark.parametrize("t", K6_EMULATION_T)
def test_cosine_split_tf32_emulation_matches_jax(t):
    _cosine_emulation_vs_jax(t, doc_lo=True)


def test_cosine_emulation_without_the_doc_low_part_fails_the_row_rule():
    """Dropping the doc's low tf32 part (the card's planted K6_DOC_HI_ONLY)
    fails the rule on these inputs: the rule can see a doc cut to tf32."""
    failed = []
    for t in K6_EMULATION_T:
        try:
            _cosine_emulation_vs_jax(t, doc_lo=False)
        except AssertionError:
            failed.append(t)
    assert failed, "the emulation without the doc's low part passed every case"


def _signatures(b: int, n: int, s: int, seed: int):
    """uint32 signatures with few distinct values (many collisions), query
    sentinels, doc sentinels (some where the query's are) and doc slots at
    sentinel - 1 (the reference's doc padding)."""
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 6, (n, s)).astype(np.uint32)
    q = d[rng.choice(n, b)].copy()
    q[:, ::7] = SENTINEL
    d[:, ::3] = SENTINEL
    d[:, 1::11] = SENTINEL - 1
    return q, d


def _assert_lsh_matches_jax(q: np.ndarray, d: np.ndarray) -> np.ndarray:
    """The port's counts of q against d, held bit for bit to JAX's
    interpret-mode kernel and to its ``ref``; returns them."""
    got = lsh_match_scores(torch.from_numpy(q), torch.from_numpy(d))
    assert got.dtype == torch.int32
    jq, jd = jnp.asarray(q), jnp.asarray(d)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jlsh_match(jq, jd, interpret=True)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jlsh_ref(jq, jd)))
    return got.numpy()


# S = 1, 37 and 1,500 (the paper's b = 50, h = 30 width), and N = 1
@pytest.mark.parametrize("b,n,s", [(4, 100, 64), (2, 257, 300), (1, 1, 5), (3, 40, 1),
                                   (5, 33, 37), (2, 20, 1500), (6, 1, 300)])
def test_lsh_match_scores_matches_jax(b, n, s):
    _assert_lsh_matches_jax(*_signatures(b, n, s, seed=s))


@pytest.mark.parametrize("kind", ["empty", "pad", "full"])
def test_lsh_match_scores_sentinels_and_padding_match_jax(kind):
    """All-sentinel queries count nothing ("empty"); slots of 0xFFFFFFFE
    (the reference's doc padding) on both sides count, beside sentinels on
    both sides, which do not ("pad"); queries that are doc rows without
    sentinels count every slot ("full")."""
    rng = np.random.default_rng(29)
    b, n, s = 4, 50, 45
    d = rng.integers(0, 3, (n, s)).astype(np.uint32)
    if kind == "pad":
        d[:, ::4] = SENTINEL - 1
        d[:, 1::5] = SENTINEL
    src = rng.choice(n, b)
    q = np.full((b, s), SENTINEL, dtype=np.uint32) if kind == "empty" else d[src].copy()
    got = _assert_lsh_matches_jax(q, d)
    # against its own doc row a query counts every slot but its sentinels
    want_own = 0 if kind == "empty" else s - (q == SENTINEL).sum(1)
    np.testing.assert_array_equal(got[np.arange(b), src], want_own)
    if kind == "empty":
        assert not got.any()


def _fakewords_pair(x: np.ndarray, scoring: str):
    """A JAX-built fake-words index and the port's container of its arrays."""
    jidx = jfakewords.build(jnp.asarray(x), JFakeWordsConfig(quantization=50, scoring=scoring))
    tidx = FakeWordsIndex(
        tf=to_torch(jidx.tf), idf=to_torch(jidx.idf), norm=to_torch(jidx.norm),
        df=to_torch(jidx.df), scored=None if jidx.scored is None else to_torch(jidx.scored))
    return jidx, tidx


@pytest.mark.parametrize("df_max_ratio", [1.0, 0.6])
@pytest.mark.parametrize("scoring", ["classic", "dot"])
def test_fakewords_score_ops_match_jax(small_corpus, scoring, df_max_ratio):
    x = small_corpus[:256]
    jidx, tidx = _fakewords_pair(x, scoring)
    jq_tf = jfakewords.encode_queries(jnp.asarray(x[:5] + 0.05),
                                      JFakeWordsConfig(quantization=50, scoring=scoring))
    q_tf = to_torch(jq_tf)
    if scoring == "classic":
        got = classic_scores(tidx, q_tf, df_max_ratio)
        _close(got, jfw_ops.classic_scores(jidx, jq_tf, df_max_ratio))
        keep = jfakewords.df_prune_mask(jidx.df, jidx.num_docs, df_max_ratio)
        _close(got, jclassic_ref(jq_tf, jidx.scored, keep))
        _close(classic_scores_ref(q_tf, tidx.scored, to_torch(keep)),
               jclassic_ref(jq_tf, jidx.scored, keep))
    else:
        got = dot_scores(tidx, q_tf, df_max_ratio)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jfw_ops.dot_scores(jidx, jq_tf, df_max_ratio)))
        np.testing.assert_array_equal(got.numpy(), fakewords.dot_scores(tidx, q_tf,
                                                                        df_max_ratio).numpy())
    assert got.shape == (5, 256) and got.dtype == torch.float32


def _with_planted_ties(x: np.ndarray) -> np.ndarray:
    """Rows 7, 40, 41 and 90 copies of one row; rows 3 and 60 of another."""
    x = x.copy()
    x[[40, 7, 90, 41]] = x[100]
    x[[60, 3]] = x[101]
    return x


@pytest.mark.parametrize("ties", [False, True])
def test_cosine_topk_matches_jax(small_corpus, ties):
    x = small_corpus[:600] * np.random.default_rng(2).uniform(0.5, 2, (600, 1)).astype(np.float32)
    if ties:
        x = _with_planted_ties(x)
        q = x[[100, 101, 5]] * 3.0  # each tied group is the top of its query
    else:
        q = small_corpus[1000:1009] + 0.1
    k = 8
    s, i = cosine_topk(torch.from_numpy(q), torch.from_numpy(x), k)
    assert s.dtype == torch.float32 and i.dtype == torch.int32 and s.shape == (q.shape[0], k)
    want = jcos_ops.cosine_topk(jnp.asarray(q), jnp.asarray(x), k + 1)
    assert_topk_match((s, i), want, exact=False)
    if ties:  # the planted groups come out whole, lowest id first
        np.testing.assert_array_equal(i[0, :5].numpy(), [7, 40, 41, 90, 100])
        np.testing.assert_array_equal(i[1, :3].numpy(), [3, 60, 101])
        np.testing.assert_array_equal(i.numpy()[:2, :3], np.asarray(want[1])[:2, :3])


@pytest.mark.parametrize("ties", [False, True])
def test_lsh_topk_matches_jax(small_corpus, ties):
    x = small_corpus[:400]
    if ties:
        x = _with_planted_ties(x)
    cfg = JLexicalLshConfig(buckets=64, hashes=2)
    jsig = jlsh.encode(jnp.asarray(x), cfg)
    index = LshIndex(sig=to_torch(jsig))
    jq = jsig[jnp.asarray([100, 101, 5, 17])]
    for k in (1, 10, 400):
        s, i = lsh_topk(index, to_torch(jq), k)
        js, ji = jlsh_ops.lsh_topk(JLshIndex(sig=jsig), jq, k)
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    if ties:  # identical signatures tie at the full count: lowest id first
        s, i = lsh_topk(index, to_torch(jq), 5)
        np.testing.assert_array_equal(i[0].numpy(), [7, 40, 41, 90, 100])
        assert s[0].eq(s[0, 0]).all()


def test_stable_topk_is_lax_top_k_order():
    rng = np.random.default_rng(3)
    scores = rng.integers(0, 4, (5, 200)).astype(np.float32)  # ties everywhere
    for k in (1, 17, 200):
        s, i = common.stable_topk(torch.from_numpy(scores), k)
        js, ji = jax.lax.top_k(jnp.asarray(scores), k)
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


def test_wrappers_refuse_what_the_kernels_do_not_take(monkeypatch):
    i8 = torch.zeros((2, 8), dtype=torch.int8)
    bf = torch.zeros((2, 8), dtype=torch.bfloat16)
    f32 = torch.zeros((2, 8))
    with pytest.raises(TypeError):
        score_matmul(f32, f32)  # K7 takes bf16 or int8
    with pytest.raises(TypeError):
        score_matmul(bf, bf, out_dtype=torch.int32)  # int32 out only for int8
    with pytest.raises(TypeError):
        score_matmul(i8, bf)
    with pytest.raises(ValueError):
        score_matmul(i8, torch.zeros((3, 7), dtype=torch.int8))
    with pytest.raises(ValueError):
        cosine_scores(f32, f32, torch.ones(3))
    with pytest.raises(TypeError):
        lsh_match_scores(f32.int(), f32.int())  # K8 takes uint32
    with pytest.raises(ValueError):  # operands on two devices
        score_matmul(i8, i8.to("meta"))
    with pytest.raises(ValueError):
        lsh_match_scores(*(torch.zeros((2, 4), dtype=torch.uint32, device="meta"),) * 2)
    # K6's kernel route (the operands taken as lying on one card) takes f32
    # only; its CPU route also computes bf16, as the reference does.
    monkeypatch.setattr(common, "on_cpu", lambda *tensors: False)
    with pytest.raises(TypeError):
        cosine_scores(bf, bf, torch.ones(2))
