"""The port's quantized read path against the JAX package's, on the same
numpy inputs: int8 / int4 packed postings, the int8 rerank store, K4 / K5
(``fused_topk_quantized`` / ``fused_topk_gathered_quantized``), quantized
blockmax and the memory-budget planner.

Tolerances.  The quantized arrays (``quantize_postings``,
``dequantize_postings``, ``quantize_store``, ``unpack_int4``,
``dequant_int4``) and the blockmax bounds ``ub`` must be bit-equal.  K4 and
K5 on the CPU run their plain versions; the JAX side runs its Pallas kernels
in interpret mode (``bn = bk = 128``, a multiple of every int4 group).
Integer-valued cases (unit scales, integer queries, 0/1 ties) must be
bit-exact; float cases are f32 sums taken in another order: scores to
rtol = atol = 1e-5 and ids equal away from near-ties (``torch_parity``).
The searches run the port on the JAX index's own arrays
(``index_from_numpy``), so both prune and score the same data.

K4 with an f32 query runs on the card as a split-TF32 product (q = hi +
lo, two tf32 parts), over int4 rows with each 32-column chunk's sum times
its group's scale; here its arithmetic is emulated in torch
(``torch_parity.split_tf32_topk``) and held to JAX's kernel under the same
near-tie rule (integer-valued cases bit-exact, over int4 also with distinct
power-of-two group scales), and the emulation without the low part (one
tf32 pass) on a query of wide dynamic range, or with every int4 chunk
times its row's first group scale, is shown to break that rule.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_topk_match, split_tf32_topk, to_torch

from repro.core import blockmax as jblockmax
from repro.core import bruteforce as jbruteforce
from repro.core import builder as jbuilder
from repro.core import memory_budget as jmb
from repro.core import pipeline as jpl
from repro.core.index import AnnIndex as JAnnIndex
from repro.core.types import BruteForceConfig as JBruteForceConfig
from repro.core.types import FakeWordsConfig as JFakeWordsConfig
from repro.core.types import LexicalLshConfig as JLexicalLshConfig
from repro.kernels import common as jcommon
from repro.kernels.fused_topk import kernel as jkernel
from repro_torch.core import blockmax, builder
from repro_torch.core import eval as ev
from repro_torch.core import memory_budget as mb
from repro_torch.core import pipeline as pl
from repro_torch.core.index import AnnIndex, index_from_numpy
from repro_torch.core.types import BruteForceConfig, FakeWordsConfig, LexicalLshConfig
from repro_torch.kernels import common
from repro_torch.kernels.fused_topk import kernel, ref

METHODS = ["classic", "dot", "bruteforce"]
POSTINGS = ["int8", "int4"]


def _configs(method):
    if method == "bruteforce":
        return BruteForceConfig(), JBruteForceConfig()
    return (FakeWordsConfig(quantization=50, scoring=method),
            JFakeWordsConfig(quantization=50, scoring=method))


def _corpus(n=512, m=64, b=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, m)).astype(np.float32)
    x += 0.5 * rng.normal(size=(1, m)).astype(np.float32)
    q = x[rng.choice(n, b, replace=False)] + 0.05 * rng.normal(size=(b, m)).astype(np.float32)
    return x, q


def _bits(a) -> np.ndarray:
    """A torch or JAX array as integers of the same bits."""
    t = a if isinstance(a, torch.Tensor) else to_torch(a)
    same = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return t.view(same.get(t.dtype, t.dtype)).numpy()


def _equal_bits(got, want):
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _matrix(n, t, seed):
    """Rows of mixed magnitude, a zero row, and rows whose quantized values
    fall exactly on .5 (round half to even must agree)."""
    rng = np.random.default_rng(seed)
    m = rng.normal(size=(n, t)).astype(np.float32) * rng.uniform(0.01, 10, (n, 1)).astype(
        np.float32)
    m[0] = 0.0
    m[1, :6] = [127.0, 0.5, 1.5, 2.5, -2.5, -0.5]  # int8: scale 1, ties
    m[1, 6:] = 0.0
    m[2, :6] = [7.0, 0.5, 1.5, 2.5, -2.5, -3.5]    # int4: group scale 1, ties
    m[2, 6:] = 0.0
    return m


# ---------------------------------------------------------------------------
# Quantized arrays: bit-equal
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits,group,t", [(8, 32, 600), (8, 32, 100), (4, 32, 600),
                                          (4, 64, 600), (4, 32, 100), (4, 64, 100)])
def test_int4_helpers_and_quantize_postings_bit_equal(bits, group, t):
    m = _matrix(40, t, seed=t + group + bits)
    jpq = jbuilder.quantize_postings(jnp.asarray(m), bits=bits, group=group)
    pq = builder.quantize_postings(torch.from_numpy(m), bits=bits, group=group)
    assert (pq.bits, pq.group, pq.cols) == (jpq.bits, jpq.group, jpq.cols)
    assert pq.q.dtype == to_torch(jpq.q).dtype and pq.scale.dtype == torch.float32
    _equal_bits(pq.q, jpq.q)
    _equal_bits(pq.scale, jpq.scale)
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        _equal_bits(builder.dequantize_postings(pq, dtype),
                    jbuilder.dequantize_postings(jpq, jdtype))
    if bits == 4:
        _equal_bits(common.unpack_int4(pq.q), jcommon.unpack_int4(jpq.q))
        for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
            _equal_bits(common.dequant_int4(pq.q, pq.scale, group, dtype),
                        jcommon.dequant_int4(jpq.q, jpq.scale, group, jdtype))
        tg = common.round_up(t, group)
        if t % 2 == 0 and tg > t:  # whole pad-column pairs are the int4 pad byte
            assert (pq.q[:, t // 2:] == common.INT4_PAD_BYTE).all()
        assert pq.q.shape == (40, tg // 2) and pq.scale.shape == (40, tg // group)
    else:
        assert pq.q.shape == (40, t) and pq.scale.shape == (40, 1)


def test_quantize_store_bit_equal():
    m = _matrix(64, 300, seed=3)
    m /= np.maximum(np.linalg.norm(m, axis=1, keepdims=True), 1e-12)
    jvq = jbuilder.quantize_store(jnp.asarray(m))
    vq = builder.quantize_store(torch.from_numpy(m))
    _equal_bits(vq.q, jvq.q)
    _equal_bits(vq.scale, jvq.scale)


@pytest.mark.parametrize("pp", POSTINGS)
@pytest.mark.parametrize("method", METHODS)
def test_build_quantized_arrays_bit_equal(method, pp):
    """Both builders on the same unit vectors (the reference's normalization,
    so a last-ulp difference cannot flip a tf rounding)."""
    x, _ = _corpus(n=300, seed=1)
    v = np.array(jbruteforce.l2_normalize(jnp.asarray(x)))
    cfg, jcfg = _configs(method)
    jidx = jbuilder.make_build_pipeline(jcfg, "int8", pp, 32).build_local(
        jnp.asarray(v), normalized=True)
    idx = builder.make_build_pipeline(cfg, "int8", pp, 32).build_local(
        torch.from_numpy(v), normalized=True)
    assert (idx.pq is None) == (jidx.pq is None)
    assert idx.pq is not None or (method == "dot" and pp == "int8")  # dot int8: the tf itself
    if idx.pq is not None:
        assert (idx.pq.bits, idx.pq.group, idx.pq.cols) == (
            jidx.pq.bits, jidx.pq.group, jidx.pq.cols)
        _equal_bits(idx.pq.q, jidx.pq.q)
        _equal_bits(idx.pq.scale, jidx.pq.scale)
    _equal_bits(idx.vq.q, jidx.vq.q)
    _equal_bits(idx.vq.scale, jidx.vq.scale)
    assert idx.vectors is None and jidx.vectors is None
    if method != "bruteforce":
        assert (idx.tf is None) == (jidx.tf is None) and idx.scored is None
    assert idx.nbytes() == jidx.nbytes()


# ---------------------------------------------------------------------------
# K4 and K5: the port's CPU route against the JAX kernels (interpret mode)
# ---------------------------------------------------------------------------


def _packed_operands(kind, bits, group, n, t, seed):
    """(packed store, scales) as numpy: "float" quantizes a random matrix;
    "int" and "ties" build integer-valued stores with unit scales (values
    in [-50, 50] / [-8, 7], or 0 / 1); "pow2" (int4) the nibbles of "int"
    with group scales 2^((g + row) % 7 - 3), so that neighbouring groups
    differ and sums with an integer query stay exact in f32."""
    rng = np.random.default_rng(seed)
    if kind == "float":
        pq = jbuilder.quantize_postings(jnp.asarray(_matrix(n, t, seed)), bits=bits,
                                        group=group or 32)
        return np.array(pq.q), np.array(pq.scale)
    if bits == 8:
        lo, hi = (-50, 51) if kind == "int" else (0, 2)
        return rng.integers(lo, hi, (n, t)).astype(np.int8), np.ones((n, 1), np.float32)
    tg = common.round_up(t, group)
    nib = rng.integers(0, 16, (n, tg)) if kind in ("int", "pow2") else rng.integers(8, 10, (n, tg))
    nib[:, t:] = 8
    packed = (nib[:, 0::2] | (nib[:, 1::2] << 4)).astype(np.uint8)
    if kind == "pow2":
        g = np.arange(tg // group)[None, :] + np.arange(n)[:, None]
        return packed, np.exp2(g % 7 - 3).astype(np.float32)
    return packed, np.ones((n, tg // group), np.float32)


def _query(kind, dtype, b, t, seed):
    """"float": normal / sqrt(T); "wide": |q| from 1e-3 to 1e3 with random
    signs and mantissas; else integers (in [-20, 20], or 0 / 1 for ties)."""
    rng = np.random.default_rng(seed + 1)
    if kind == "float":
        q = rng.normal(size=(b, t)).astype(np.float32) / np.sqrt(t)
    elif kind == "wide":
        q = (rng.choice([-1.0, 1.0], (b, t)) * 10.0 ** rng.uniform(-3, 3, (b, t))).astype(
            np.float32)
    else:
        lo, hi = (-20, 21) if kind == "int" else (0, 2)
        q = rng.integers(lo, hi, (b, t)).astype(np.float32)
    jq = jnp.asarray(q, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    return jq, to_torch(jq)


def _filt(how, b, n, seed):
    rng = np.random.default_rng(seed + 2)
    if how == "shared":
        return rng.random(n) < 0.5
    if how == "per-query":
        return rng.random((b, n)) < 0.5
    return None


K4_CASES = [
    # kind, bits, group, query dtype, T, filt, n_docs, depth
    ("float", 8, 0, "bf16", 600, None, None, 40),
    ("float", 4, 32, "bf16", 600, None, None, 40),
    ("float", 4, 64, "bf16", 100, "shared", None, 40),
    ("float", 8, 0, "f32", 100, "per-query", 250, 40),
    ("float", 4, 32, "f32", 100, None, 250, 40),
    ("float", 4, 64, "f32", 600, None, None, 40),
    ("int", 8, 0, "bf16", 600, None, None, 40),
    ("int", 4, 32, "bf16", 100, "per-query", 270, 40),
    ("ties", 8, 0, "bf16", 100, None, None, 64),
    ("ties", 4, 64, "bf16", 100, "shared", None, 64),
    # shapes the tensor-core K4's packed staging treats specially: int8 rows
    # of 37 bytes (not 8-byte aligned), int4 g32 at T = 600 (the last 64-column
    # chunk reaches past the 19th, last group) with ragged n_docs, and a
    # per-query filt with a bf16 query
    ("int", 8, 0, "bf16", 37, None, None, 40),
    ("int", 4, 32, "bf16", 600, None, 270, 40),
    ("float", 8, 0, "bf16", 100, "per-query", None, 40),
]


@pytest.mark.parametrize("kind,bits,group,dtype,t,filt_kind,n_docs,depth", K4_CASES)
def test_fused_topk_quantized_matches_jax(kind, bits, group, dtype, t, filt_kind, n_docs, depth):
    n, b = 300, 5
    seed = t + bits + group + len(kind)
    docs, scale = _packed_operands(kind, bits, group, n, t, seed)
    jq, q = _query(kind, dtype, b, t, seed)
    filt = _filt(filt_kind, b, n, seed)
    exact = kind != "float"
    got = kernel.fused_topk_quantized(
        q, torch.from_numpy(docs), torch.from_numpy(scale), depth, bits, group,
        filt=None if filt is None else torch.from_numpy(filt), n_docs=n_docs)
    want = jkernel.fused_topk_quantized(
        jq, jnp.asarray(docs), jnp.asarray(scale), depth if exact else depth + 1, bits=bits,
        group=group, interpret=True, bn=128, bk=128,
        filt=None if filt is None else jnp.asarray(filt), n_docs=n_docs)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    assert_topk_match(got, [np.asarray(a) for a in want], exact=exact)


SPLIT_TF32_CASES = [
    # query kind, store kind (int8; int4 as "<kind>-int4-g<group>"), T, filt, n_docs
    ("float", "float", 300, None, None),      # the brute-force rows: 300 bytes
    ("float", "float", 37, "per-query", 250),
    ("wide", "float", 600, "shared", None),
    ("int", "int", 300, "per-query", 270),    # integer scores: bit-exact
    ("float", "float-int4-g32", 300, None, None),    # the brute-force int4 rows: 160 bytes
    ("float", "float-int4-g64", 37, "per-query", 250),
    ("wide", "float-int4-g32", 600, "shared", None),
    ("int", "int-int4-g64", 300, "per-query", 270),  # integer scores, unit scales: bit-exact
    ("int", "pow2-int4-g32", 600, None, None),       # over power-of-two group scales too
    ("int", "pow2-int4-g64", 300, "shared", 250),
]


def _split_tf32_case(qkind, dkind, t, filt_kind, n_docs, depth=40):
    """(split-TF32 emulation's arguments, JAX's fused_topk_quantized one rank
    deeper, exact) for an f32 query over an int8 store, or over an int4 one
    where ``dkind`` is "<kind>-int4-g<group>"."""
    n, b = 300, 5
    seed = 3 * t + len(qkind) + len(dkind)
    kind, _, g = dkind.partition("-int4-g")
    bits, group = (4, int(g)) if g else (8, 0)
    docs, scale = _packed_operands(kind, bits, group, n, t, seed)
    jq, q = _query(qkind, "f32", b, t, seed)
    filt = _filt(filt_kind, b, n, seed)
    exact = kind in ("int", "pow2") and qkind == "int"
    want = jkernel.fused_topk_quantized(
        jq, jnp.asarray(docs), jnp.asarray(scale), depth if exact else depth + 1, bits=bits,
        group=group, interpret=True, bn=128, bk=128,
        filt=None if filt is None else jnp.asarray(filt), n_docs=n_docs)
    args = (q, torch.from_numpy(docs), torch.from_numpy(scale), depth,
            None if filt is None else torch.from_numpy(filt), n_docs)
    return args, [np.asarray(a) for a in want], exact, group


@pytest.mark.parametrize("qkind,dkind,t,filt_kind,n_docs", SPLIT_TF32_CASES)
def test_split_tf32_emulation_matches_jax(qkind, dkind, t, filt_kind, n_docs):
    """K4's split-TF32 arithmetic (q split into hi and lo cut to tf32, int8
    or int4 widened exactly, f32 sums; the int8 scale once, an int4 group's
    scale on each 32-column chunk's sum) against JAX's K4 with an f32 query
    over int8 or int4 postings."""
    args, want, exact, group = _split_tf32_case(qkind, dkind, t, filt_kind, n_docs)
    assert_topk_match(split_tf32_topk(*args, group=group), want, exact=exact)


def test_hi_only_emulation_breaks_the_near_tie_rule():
    """One tf32 pass of a query of wide dynamic range (the hi part alone)
    is far outside the near-tie rule that the split passes."""
    args, want, _, _ = _split_tf32_case("wide", "float", 300, None, None)
    assert_topk_match(split_tf32_topk(*args), want, exact=False)
    with pytest.raises(AssertionError):
        assert_topk_match(split_tf32_topk(*args, lo=False), want, exact=False)


@pytest.mark.parametrize("qkind,dkind,t", [("int", "pow2-int4-g32", 300),
                                            ("float", "float-int4-g64", 600)])
def test_first_group_scale_emulation_breaks_the_near_tie_rule(qkind, dkind, t):
    """Every int4 chunk's sum times its row's first group scale (the planted
    fault of chip_smoke.py's check_quantized) is far outside the near-tie
    rule that the emulation with each chunk's own group scale passes."""
    args, want, exact, group = _split_tf32_case(qkind, dkind, t, None, None)
    assert_topk_match(split_tf32_topk(*args, group=group), want, exact=exact)
    with pytest.raises(AssertionError):
        assert_topk_match(split_tf32_topk(*args, group=group, first_group=True), want,
                          exact=False)


@pytest.mark.parametrize("t,offset,want", [
    (64, 0, 16), (600, 0, 8), (300, 0, 4), (37, 0, 1), (300, 1, 1), (64, 8, 8), (64, 4, 4),
])
def test_row_alignment(t, offset, want):
    """The byte alignment every row starts at: the row length and the base
    address both count (300-byte int8 rows take K4's 4-byte loader)."""
    base = torch.zeros(4096, dtype=torch.int8)
    assert base.data_ptr() % 16 == 0
    rows = base[offset: offset + 4 * t].view(4, t)
    assert common.row_alignment(rows) == want


K5_CASES = [
    # kind, bits, group, query dtype, T, ids, filt, n_docs, depth
    ("float", 8, 0, "bf16", 600, "random", False, 280, 40),
    ("float", 4, 32, "bf16", 600, "random", True, 300, 40),
    ("float", 4, 64, "bf16", 100, "blocks", False, 300, 40),
    ("float", 4, 32, "f32", 100, "random", False, 260, 40),
    ("int", 8, 0, "bf16", 100, "random", True, 290, 40),
    ("int", 4, 64, "bf16", 600, "blocks", False, 300, 40),
    ("ties", 4, 32, "bf16", 100, "random", False, 300, 64),
    ("ties", 8, 0, "bf16", 100, "blocks", True, 300, 64),
]


def _row_ids(how, b, n, r, seed):
    """(B, R) int32: ids in random order over [0, N + 20) ("random"), or
    whole 32-row blocks in random order ("blocks")."""
    rng = np.random.default_rng(seed + 3)
    if how == "random":
        return np.stack([rng.permutation(n + 20)[:r] for _ in range(b)]).astype(np.int32)
    blocks = np.stack([rng.permutation(-(-n // 32))[: r // 32] for _ in range(b)])
    return (blocks[:, :, None] * 32 + np.arange(32)).reshape(b, -1).astype(np.int32)


@pytest.mark.parametrize("kind,bits,group,dtype,t,how,with_filt,n_docs,depth", K5_CASES)
def test_fused_topk_gathered_quantized_matches_jax(kind, bits, group, dtype, t, how, with_filt,
                                                   n_docs, depth):
    n, b, r = 300, 4, 192
    seed = 2 * t + bits + group + len(kind)
    docs, scale = _packed_operands(kind, bits, group, n, t, seed)
    jq, q = _query(kind, dtype, b, t, seed)
    ids = _row_ids(how, b, n, r, seed)
    filt = (np.random.default_rng(seed).random((b, r)) < 0.5) if with_filt else None
    exact = kind != "float"
    got = kernel.fused_topk_gathered_quantized(
        q, torch.from_numpy(docs), torch.from_numpy(scale), torch.from_numpy(ids), depth,
        n_docs, bits, group, filt=None if filt is None else torch.from_numpy(filt))
    safe = np.minimum(ids, n_docs - 1)  # the reference takes the rows already gathered
    want = jkernel.fused_topk_gathered_quantized(
        jq, jnp.asarray(docs[safe]), jnp.asarray(scale[safe]), jnp.asarray(ids),
        depth if exact else depth + 1, n_docs, bits=bits, group=group, bn=128, bk=128,
        interpret=True, filt=None if filt is None else jnp.asarray(filt))
    assert_topk_match(got, [np.asarray(a) for a in want], exact=exact)


def _kept_blocks(rng, b, n_docs, n_keep, scores=None):
    """(B, n_keep * 256) row ids: whole 256-row blocks of [0, n_docs) in
    random order, or (``scores`` (B, n_docs)) best block first, as blockmax
    stage 1 orders them."""
    out = []
    for qi in range(b):
        if scores is None:
            blocks = rng.permutation(n_docs // 256)[:n_keep]
        else:
            blocks = np.argsort(-scores[qi].reshape(-1, 256).max(1), kind="stable")[:n_keep]
        out.append((blocks[:, None] * 256 + np.arange(256)).reshape(-1))
    return np.stack(out).astype(np.int32)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("case", ["bound-order", "depth-r", "padding-splits", "tied-depth",
                                  "repeated-ids"])
def test_fused_topk_gathered_quantized_matches_jax_across_many_splits(case, bits):
    """K5's yardstick on the card (the plain version) against JAX's kernel
    at sizes where the card's plan cuts each query's rows into many splits
    (12 blocks of 256 rows at B = 1 and 2 on 132 SMs), so pass 2 merges many
    lists: rows in block-bound order (the best block first), depth = R,
    whole 256-row splits of padding ids, 0/1 rows whose scores tie at the
    depth-th rank across splits, and ids that come twice (each copy scored
    and ranked).  Integer-valued stores with unit scales: bit for bit."""
    seed = {"bound-order": 31, "depth-r": 32, "padding-splits": 33, "tied-depth": 34,
            "repeated-ids": 35}[case] + bits
    rng = np.random.default_rng(seed)
    b, n_docs = 2, 16 * 256
    t, group, dtype = (37, 0, "f32") if bits == 8 else (64, 32, "bf16")
    kind = "int" if case == "bound-order" else "ties"
    docs, scale = _packed_operands(kind, bits, group, n_docs, t, seed)
    jq, q = _query(kind, dtype, b, t, seed)
    depth = 100
    if case == "bound-order":
        scores = ref.quantized_scores_ref(q, torch.from_numpy(docs), torch.from_numpy(scale),
                                          bits, group).numpy()
        ids = _kept_blocks(rng, b, n_docs, 12, scores)
    elif case == "depth-r":
        ids = _kept_blocks(rng, b, n_docs, 3)
        depth = ids.shape[1]
    elif case == "padding-splits":
        ids = _kept_blocks(rng, b, n_docs, 12)
        ids[:, 3 * 256:6 * 256] = common.BIG_ID  # three whole splits of padding
        ids[1, 8 * 256:9 * 256] += 2 * n_docs   # and one of ids >= n_docs
    elif case == "tied-depth":
        jq, q, ids = jq[:1], q[:1], _kept_blocks(rng, 1, n_docs, 12)
    else:  # two blocks kept twice, the copies in another split
        ids = _kept_blocks(rng, b, n_docs, 10)
        ids = np.concatenate([ids, ids[:, 256:768]], 1)
    got = kernel.fused_topk_gathered_quantized(
        q, torch.from_numpy(docs), torch.from_numpy(scale), torch.from_numpy(ids), depth, n_docs,
        bits, group)
    safe = np.minimum(ids, n_docs - 1)  # the reference takes the rows already gathered
    want = jkernel.fused_topk_gathered_quantized(
        jq, jnp.asarray(docs[safe]), jnp.asarray(scale[safe]), jnp.asarray(ids), depth, n_docs,
        bits=bits, group=group, bn=128, bk=128, interpret=True)
    assert_topk_match(got, [np.asarray(a) for a in want], exact=True)
    if case == "tied-depth":  # rows of several blocks tie the depth-th score, past the cut too
        last = float(got[0][0, -1])
        kept = np.isin(ids[0], got[1][0][got[0][0] == last].numpy())
        assert len({p // 256 for p in np.flatnonzero(kept)}) > 1
        every = ref.quantized_gathered_topk_ref(q, torch.from_numpy(docs),
                                                torch.from_numpy(scale), torch.from_numpy(ids),
                                                ids.shape[1], n_docs, bits, group)[0]
        assert int((every == last).sum()) > int(kept.sum())
    if case == "repeated-ids":  # a row kept twice ranks twice, in the list of its query
        assert max(np.unique(row, return_counts=True)[1].max() for row in got[1].numpy()) == 2


def test_quantized_wrappers_reject_bad_operands():
    g = torch.Generator().manual_seed(0)
    pq = builder.quantize_postings(torch.randn(50, 100, generator=g), bits=4, group=32)
    q = torch.randn(3, 100, generator=g).to(torch.bfloat16)
    with pytest.raises(ValueError, match="want docs"):
        kernel.fused_topk_quantized(q[:, :90], pq.q, pq.scale, 5, 4, 32)
    with pytest.raises(ValueError, match="want docs"):
        kernel.fused_topk_quantized(q, pq.q, pq.scale, 5, 4, 64)
    with pytest.raises(ValueError, match="multiple of 32"):
        kernel.fused_topk_quantized(q, pq.q, pq.scale, 5, 4, 16)
    with pytest.raises(TypeError):
        kernel.fused_topk_quantized(q.to(torch.int8), pq.q, pq.scale, 5, 4, 32)
    with pytest.raises(TypeError):
        kernel.fused_topk_quantized(q, pq.q.view(torch.int8), pq.scale, 5, 4, 32)
    with pytest.raises(ValueError, match="bits"):
        kernel.fused_topk_quantized(q, pq.q, pq.scale, 5, 2, 32)
    ids = torch.zeros((3, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="candidate count"):
        kernel.fused_topk_gathered_quantized(q, pq.q, pq.scale, ids, 9, 50, 4, 32)


# ---------------------------------------------------------------------------
# The read path end to end, on the JAX index's own arrays
# ---------------------------------------------------------------------------


def _saved(tmp_path, jann):
    """What the reference's ``save`` writes, read back as plain data."""
    jann.save(str(tmp_path))
    meta = json.loads((tmp_path / "config.json").read_text())
    with np.load(tmp_path / "index.npz") as z:
        arrays = {name: z[name] for name in z.files}
    return meta, arrays


def _port_of(tmp_path, jann, **knobs):
    meta, arrays = _saved(tmp_path, jann)
    return index_from_numpy(meta["method"], meta["config"], arrays, meta["dtypes"], device="cpu",
                            pq=meta.get("pq"), quantized_rerank=meta["quantized_rerank"],
                            **knobs)


@pytest.mark.parametrize("pp", POSTINGS)
@pytest.mark.parametrize("method", METHODS)
def test_search_via_index_from_numpy_matches_jax(tmp_path, method, pp):
    x, q = _corpus(seed=2)
    _, jcfg = _configs(method)
    jann = JAnnIndex.build(jnp.asarray(x), jcfg, rerank_store="int8", primary_postings=pp)
    idx = _port_of(tmp_path, jann)
    assert idx.quantized_rerank and isinstance(idx.pipeline.reranker, pl.QuantizedCosineReranker)
    assert idx.nbytes() == jann.nbytes()
    if jann.index.pq is not None:
        assert (idx.index.pq.bits, idx.index.pq.group, idx.index.pq.cols) == (
            jann.index.pq.bits, jann.index.pq.group, jann.index.pq.cols)
    # the match stage on the JAX query operand: dot int8 (no pq, integer
    # scores) exact; the packed stores are float sums
    jqn = jbruteforce.l2_normalize(jnp.asarray(q))
    jrep = jann.pipeline.encoder(jann.index, jqn)
    exact = method == "dot" and pp == "int8"
    want = jann.pipeline.matcher(jann.index, jrep, 50 if exact else 51, use_kernel=False)
    got = idx.pipeline.matcher(idx.index, to_torch(jrep), 50)
    assert_topk_match(got, [np.asarray(a) for a in want], exact=exact)
    # the int8 rerank of the same candidates
    cand = got[1]
    jrr = jann.pipeline.reranker(jann.index, jqn, jnp.asarray(cand.numpy()), 10)
    rr = idx.pipeline.reranker(idx.index, to_torch(jqn), cand, 10)
    np.testing.assert_allclose(rr[0].numpy(), np.asarray(jrr[0]), rtol=1e-5, atol=1e-5)
    assert float(ev.overlap(to_torch(jrr[1]), rr[1])) >= 0.99
    # the whole search from raw queries, each package encoding on its own
    for rerank in (False, True):
        s, i = idx.search(q, k=10, depth=50, rerank=rerank)
        js, ji = jann.search(jnp.asarray(q), k=10, depth=50, rerank=rerank, use_kernel=False)
        assert float(ev.overlap(to_torch(ji), i)) >= 0.99
        np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("pp", POSTINGS)
@pytest.mark.parametrize("method", METHODS)
def test_build_from_raw_vectors_matches_jax(method, pp):
    x, q = _corpus(seed=3)
    cfg, jcfg = _configs(method)
    for group in (32, 64) if pp == "int4" else (32,):
        idx = AnnIndex.build(x, cfg, rerank_store="int8", primary_postings=pp,
                             postings_group=group, device="cpu")
        jann = JAnnIndex.build(jnp.asarray(x), jcfg, rerank_store="int8", primary_postings=pp,
                               postings_group=group)
        assert idx.nbytes() == jann.nbytes() and idx.quantized_rerank == jann.quantized_rerank
        _, ji = jann.search(jnp.asarray(q), k=10, depth=50, rerank=True, use_kernel=False)
        _, i = idx.search(q, k=10, depth=50, rerank=True)
        assert float(ev.overlap(to_torch(ji), i)) >= 0.99


@pytest.mark.parametrize("quantized", [True, False])
def test_candidate_scores_match_jax(tmp_path, quantized):
    """Brute force keeps its fp32 rows beside the int8 store: both rerank
    operands exist on one index."""
    x, q = _corpus(seed=4)
    jann = JAnnIndex.build(jnp.asarray(x), JBruteForceConfig(), rerank_store="int8")
    idx = _port_of(tmp_path, jann)
    qn = np.array(jbruteforce.l2_normalize(jnp.asarray(q)))
    cand = np.random.default_rng(0).integers(-1, 512, (8, 40)).astype(np.int32)
    want = jpl.candidate_scores(jann.index, jnp.asarray(qn), jnp.asarray(cand),
                                quantized=quantized)
    got = pl.candidate_scores(idx.index, torch.from_numpy(qn), torch.from_numpy(cand),
                              quantized=quantized)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    assert (got.numpy()[cand < 0] == -np.inf).all()
    no_store = AnnIndex.build(x, FakeWordsConfig(), rerank_store="none", device="cpu")
    with pytest.raises(ValueError, match="original vectors" if not quantized else "int8 store"):
        pl.candidate_scores(no_store.index, torch.from_numpy(qn), torch.from_numpy(cand),
                            quantized=quantized)


# ---------------------------------------------------------------------------
# Blockmax over packed postings
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pp", POSTINGS)
@pytest.mark.parametrize("scoring", ["classic", "dot"])
def test_blockmax_quantized_bounds_bit_equal(tmp_path, scoring, pp):
    x, q = _corpus(n=500, seed=5)
    _, jcfg = _configs(scoring)
    jann = JAnnIndex.build(jnp.asarray(x), jcfg, rerank_store="none", primary_postings=pp)
    idx = _port_of(tmp_path, jann)
    jbm = jblockmax.build_blockmax(jann.index, 64)
    bm = blockmax.build_blockmax(idx.index, 64)
    assert bm.mode == jbm.mode == scoring and bm.num_blocks == jbm.num_blocks == 8
    assert bm.dequantized == (idx.index.pq is not None)
    ub = bm.ub.to(to_torch(jbm.ub).dtype)
    assert torch.equal(ub.float(), bm.ub)  # the f32 bounds narrow back exactly
    _equal_bits(ub, jbm.ub)
    jrep = jann.pipeline.encoder(jann.index, jbruteforce.l2_normalize(jnp.asarray(q)))
    got = blockmax.block_bounds(bm, to_torch(jrep))
    want = np.asarray(jblockmax.block_bounds(jbm, jrep))
    if bm.dequantized or scoring == "classic":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("pp", POSTINGS)
@pytest.mark.parametrize("scoring", ["classic", "dot"])
def test_blockmax_quantized_beta1_parity(tmp_path, scoring, pp):
    """Every block kept reproduces the dense quantized search (the bounds are
    maxima of the dequantized values), and below every block the port prunes
    as the reference does."""
    x, q = _corpus(n=512, seed=6)
    _, jcfg = _configs(scoring)
    jann = JAnnIndex.build(jnp.asarray(x), jcfg, rerank_store="none", primary_postings=pp)
    idx = _port_of(tmp_path, jann)
    bm = blockmax.build_blockmax(idx.index, 64)
    rep = to_torch(jann.pipeline.encoder(jann.index, jbruteforce.l2_normalize(jnp.asarray(q))))
    exact = scoring == "dot" and pp == "int8"
    dense = idx.pipeline.matcher(idx.index, rep, 51)
    pruned = blockmax.pruned_search(idx.index, bm, rep, bm.num_blocks, 50)
    assert_topk_match(pruned, dense, exact=exact)
    jbm = jblockmax.build_blockmax(jann.index, 64)
    got = blockmax.pruned_search(idx.index, bm, rep, 3, 40)
    want = jblockmax.pruned_search(jann.index, jbm, jnp.asarray(rep.numpy()), n_keep=3,
                                   depth=40 if exact else 41, use_kernel=False)
    assert_topk_match(got, [np.asarray(a) for a in want], exact=exact)
    # the facade, from the same arrays with the blockmax knobs
    pidx = _port_of(tmp_path, jann, blockmax_keep=3, blockmax_block_size=64)
    assert isinstance(pidx.pipeline.matcher, pl.BlockMaxMatcher)
    s, i = pidx.search(q, k=10, depth=40)
    assert s.shape == (8, 10) and torch.isfinite(s).all()


# ---------------------------------------------------------------------------
# The memory-budget planner (pure Python: the same picks as the reference)
# ---------------------------------------------------------------------------


def test_budget_planner_walks_the_frontier():
    assert mb.DEFAULT_FRONTIER == jmb.DEFAULT_FRONTIER
    cfg, jcfg = FakeWordsConfig(quantization=50), JFakeWordsConfig(quantization=50)
    n, d = 2000, 64
    picks = []
    for budget in (10**12, 900_000, 600_000, 450_000):
        p = mb.plan_for_budget(cfg, n, d, budget)
        assert p == jmb.plan_for_budget(jcfg, n, d, budget)
        assert p["estimated_bytes"] <= budget
        picks.append((p["primary_postings"], p["rerank_store"]))
    assert picks[0] == ("fp32", "exact")
    order = [(e["primary_postings"], e["rerank_store"]) for e in mb.DEFAULT_FRONTIER]
    assert [order.index(p) for p in picks] == sorted(order.index(p) for p in picks)
    with pytest.raises(ValueError, match="below the smallest"):
        mb.plan_for_budget(cfg, n, d, 1000)


def test_budget_planner_pins_caller_knobs():
    for kwargs in (dict(primary_postings="int4"), dict(rerank_store="none"),
                   dict(keep_frac=0.5)):
        p = mb.plan_for_budget(BruteForceConfig(), 1000, 64, 10**12, **kwargs)
        assert p == jmb.plan_for_budget(JBruteForceConfig(), 1000, 64, 10**12, **kwargs)
        assert all(p[k] == v for k, v in kwargs.items())
    with pytest.raises(ValueError, match="pinned"):
        mb.plan_for_budget(BruteForceConfig(), 1000, 64, 10**12, primary_postings="int2")
    lsh, jlsh = LexicalLshConfig(buckets=64, hashes=2), JLexicalLshConfig(buckets=64, hashes=2)
    assert mb.plan_for_budget(lsh, 1000, 64, 10**12) == jmb.plan_for_budget(jlsh, 1000, 64, 10**12)


@pytest.mark.parametrize("method", METHODS)
def test_budget_estimate_matches_actual_store(method):
    """The per-doc byte formula tracks what the builder stores, within the
    O(T) statistics, and equals the reference's at ann-word2vec's width."""
    x, _ = _corpus(n=512, seed=7)
    cfg, jcfg = _configs(method)
    for pp, rs in (("int8", "none"), ("int4", "int8"), ("fp32", "int8")):
        ann = AnnIndex.build(x, cfg, rerank_store=rs, primary_postings=pp, device="cpu")
        est = mb.estimate_bytes(cfg, 512, 64, pp, rs)
        assert est == jmb.estimate_bytes(jcfg, 512, 64, pp, rs)
        assert est <= ann.nbytes() <= est + 64 * 64 * 8
        for group in (32, 64):
            assert mb.postings_bytes_per_doc(cfg, 300, pp, group) == (
                jmb.postings_bytes_per_doc(jcfg, 300, pp, group))
    assert mb.rerank_bytes_per_doc(300, "int8") == 304


def test_build_with_memory_budget_picks_and_serves():
    x, q = _corpus(n=1000, seed=8)
    cfg = FakeWordsConfig(quantization=50)
    ann = AnnIndex.build(x, cfg, memory_budget_bytes=300_000, device="cpu")
    jann = JAnnIndex.build(jnp.asarray(x), JFakeWordsConfig(quantization=50),
                           memory_budget_bytes=300_000)
    assert ann.index.pq is not None and ann.index.pq.bits == jann.index.pq.bits
    assert ann.quantized_rerank == jann.quantized_rerank
    assert ann.blockmax_keep == jann.blockmax_keep
    s, i = ann.search(q[:4], k=10, depth=50)
    assert i.shape == (4, 10)
    small = AnnIndex.build(x, cfg, memory_budget_bytes=210_000, device="cpu")
    assert small.index.pq.bits == 4 and small.index.vq is None and not small.quantized_rerank
    assert small.search(q[:4], k=10, depth=50)[1].shape == (4, 10)
    with pytest.raises(ValueError, match="below the smallest"):
        AnnIndex.build(x, cfg, memory_budget_bytes=150_000, device="cpu")


def test_load_frontier_orders_by_measured_recall(tmp_path):
    bench = {"quantized_ab": [
        {"postings": "int4", "recall_at_10": 0.99},
        {"postings": "fp32", "recall_at_10": 0.95},
        {"postings": "int8", "recall_at_10": 0.97},
    ]}
    path = tmp_path / "bench.json"
    path.write_text(json.dumps(bench))
    frontier = mb.load_frontier(str(path))
    assert frontier == jmb.load_frontier(str(path))
    assert frontier[0]["primary_postings"] == "int4"
    assert len(frontier) == len(mb.DEFAULT_FRONTIER)


def test_unquantizable_encodings_refuse():
    x, _ = _corpus(n=64, m=32)
    with pytest.raises(ValueError, match="categorical"):
        AnnIndex.build(x, LexicalLshConfig(buckets=64, hashes=2), primary_postings="int8",
                       device="cpu")
    lidx = AnnIndex.build(x, LexicalLshConfig(buckets=64, hashes=2), rerank_store="int8",
                          device="cpu")
    assert lidx.quantized_rerank and lidx.index.vq is not None


@pytest.mark.parametrize("method", METHODS)
def test_quantized_recall_within_002_of_fp32(method):
    """int8 / int4 postings with the int8 rerank store stay within 0.02
    recall@10 of the fp32 postings with the same rerank store (the
    reference's property, on its data)."""
    rng = np.random.default_rng(7)
    corpus = rng.normal(size=(1024, 64)).astype(np.float32)
    corpus += 0.5 * rng.normal(size=(1, 64)).astype(np.float32)
    q = corpus[:32] + 0.01 * rng.normal(size=(32, 64)).astype(np.float32)
    _, gt = jbruteforce.exact_topk(jnp.asarray(corpus), jnp.asarray(q), 10, use_kernel=False)
    cfg, _ = _configs(method)
    recalls = {}
    for pp in ("fp32", "int8", "int4"):
        ann = AnnIndex.build(corpus, cfg, rerank_store="int8", primary_postings=pp, device="cpu")
        _, ids = ann.search(q, k=10, depth=150, rerank=True)
        recalls[pp] = float(ev.recall_at(to_torch(gt), ids))
    assert recalls["fp32"] - recalls["int8"] <= 0.02, recalls
    assert recalls["fp32"] - recalls["int4"] <= 0.02, recalls
