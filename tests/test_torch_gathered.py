"""The port's gathered fused top-k (K3, blockmax stage 2) against the JAX
package's.

The port's ``fused_topk_gathered`` takes the stored (N, T) matrix and the
(B, R) row ids; the JAX kernel takes the rows already gathered, so the JAX
side gets ``store[min(row_ids, n_docs - 1)]``.  On the CPU the port runs its
plain version; the JAX kernel runs in Pallas interpret mode with
bn = bk = 128.  Integer modes (int8, lsh, 0/1 ties) must agree bit for bit,
ids and scores; float modes to rtol = atol = 1e-5 with ids equal away from
near-ties (summation order differs).  ``test_torch_gpu.py`` holds the CUDA
kernel against the plain version on a card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_topk_match, threshold_merge, to_torch

from repro.kernels.fused_topk import ref as jref
from repro.kernels.fused_topk.kernel import fused_topk_gathered as jgathered
from repro_torch.kernels.common import BIG_ID
from repro_torch.kernels.fused_topk import ops, ref
from repro_torch.kernels.fused_topk.kernel import fused_topk_gathered

SENTINEL = np.uint32(0xFFFFFFFF)
BLOCK = 256  # the blockmax block: kept rows come in whole 256-row blocks


def _operands(kind: str, b: int, n: int, r: int, t: int, n_docs: int, seed: int):
    """(q, store) as JAX arrays, and (B, R) row ids in [0, 4 n_docs) in
    random order, so that most are padding."""
    rng = np.random.default_rng(seed)
    if kind == "int8":
        q = jnp.asarray(rng.integers(-50, 50, (b, t)), jnp.int8)
        store = jnp.asarray(rng.integers(-50, 50, (n, t)), jnp.int8)
    elif kind == "ties":
        q = jnp.asarray(rng.integers(0, 2, (b, t)), jnp.int8)
        store = jnp.asarray(rng.integers(0, 2, (n, t)), jnp.int8)
    elif kind == "lsh":
        store = jnp.asarray(rng.integers(0, 6, (n, t)), jnp.uint32)
        q = jnp.asarray(rng.integers(0, 6, (b, t)), jnp.uint32).at[:, ::7].set(SENTINEL)
    else:
        jdt = jnp.bfloat16 if kind == "bf16" else jnp.float32
        q = jnp.asarray(rng.normal(size=(b, t)), jdt)
        store = jnp.asarray(rng.normal(size=(n, t)), jdt)
    row_ids = rng.integers(0, 4 * n_docs, (b, r)).astype(np.int32)
    return q, store, row_ids


def _jax(q, store, row_ids, depth, n_docs, mode, filt=None):
    rows = store[np.minimum(row_ids, n_docs - 1)]
    got = jgathered(q, rows, jnp.asarray(row_ids), depth, n_docs, mode=mode, bn=128, bk=128,
                    interpret=True, filt=None if filt is None else jnp.asarray(filt))
    want = jref.gathered_topk_ref(q, rows, jnp.asarray(row_ids), depth, n_docs, mode=mode,
                                  filt=None if filt is None else jnp.asarray(filt))
    return [np.asarray(x) for x in got], [np.asarray(x) for x in want]


@pytest.mark.parametrize("kind", ["bf16", "f32", "int8", "lsh"])
def test_gathered_topk_matches_jax_with_padding_ids(kind):
    """Ids >= n_docs are padding: -inf, reported as -1, never ranked."""
    b, r, t, n_docs = 3, 160, 33, 64
    q, store, row_ids = _operands(kind, b, n_docs, r, t, n_docs, seed=7)
    mode = "lsh" if kind == "lsh" else "gemm"
    exact = kind in ("int8", "lsh")
    (jk_s, jk_i), (jr_s, jr_i) = _jax(q, store, row_ids, 61, n_docs, mode)
    got = fused_topk_gathered(to_torch(q), to_torch(store), torch.from_numpy(row_ids), 60,
                              n_docs, mode=mode)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    assert_topk_match(got, (jk_s, jk_i), exact=exact)
    assert_topk_match(got, (jr_s, jr_i), exact=exact)
    assert (got[1][got[0] == -torch.inf] == -1).all()
    assert bool((got[0] == -torch.inf).any())  # padding reached the output


def test_gathered_tied_tiles_keep_smaller_global_ids():
    """Ids are not ordered across tiles; a later tile that only ties the
    running depth-th best holds the smaller, winning ids."""
    n_docs, t = 2048, 16
    q = jnp.ones((1, t), jnp.int8)
    store = jnp.ones((n_docs, t), jnp.int8)  # every candidate scores exactly t
    row_ids = np.concatenate([np.arange(1000, 1128), np.arange(0, 128)])[None].astype(np.int32)
    (jk_s, jk_i), _ = _jax(q, store, row_ids, 128, n_docs, "gemm")
    s, i = fused_topk_gathered(to_torch(q), to_torch(store), torch.from_numpy(row_ids), 128,
                               n_docs)
    np.testing.assert_array_equal(i.numpy(), jk_i)
    np.testing.assert_array_equal(i[0].numpy(), np.arange(128))
    assert (s == t).all()


@pytest.mark.parametrize("kind", ["ties", "lsh"])
def test_gathered_filt_and_massive_ties_at_depth_r(kind):
    """(B, R) filt folds into the row ids; 0/1 operands at depth = R, so the
    order of every tie must follow the global id."""
    b, r, t, n_docs = 3, 130, 16, 100
    q, store, row_ids = _operands(kind, b, n_docs, r, t, n_docs, seed=11)
    row_ids = np.stack([np.random.default_rng(s).permutation(n_docs + 30)[:r]
                        for s in range(b)]).astype(np.int32)
    filt = np.random.default_rng(3).random((b, r)) < 0.6
    mode = "lsh" if kind == "lsh" else "gemm"
    (jk_s, jk_i), (jr_s, jr_i) = _jax(q, store, row_ids, r, n_docs, mode, filt)
    got = fused_topk_gathered(to_torch(q), to_torch(store), torch.from_numpy(row_ids), r,
                              n_docs, mode=mode, filt=torch.from_numpy(filt))
    assert_topk_match(got, (jk_s, jk_i), exact=True)
    assert_topk_match(got, (jr_s, jr_i), exact=True)
    kept = row_ids[filt & (row_ids < n_docs)]
    assert set(got[1][got[1] >= 0].tolist()) <= set(kept.tolist())


def test_topk_by_id_ref_orders_ties_by_id():
    scores = torch.tensor([[1.0, 2.0, 2.0, -torch.inf, 2.0]])
    ids = torch.tensor([[5, 9, 3, 1, 7]], dtype=torch.int32)
    s, i = ref.topk_by_id_ref(scores, ids, 5)
    assert i.tolist() == [[3, 7, 9, 5, -1]]
    assert s.tolist() == [[2.0, 2.0, 2.0, 1.0, -float("inf")]]


def test_gathered_wrapper_checks_and_reexport():
    assert ops.fused_topk_gathered is fused_topk_gathered
    q = torch.zeros((2, 8), dtype=torch.float32)
    store = torch.zeros((10, 8), dtype=torch.float32)
    ids = torch.zeros((2, 5), dtype=torch.int32)
    with pytest.raises(ValueError, match="candidate count"):
        fused_topk_gathered(q, store, ids, 6, 10)
    with pytest.raises(ValueError, match="n_docs"):
        fused_topk_gathered(q, store, ids, 3, 11)
    with pytest.raises(ValueError, match="filt"):
        fused_topk_gathered(q, store, ids, 3, 10, filt=torch.ones(10, dtype=torch.bool))
    with pytest.raises(ValueError, match="mode"):
        fused_topk_gathered(q, store, ids, 3, 10, mode="dense")


def _block_rows(rng, b: int, n_docs: int, n_keep: int, scores=None) -> np.ndarray:
    """(B, n_keep * 256) row ids: whole 256-row blocks of [0, n_docs), in
    random order, or (``scores`` (B, n_docs)) best block first, as blockmax
    stage 1 orders them (``blockmax.kept_rows``: by the block's bound; here
    its true best score, an exact bound)."""
    n_blocks = n_docs // BLOCK
    out = []
    for q in range(b):
        if scores is None:
            blocks = rng.permutation(n_blocks)[:n_keep]
        else:
            best = scores[q].reshape(n_blocks, BLOCK).max(1)
            blocks = np.argsort(-best, kind="stable")[:n_keep]
        out.append((blocks[:, None] * BLOCK + np.arange(BLOCK)).reshape(-1))
    return np.stack(out).astype(np.int32)


@pytest.mark.parametrize("case", ["bound-order", "depth-r", "padding-splits", "tied-depth"])
def test_gathered_topk_matches_jax_across_many_splits(case):
    """Sizes at which the card's plan cuts each query's rows into many
    splits (12 of 256 rows at B = 1 and 2 on 132 SMs), so pass 2 merges
    many lists: rows in block-bound order (the best block first), depth =
    R, whole 256-row splits of padding ids, and 0/1 operands whose scores
    tie across splits at the depth-th rank.  Integer operands: bit for
    bit."""
    rng = np.random.default_rng({"bound-order": 21, "depth-r": 22, "padding-splits": 23,
                                 "tied-depth": 24}[case])
    b, n_docs, t = 2, 16 * BLOCK, 16
    lo, hi = (-50, 50) if case == "bound-order" else (0, 2)
    q = jnp.asarray(rng.integers(lo, hi, (b, t)), jnp.int8)
    store = jnp.asarray(rng.integers(lo, hi, (n_docs, t)), jnp.int8)
    if case == "bound-order":
        scores = np.asarray(q, np.int64) @ np.asarray(store, np.int64).T
        row_ids, depth = _block_rows(rng, b, n_docs, 12, scores), 100
    elif case == "depth-r":
        row_ids = _block_rows(rng, b, n_docs, 3)
        depth = row_ids.shape[1]
    elif case == "padding-splits":
        row_ids = _block_rows(rng, b, n_docs, 12)
        row_ids[:, 3 * BLOCK:6 * BLOCK] = BIG_ID          # three whole splits of padding
        row_ids[1, 8 * BLOCK:9 * BLOCK] += 2 * n_docs     # and one of ids >= n_docs
        depth = 100
    else:
        row_ids, depth = _block_rows(rng, 1, n_docs, 12), 100
        q, row_ids = q[:1], row_ids
    (jk_s, jk_i), (jr_s, jr_i) = _jax(q, store, row_ids, depth, n_docs, "gemm")
    got = fused_topk_gathered(to_torch(q), to_torch(store), torch.from_numpy(row_ids), depth,
                              n_docs)
    assert_topk_match(got, (jk_s, jk_i), exact=True)
    assert_topk_match(got, (jr_s, jr_i), exact=True)
    if case == "tied-depth":  # rows of several splits tie the depth-th score, past the cut too
        last = float(got[0][0, -1])
        scores = (np.asarray(store, np.int64)[row_ids[0]] @ np.asarray(q, np.int64)[0])
        kept = np.isin(row_ids[0], got[1][0][got[0][0] == last].numpy())
        assert len({p // BLOCK for p in np.flatnonzero(kept)}) > 1
        assert (scores == last).sum() > kept.sum()


def _partial_lists(kind: str, splits: int, b: int, depth: int, seed: int):
    """(splits, B, K) partial lists as pass 1 writes them: each sorted by
    (score desc, id asc), K = depth rounded up to 32, padded with (-inf,
    BIG_ID).  "ties": scores 0..3, ids distinct across lists; "dups": an id
    may sit in several lists, with one score (a row kept twice); "short":
    lists with fewer than depth finite entries, one of none; "float":
    normal scores; "skewed": the first list holds the best scores (rows in
    block-bound order), so the threshold cuts the others short."""
    rng = np.random.default_rng(seed)
    k = -(-depth // 32) * 32
    part_s = np.full((splits, b, k), -np.inf, np.float32)
    part_i = np.full((splits, b, k), BIG_ID, np.int32)
    for qi in range(b):
        ids = rng.permutation(splits * k * 2)[:splits * k].reshape(splits, k)
        by_id = rng.integers(0, 4, splits * k * 2).astype(np.float32)
        for s in range(splits):
            n = k
            if kind == "short":
                n = 0 if s == 1 else int(rng.integers(1, depth))
            row = ids[s, :n]
            if kind == "dups":
                row = rng.integers(0, k, n)
            if kind in ("float", "skewed"):
                sc = rng.normal(size=n).astype(np.float32) - (s > 0) * 2 * (kind == "skewed")
            else:
                sc = by_id[row]
            if kind == "dups":  # a list holds each row once
                row, first = np.unique(row, return_index=True)
                sc = sc[first]
            order = np.lexsort((row, -sc))
            part_s[s, qi, :len(row)], part_i[s, qi, :len(row)] = sc[order], row[order]
    return part_s, part_i


@pytest.mark.parametrize("kind,splits,depth,lists", [
    ("ties", 9, 20, 9),      # one chunk of lists
    ("ties", 30, 16, 4),     # chunks of three lists after the first four
    ("dups", 12, 32, 5),
    ("short", 7, 40, 3),     # lists that give no threshold
    ("float", 20, 10, 20),
    ("skewed", 16, 64, 6),
])
def test_threshold_merge_matches_top_k_over_the_lists(kind, splits, depth, lists):
    """Pass 2's threshold rule and tree merge (``torch_parity.
    threshold_merge``) against ``lax.top_k`` over the concatenated lists'
    first depth entries, ordered by id first so that ties go to the lowest
    id: the same scores and ids, bit for bit."""
    b = 3
    part_s, part_i = _partial_lists(kind, splits, b, depth, seed=splits * depth)
    got = threshold_merge(torch.from_numpy(part_s), torch.from_numpy(part_i), depth, lists)
    cat_s = part_s[:, :, :depth].transpose(1, 0, 2).reshape(b, -1)
    cat_i = part_i[:, :, :depth].transpose(1, 0, 2).reshape(b, -1)
    by_id = np.argsort(cat_i, axis=1, kind="stable")
    cat_s, cat_i = np.take_along_axis(cat_s, by_id, 1), np.take_along_axis(cat_i, by_id, 1)
    want_s, pos = jax.lax.top_k(jnp.asarray(cat_s), depth)
    want_s = np.asarray(want_s)
    want_i = np.where(want_s == -np.inf, -1, np.take_along_axis(cat_i, np.asarray(pos), 1))
    np.testing.assert_array_equal(got[0].numpy(), want_s)
    np.testing.assert_array_equal(got[1].numpy(), want_i)
