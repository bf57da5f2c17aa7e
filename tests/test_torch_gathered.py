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
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_topk_match, to_torch

from repro.kernels.fused_topk import ref as jref
from repro.kernels.fused_topk.kernel import fused_topk_gathered as jgathered
from repro_torch.kernels.fused_topk import ops, ref
from repro_torch.kernels.fused_topk.kernel import fused_topk_gathered

SENTINEL = np.uint32(0xFFFFFFFF)


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
