"""Plain PyTorch versions of the fused streaming top-k kernels (the
computation each CUDA kernel replaces; these DO materialize the (B, N) or
(B, R) score matrix, and the gathered ones the (B, R, T) rows).

``fused_topk_ref`` is what :func:`..kernel.fused_topk` runs for tensors on
the CPU, ``gathered_topk_ref`` what :func:`..kernel.fused_topk_gathered`
runs there, and ``quantized_topk_ref`` / ``quantized_gathered_topk_ref``
what the quantized wrappers run there; the card's kernels are held against
them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.common import BIG_ID, dequant_int4, f32_matmul

LSH_SENTINEL = 0xFFFFFFFF
_LSH_TILE_ELEMS = 2**27  # bound on the (B, tile, S) compare of the lsh mode
_DEQUANT_TILE_ELEMS = 2**26  # bound on the dequantized rows held at once
_INT_DTYPES = (torch.int8, torch.int16, torch.int32, torch.int64)


def _lsh_bits(x: torch.Tensor) -> torch.Tensor:
    """uint32 signatures as int32 bits (the sentinel becomes -1)."""
    return x.view(torch.int32) if x.dtype == torch.uint32 else x


def scores_ref(q: torch.Tensor, docs: torch.Tensor, mode: str = "gemm") -> torch.Tensor:
    """Dense (B, N) float32 scores.

    gemm: integer operands sum exactly (in float64, exact far past any
    int8 x int8 sum this package makes, then cast like the reference's
    int32 -> f32); float operands (bf16 widened to f32: exact products)
    accumulate in full float32 -- on the card with TF32 switched off for this
    product only (the caller's setting is restored), so the ground truth
    stays fp32.  lsh: sentinel-aware collision counts."""
    if mode == "lsh":
        qb, db = _lsh_bits(q), _lsh_bits(docs)
        valid = (qb != -1)[:, None, :]
        tile = max(1, _LSH_TILE_ELEMS // max(1, qb.numel()))
        return torch.cat([
            ((qb[:, None, :] == db[None, i:i + tile, :]) & valid).sum(-1, dtype=torch.int32)
            for i in range(0, db.shape[0], tile)], dim=1).float()
    return _product(q, docs.T)


def _product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (batched or not) in f32: integer operands exactly (in
    float64), float operands widened to f32, with TF32 off on the card."""
    if a.dtype in _INT_DTYPES:
        return (a.double() @ b.double()).float()
    return f32_matmul(a, b)


def apply_filt(scores: torch.Tensor, filt: Optional[torch.Tensor]) -> torch.Tensor:
    """Mask a dense (B, N) score matrix with a keep bitmap ((N,) shared or
    (B, N) per query; nonzero = keep).  ``filt=None`` is the identity."""
    if filt is None:
        return scores
    f = filt if filt.dim() == 2 else filt[None, :]
    return torch.where(f != 0, scores, torch.full_like(scores, -torch.inf))


def fused_topk_ref(
    q: torch.Tensor, docs: torch.Tensor, depth: int, mode: str = "gemm",
    filt: Optional[torch.Tensor] = None, n_docs: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense scores + a stable descending sort: the top ``depth`` with ties
    to the lowest doc id (``lax.top_k`` order; ``torch.topk`` promises no
    tie order).  Rows >= ``n_docs`` never rank; -inf slots get id -1."""
    if n_docs is not None and n_docs < docs.shape[0]:
        docs = docs[:n_docs]
        filt = None if filt is None else filt[..., :n_docs]
    scores = apply_filt(scores_ref(q, docs, mode), filt)
    s, i = torch.sort(scores, dim=-1, descending=True, stable=True)
    s, i = s[:, :depth], i[:, :depth].to(torch.int32)
    return s, torch.where(s == -torch.inf, torch.full_like(i, -1), i)


def gather_rows(store: torch.Tensor, row_ids: torch.Tensor, n_docs: int) -> torch.Tensor:
    """``store[clamp(row_ids, 0, n_docs - 1)]``: the (B, R, T) rows the plain
    gathered version scores (uint32 rows through their int32 bits: CUDA has
    no uint32 indexing)."""
    idx = row_ids.long().clamp(0, n_docs - 1)
    if store.dtype == torch.uint32:
        return store.view(torch.int32)[idx].view(torch.uint32)
    return store[idx]


def gathered_scores_ref(q: torch.Tensor, rows: torch.Tensor, mode: str = "gemm") -> torch.Tensor:
    """Dense (B, R) f32 scores of each query against its own gathered rows
    (B, R, T), in :func:`scores_ref`'s arithmetic."""
    if mode == "lsh":
        qb, rb = _lsh_bits(q)[:, None, :], _lsh_bits(rows)
        return ((qb == rb) & (qb != -1)).sum(-1, dtype=torch.int32).float()
    return _product(rows, q[:, :, None])[:, :, 0]


def topk_by_id_ref(
    scores: torch.Tensor, ids: torch.Tensor, depth: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top ``depth`` by (score desc, id asc): a stable sort on the id, then a
    stable descending sort on the score.  -inf slots get id -1."""
    by_id, pos = torch.sort(ids.to(torch.int32), dim=-1, stable=True)
    s, order = torch.sort(torch.gather(scores, 1, pos), dim=-1, descending=True, stable=True)
    s, i = s[:, :depth], torch.gather(by_id, 1, order[:, :depth])
    return s, torch.where(s == -torch.inf, torch.full_like(i, -1), i)


def gathered_topk_ref(
    q: torch.Tensor, rows: torch.Tensor, row_ids: torch.Tensor, depth: int, n_docs: int,
    mode: str = "gemm", filt: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockmax stage 2 unfused: scores of the gathered rows (B, R, T), then
    the top ``depth`` with ties to the lowest GLOBAL id.  Rows whose id is
    outside [0, n_docs), or whose (B, R) ``filt`` bit is 0, score -inf and
    carry ``BIG_ID``."""
    valid = (row_ids >= 0) & (row_ids < n_docs)
    if filt is not None:
        valid = valid & (filt != 0)
    scores = torch.where(valid, gathered_scores_ref(q, rows, mode), -torch.inf)
    ids = torch.where(valid, row_ids, torch.full_like(row_ids, BIG_ID))
    return topk_by_id_ref(scores, ids, depth)


# --------------------------------------------------------------------------
# Quantized postings (port of the reference's quantized references): the
# dequant order the kernels run.  int8: the stored values cast to the query
# dtype (exact), an f32 sum, the per-doc scale applied once after it.  int4:
# the canonical ``dequant_int4`` (f32 (nibble - 8) * group scale, one cast to
# the query dtype) before the product.  So the kernels' and these operands
# agree bit for bit, and scores differ only by the f32 summation order.
# --------------------------------------------------------------------------


def _dequantized(rows: torch.Tensor, scale: torch.Tensor, bits: int, group: int,
                 dtype, t: int) -> torch.Tensor:
    """Packed rows (..., C) -> their (..., T) values in ``dtype``; for int8
    the cast alone (the scale comes after the sum)."""
    if bits == 8:
        return rows.to(dtype)
    return dequant_int4(rows, scale, group, dtype)[..., :t]


def quantized_scores_ref(q: torch.Tensor, docs: torch.Tensor, scale: torch.Tensor,
                         bits: int, group: int = 0) -> torch.Tensor:
    """Dense (B, N) f32 scores of a float query over a packed int8 / int4
    store, dequantized a tile of rows at a time."""
    t = q.shape[1]
    tile = max(1, _DEQUANT_TILE_ELEMS // max(1, 2 * docs.shape[1]))
    out = []
    for i in range(0, docs.shape[0], tile):
        d, sc = docs[i:i + tile], scale[i:i + tile]
        s = _product(q, _dequantized(d, sc, bits, group, q.dtype, t).T)
        out.append(s * sc[:, 0][None, :] if bits == 8 else s)
    return torch.cat(out, dim=1)


def quantized_topk_ref(
    q: torch.Tensor, docs: torch.Tensor, scale: torch.Tensor, depth: int, bits: int,
    group: int = 0, filt: Optional[torch.Tensor] = None, n_docs: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense quantized scores + the stable descending sort of
    :func:`fused_topk_ref` (ties to the lowest id; rows >= ``n_docs`` never
    rank; -inf slots get id -1)."""
    if n_docs is not None and n_docs < docs.shape[0]:
        docs, scale = docs[:n_docs], scale[:n_docs]
        filt = None if filt is None else filt[..., :n_docs]
    scores = apply_filt(quantized_scores_ref(q, docs, scale, bits, group), filt)
    s, i = torch.sort(scores, dim=-1, descending=True, stable=True)
    s, i = s[:, :depth], i[:, :depth].to(torch.int32)
    return s, torch.where(s == -torch.inf, torch.full_like(i, -1), i)


def quantized_gathered_scores_ref(q: torch.Tensor, rows: torch.Tensor, scale: torch.Tensor,
                                  bits: int, group: int = 0) -> torch.Tensor:
    """Dense (B, R) f32 scores of each query against its own gathered packed
    rows (B, R, C) and their scales (B, R, ·), dequantized a slice of R at a
    time."""
    b, r, c = rows.shape
    t = q.shape[1]
    step = max(1, _DEQUANT_TILE_ELEMS // max(1, 2 * b * c))
    out = []
    for i in range(0, r, step):
        rw, sc = rows[:, i:i + step], scale[:, i:i + step]
        s = _product(_dequantized(rw, sc, bits, group, q.dtype, t), q[:, :, None])[:, :, 0]
        out.append(s * sc[:, :, 0] if bits == 8 else s)
    return torch.cat(out, dim=1)


def quantized_gathered_topk_ref(
    q: torch.Tensor, store: torch.Tensor, scale: torch.Tensor, row_ids: torch.Tensor,
    depth: int, n_docs: int, bits: int, group: int = 0, filt: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantized blockmax stage 2 unfused: gather the packed rows and scales
    of ``row_ids`` from the (N, ·) store (uint8 and int8 index directly),
    score them, and keep the top ``depth`` with ties to the lowest GLOBAL
    id.  Rows whose id is outside [0, n_docs), or whose (B, R) ``filt`` bit
    is 0, score -inf and carry ``BIG_ID``."""
    valid = (row_ids >= 0) & (row_ids < n_docs)
    if filt is not None:
        valid = valid & (filt != 0)
    rows, scales = gather_rows(store, row_ids, n_docs), gather_rows(scale, row_ids, n_docs)
    scores = torch.where(valid, quantized_gathered_scores_ref(q, rows, scales, bits, group),
                         -torch.inf)
    ids = torch.where(valid, row_ids, torch.full_like(row_ids, BIG_ID))
    return topk_by_id_ref(scores, ids, depth)
