"""Wrappers of the fused streaming score -> top-k CUDA kernels:
:func:`fused_topk` replaces ``repro/kernels/fused_topk/kernel.py::fused_topk``
(K1, and K2 in lsh mode) and :func:`fused_topk_gathered` replaces
``fused_topk_gathered`` (K3), both in ``csrc/fused_topk.cu``;
:func:`fused_topk_quantized` (K4) and :func:`fused_topk_gathered_quantized`
(K5) replace the reference's quantized-postings variants, in
``csrc/fused_topk_quantized.cu``.

Routing follows the tensors' device: on the CPU the plain version
(:mod:`.ref`) runs; on a CUDA device the kernel launches on the current
stream, or the call raises.  Each wrapper's ``launches`` counts the calls
that launched on the card; each such call launches two CUDA kernels, pass 1
(``fused_topk_bf16_partial`` for bf16 operands, ``fused_topk_int8_partial``
for int8 ones, ``fused_topk_f32_partial`` for f32 ones,
``fused_topk_lsh_partial`` for lsh, ``fused_topk_gathered_partial``,
``fused_topk_quantized_bf16_partial`` for a bf16 query over packed rows,
``fused_topk_quantized_tf32_partial`` for an f32 one, or
``fused_topk_gathered_quantized_partial``) and the merge
(``fused_topk_merge``, one block per query: a threshold cut, then a tree
merge).  K1 classic, K1 dot, K1 f32 and K4 share one tensor-core pass 1
(``csrc/mma_topk.cuh``); K3 and K5 keep one running list per block (one
query, a range of its rows, on the row-split plan they share) and merge its
candidates by counting, as that pass 1 does; so does K2, whose CUDA-core
pass 1 keeps each query's threshold in a register.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import common
from repro_torch.kernels.fused_topk import ref

_GEMM_MODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_LSH_MODE = 3
_QUERY_DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the quantized kernels' queries


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    p, i, ll, pi = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.POINTER(ctypes.c_int)
    return common.bind(
        "fused_topk", fused_topk_plan=[i, i, i, i, i, pi],
        fused_topk_launch=[i, i, p, p, p, ll, i, i, i, i, i, i, i, i, p, p, p, p, p],
        fused_topk_gathered_plan=[i, i, i, i, i, i, pi],
        fused_topk_gathered_launch=[i, p, p, p, i, i, i, i, i, i, i, i, i, p, p, p, p, p])


def plan(code: int, b: int, n_docs: int, depth: int,
         sm_count: int) -> Tuple[int, int, int, int, int]:
    """The source's launch shape in score mode ``code`` (``fused_topk_plan``;
    f32, bf16 and int8 share the tensor-core pass 1's plan, ``mma_plan``;
    lsh has its own, ``lsh_plan``, with query tiles of 1, 2, 4 or 8 rows at
    B <= 8): (queries per block, running-list width K, N-splits, doc tiles
    per split, docs per tile)."""
    out = (ctypes.c_int * 5)()
    if _lib().fused_topk_plan(code, b, n_docs, depth, sm_count, out) != 0:
        raise ValueError(f"depth {depth}: the running lists do not fit in shared memory")
    return tuple(out)


def gathered_plan(code: int, b: int, r: int, t: int, depth: int,
                  sm_count: int) -> Tuple[int, int, int]:
    """The source's launch shape for :func:`fused_topk_gathered`
    (``fused_topk_gathered_plan``): (running-list width K, row splits per
    query, rows per split); B x splits is the blocks the SMs hold at once,
    so at small B each block walks a long row range."""
    out = (ctypes.c_int * 3)()
    if _lib().fused_topk_gathered_plan(code, b, r, t, depth, sm_count, out) != 0:
        raise ValueError(f"depth {depth}, T {t}: the query row and running list, or pass 2's "
                         "lists, do not fit in shared memory")
    return tuple(out)


def alignment_bits(q: torch.Tensor, docs: torch.Tensor) -> int:
    """``fused_topk_launch``'s ``aligned`` argument: bit 0 (q) and bit 1
    (docs) where every row starts 16-byte aligned, bits 2 and 3 where it
    starts 8-byte but not 16-byte aligned."""
    bits = {16: 1, 8: 4}
    return bits.get(common.row_alignment(q), 0) | bits.get(common.row_alignment(docs), 0) << 1


def _mode_code(q: torch.Tensor, docs: torch.Tensor, mode: str) -> int:
    if q.dtype != docs.dtype:
        raise TypeError(f"q and docs must share a dtype, got {q.dtype} and {docs.dtype}")
    if mode == "lsh":
        if q.dtype != torch.uint32:
            raise TypeError(f"lsh mode takes uint32 signatures, got {q.dtype}")
        return _LSH_MODE
    if q.dtype not in _GEMM_MODES:
        raise TypeError(f"gemm mode takes {list(_GEMM_MODES)}, got {q.dtype}")
    return _GEMM_MODES[q.dtype]


def fused_topk(
    q: torch.Tensor,          # (B, T) f32 / bf16 / int8 (gemm), uint32 (lsh)
    docs: torch.Tensor,       # (N, T) same dtype as q
    depth: int,
    mode: str = "gemm",
    filt: Optional[torch.Tensor] = None,  # (N,) | (B, N) keep bitmap
    n_docs: Optional[int] = None,         # rows >= n_docs never rank
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming top-``depth`` of ``q @ docs.T`` (or of LSH collision counts).

    Returns (scores f32 (B, depth), ids int32 (B, depth)) sorted descending,
    ties to the lowest doc id; empty or masked slots are (-inf, -1).  On the
    card the (B, N) score matrix never exists."""
    if mode not in ("gemm", "lsh"):
        raise ValueError(f"mode must be 'gemm' or 'lsh', got {mode!r}")
    if q.dim() != 2 or docs.dim() != 2 or q.shape[1] != docs.shape[1]:
        raise ValueError(f"want q (B, T) and docs (N, T), got {tuple(q.shape)}, {tuple(docs.shape)}")
    b, t = q.shape
    n = docs.shape[0]
    n_docs = n if n_docs is None else n_docs
    if not 0 < n_docs <= n:
        raise ValueError(f"n_docs {n_docs} outside (0, {n}]")
    if not 0 < depth <= n_docs:
        raise ValueError(f"depth {depth} outside (0, {n_docs}]")
    if filt is not None and tuple(filt.shape) not in ((n,), (b, n)):
        raise ValueError(f"filt must be ({n},) or ({b}, {n}), got {tuple(filt.shape)}")
    if common.on_cpu(q, docs, filt):
        return ref.fused_topk_ref(q, docs, depth, mode, filt, n_docs)

    code = _mode_code(q, docs, mode)
    if not (q.is_contiguous() and docs.is_contiguous()):
        raise ValueError("q and docs must be contiguous")
    if n_docs >= common.BIG_ID:
        raise ValueError(f"n_docs {n_docs} >= {common.BIG_ID}, the empty-slot id")
    f_ptr, f_stride = None, 0
    if filt is not None:
        if filt.dtype not in (torch.bool, torch.uint8) or not filt.is_contiguous():
            raise TypeError("filt must be a contiguous bool or uint8 tensor")
        filt = filt.view(torch.uint8)
        f_ptr, f_stride = filt.data_ptr(), (n if filt.dim() == 2 else 0)

    sm_count = torch.cuda.get_device_properties(q.device).multi_processor_count
    bq, k, splits, tiles_per_split, _ = plan(code, b, n_docs, depth, sm_count)
    part_s = torch.empty((splits, b, k), dtype=torch.float32, device=q.device)
    part_i = torch.empty((splits, b, k), dtype=torch.int32, device=q.device)
    out_s = torch.empty((b, depth), dtype=torch.float32, device=q.device)
    out_i = torch.empty((b, depth), dtype=torch.int32, device=q.device)
    common.launch(
        _lib(), "fused_topk_launch", q.device, code, bq, q.data_ptr(), docs.data_ptr(), f_ptr,
        f_stride, b, n_docs, t, depth, k, splits, tiles_per_split, alignment_bits(q, docs),
        part_s.data_ptr(), part_i.data_ptr(), out_s.data_ptr(), out_i.data_ptr())
    fused_topk.launches += 1
    return out_s, out_i


fused_topk.launches = 0  # type: ignore[attr-defined]


def fused_topk_gathered(
    q: torch.Tensor,          # (B, T) f32 / bf16 / int8 (gemm), uint32 (lsh)
    store: torch.Tensor,      # (N, T) same dtype as q
    row_ids: torch.Tensor,    # (B, R) int32 global ids; outside [0, n_docs) = padding
    depth: int,
    n_docs: int,
    mode: str = "gemm",
    filt: Optional[torch.Tensor] = None,  # (B, R) keep bitmap aligned with row_ids
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-query top-``depth`` of ``score(q[b], store[row_ids[b, r]])`` over
    r (blockmax stage 2).

    Returns (scores f32 (B, depth), ids int32 (B, depth)) sorted descending,
    ties to the lowest GLOBAL id; padding and -inf slots are (-inf, -1).
    Unlike the reference, which takes the rows already gathered, this takes
    the stored matrix and the ids: on the card the kernel reads each row by
    id, so neither the (B, R, T) rows nor the (B, R) scores ever exist."""
    if mode not in ("gemm", "lsh"):
        raise ValueError(f"mode must be 'gemm' or 'lsh', got {mode!r}")
    if (q.dim() != 2 or store.dim() != 2 or row_ids.dim() != 2
            or q.shape[1] != store.shape[1] or row_ids.shape[0] != q.shape[0]):
        raise ValueError(f"want q (B, T), store (N, T), row_ids (B, R), got {tuple(q.shape)}, "
                         f"{tuple(store.shape)}, {tuple(row_ids.shape)}")
    b, t = q.shape
    r = row_ids.shape[1]
    if not 0 < n_docs <= store.shape[0]:
        raise ValueError(f"n_docs {n_docs} outside (0, {store.shape[0]}]")
    if not 0 < depth <= r:
        raise ValueError(f"depth {depth} outside (0, {r}] (the candidate count)")
    if filt is not None and tuple(filt.shape) != (b, r):
        raise ValueError(f"filt must be ({b}, {r}), got {tuple(filt.shape)}")
    if common.on_cpu(q, store, row_ids, filt):
        rows = ref.gather_rows(store, row_ids, n_docs)
        return ref.gathered_topk_ref(q, rows, row_ids, depth, n_docs, mode, filt)

    code = _mode_code(q, store, mode)
    if not (q.is_contiguous() and store.is_contiguous()):
        raise ValueError("q and store must be contiguous")
    if row_ids.dtype != torch.int32:
        raise TypeError(f"row_ids must be int32, got {row_ids.dtype}")
    if n_docs >= common.BIG_ID:
        raise ValueError(f"n_docs {n_docs} >= {common.BIG_ID}, the padding id")
    if filt is not None:  # filtered rows take the id the kernel's range check drops
        row_ids = torch.where(filt != 0, row_ids, common.BIG_ID)
    row_ids = row_ids.contiguous()

    sm_count = torch.cuda.get_device_properties(q.device).multi_processor_count
    k, splits, rows_per_split = gathered_plan(code, b, r, t, depth, sm_count)
    part_s = torch.empty((splits, b, k), dtype=torch.float32, device=q.device)
    part_i = torch.empty((splits, b, k), dtype=torch.int32, device=q.device)
    out_s = torch.empty((b, depth), dtype=torch.float32, device=q.device)
    out_i = torch.empty((b, depth), dtype=torch.int32, device=q.device)
    common.launch(
        _lib(), "fused_topk_gathered_launch", q.device, code, q.data_ptr(), store.data_ptr(),
        row_ids.data_ptr(), b, r, n_docs, t, depth, k, splits, rows_per_split,
        common.row_alignment(store), part_s.data_ptr(), part_i.data_ptr(), out_s.data_ptr(),
        out_i.data_ptr())
    fused_topk_gathered.launches += 1
    return out_s, out_i


fused_topk_gathered.launches = 0  # type: ignore[attr-defined]


# --------------------------------------------------------------------------
# K4 / K5: packed int8 / int4 postings, dequantized in the score stage.
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _qlib() -> ctypes.CDLL:
    p, i, ll, pi = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.POINTER(ctypes.c_int)
    return common.bind(
        "fused_topk_quantized", fused_topk_quantized_plan=[i, i, i, i, i, i, pi],
        fused_topk_quantized_launch=[
            i, i, i, p, p, p, p, ll, i, i, i, i, i, i, i, i, i, i, i, i, p, p, p, p, p],
        fused_topk_gathered_quantized_plan=[i, i, i, i, i, i, pi],
        fused_topk_gathered_quantized_launch=[
            i, i, p, p, p, p, i, i, i, i, i, i, i, i, i, i, i, i, p, p, p, p, p])


def quantized_plan(dtype: torch.dtype, bits: int, b: int, n_docs: int, depth: int,
                   sm_count: int) -> Tuple[int, int, int, int, int]:
    """K4's launch shape for a query of ``dtype`` over packed rows of
    ``bits`` (``fused_topk_quantized_plan``: the tensor-core pass 1's plan):
    (queries per block, running-list width K, N-splits, doc tiles per split,
    docs per tile)."""
    if dtype not in _QUERY_DTYPES:
        raise TypeError(f"q must be one of {list(_QUERY_DTYPES)}, got {dtype}")
    out = (ctypes.c_int * 5)()
    if _qlib().fused_topk_quantized_plan(_QUERY_DTYPES[dtype], bits, b, n_docs, depth, sm_count,
                                         out) != 0:
        raise ValueError(f"depth {depth}: the running lists do not fit in shared memory")
    return tuple(out)


def gathered_quantized_plan(bits: int, b: int, r: int, t: int, depth: int,
                            sm_count: int) -> Tuple[int, int, int]:
    """K5's launch shape (``fused_topk_gathered_quantized_plan``, the row-
    split plan of :func:`gathered_plan`): (running-list width K, row splits
    per query, rows per split); B x splits is the blocks the SMs hold at
    once, so at small B each block walks a long row range."""
    out = (ctypes.c_int * 3)()
    if _qlib().fused_topk_gathered_quantized_plan(bits, b, r, t, depth, sm_count, out) != 0:
        raise ValueError(f"depth {depth}, T {t}: the query row and running list, or pass 2's "
                         "lists, do not fit in shared memory")
    return tuple(out)


def _packed_shape(t: int, bits: int, group: int) -> Tuple[int, int, torch.dtype]:
    """(row width, scales per row, dtype) of a packed store whose logical
    width is ``t``: int8 (T, 1, int8); int4 (Tg / 2, Tg / group, uint8)."""
    if bits == 8:
        return t, 1, torch.int8
    if bits != 4:
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    if group <= 0 or group % 32:
        raise ValueError(f"int4 group must be a positive multiple of 32, got {group}")
    tg = common.round_up(t, group)
    return tg // 2, tg // group, torch.uint8


def _check_packed(q: torch.Tensor, docs: torch.Tensor, scale: torch.Tensor, bits: int,
                  group: int, lead: Tuple[int, ...]) -> None:
    """Shapes and dtypes of a query (B, T) against a packed store
    ``lead + (C,)`` and its scales ``lead + (S,)``."""
    if q.dim() != 2:
        raise ValueError(f"want q (B, T), got {tuple(q.shape)}")
    width, n_scales, dtype = _packed_shape(q.shape[1], bits, group)
    if tuple(docs.shape) != lead + (width,) or tuple(scale.shape) != lead + (n_scales,):
        raise ValueError(f"T {q.shape[1]}, bits {bits}, group {group}: want docs "
                         f"{lead + (width,)} and scale {lead + (n_scales,)}, got "
                         f"{tuple(docs.shape)} and {tuple(scale.shape)}")
    if docs.dtype != dtype or scale.dtype != torch.float32:
        raise TypeError(f"bits {bits}: want {dtype} docs and float32 scales, got "
                        f"{docs.dtype} and {scale.dtype}")
    if q.dtype not in _QUERY_DTYPES:
        raise TypeError(f"q must be one of {list(_QUERY_DTYPES)}, got {q.dtype}")


def fused_topk_quantized(
    q: torch.Tensor,          # (B, T) bf16 / f32
    docs: torch.Tensor,       # (N, T) int8 | (N, Tg/2) uint8 packed nibbles
    scale: torch.Tensor,      # (N, 1) | (N, Tg/group) f32
    depth: int,
    bits: int,
    group: int,
    filt: Optional[torch.Tensor] = None,  # (N,) | (B, N) keep bitmap
    n_docs: Optional[int] = None,         # rows >= n_docs never rank
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming top-``depth`` of ``q @ dequant(docs, scale).T`` (K4): the
    dequantization is fused into the score stage, so on the card only the
    packed store and its scales are read.  Same output contract, ``filt``
    and ``n_docs`` as :func:`fused_topk`."""
    _check_packed(q, docs, scale, bits, group, (docs.shape[0],))
    b, t = q.shape
    n = docs.shape[0]
    n_docs = n if n_docs is None else n_docs
    if not 0 < n_docs <= n:
        raise ValueError(f"n_docs {n_docs} outside (0, {n}]")
    if not 0 < depth <= n_docs:
        raise ValueError(f"depth {depth} outside (0, {n_docs}]")
    if filt is not None and tuple(filt.shape) not in ((n,), (b, n)):
        raise ValueError(f"filt must be ({n},) or ({b}, {n}), got {tuple(filt.shape)}")
    if common.on_cpu(q, docs, scale, filt):
        return ref.quantized_topk_ref(q, docs, scale, depth, bits, group, filt, n_docs)

    if not (q.is_contiguous() and docs.is_contiguous() and scale.is_contiguous()):
        raise ValueError("q, docs and scale must be contiguous")
    if n_docs >= common.BIG_ID:
        raise ValueError(f"n_docs {n_docs} >= {common.BIG_ID}, the empty-slot id")
    f_ptr, f_stride = None, 0
    if filt is not None:
        if filt.dtype not in (torch.bool, torch.uint8) or not filt.is_contiguous():
            raise TypeError("filt must be a contiguous bool or uint8 tensor")
        filt = filt.view(torch.uint8)
        f_ptr, f_stride = filt.data_ptr(), (n if filt.dim() == 2 else 0)

    sm_count = torch.cuda.get_device_properties(q.device).multi_processor_count
    bq, k, splits, tiles_per_split, _ = quantized_plan(q.dtype, bits, b, n_docs, depth, sm_count)
    part_s = torch.empty((splits, b, k), dtype=torch.float32, device=q.device)
    part_i = torch.empty((splits, b, k), dtype=torch.int32, device=q.device)
    out_s = torch.empty((b, depth), dtype=torch.float32, device=q.device)
    out_i = torch.empty((b, depth), dtype=torch.int32, device=q.device)
    common.launch(
        _qlib(), "fused_topk_quantized_launch", q.device, _QUERY_DTYPES[q.dtype], bits, bq,
        q.data_ptr(), docs.data_ptr(), scale.data_ptr(), f_ptr, f_stride, b, n_docs, t,
        docs.shape[1], group, scale.shape[1], depth, k, splits, tiles_per_split,
        common.row_alignment(docs), common.row_alignment(q), part_s.data_ptr(),
        part_i.data_ptr(), out_s.data_ptr(), out_i.data_ptr())
    fused_topk_quantized.launches += 1
    return out_s, out_i


fused_topk_quantized.launches = 0  # type: ignore[attr-defined]


def fused_topk_gathered_quantized(
    q: torch.Tensor,          # (B, T) bf16 / f32
    store: torch.Tensor,      # (N, T) int8 | (N, Tg/2) uint8 packed nibbles
    scale: torch.Tensor,      # (N, 1) | (N, Tg/group) f32
    row_ids: torch.Tensor,    # (B, R) int32 global ids; outside [0, n_docs) = padding
    depth: int,
    n_docs: int,
    bits: int,
    group: int,
    filt: Optional[torch.Tensor] = None,  # (B, R) keep bitmap aligned with row_ids
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-query top-``depth`` of ``q[b] . dequant(store[row_ids[b, r]])``
    over r (K5, quantized blockmax stage 2), ties to the lowest GLOBAL id;
    padding and -inf slots are (-inf, -1); an id that comes twice ranks
    twice.  Like :func:`fused_topk_gathered` it takes the whole packed store
    and the ids, and on the card reads each row and its scales by id (8
    lanes a row, in 8-byte units): no (B, R, ·) tensor exists."""
    _check_packed(q, store, scale, bits, group, (store.shape[0],))
    if row_ids.dim() != 2 or row_ids.shape[0] != q.shape[0]:
        raise ValueError(f"want row_ids (B, R), got {tuple(row_ids.shape)}")
    b, t = q.shape
    r = row_ids.shape[1]
    if not 0 < n_docs <= store.shape[0]:
        raise ValueError(f"n_docs {n_docs} outside (0, {store.shape[0]}]")
    if not 0 < depth <= r:
        raise ValueError(f"depth {depth} outside (0, {r}] (the candidate count)")
    if filt is not None and tuple(filt.shape) != (b, r):
        raise ValueError(f"filt must be ({b}, {r}), got {tuple(filt.shape)}")
    if common.on_cpu(q, store, scale, row_ids, filt):
        return ref.quantized_gathered_topk_ref(q, store, scale, row_ids, depth, n_docs, bits,
                                               group, filt)

    if not (q.is_contiguous() and store.is_contiguous() and scale.is_contiguous()):
        raise ValueError("q, store and scale must be contiguous")
    if row_ids.dtype != torch.int32:
        raise TypeError(f"row_ids must be int32, got {row_ids.dtype}")
    if n_docs >= common.BIG_ID:
        raise ValueError(f"n_docs {n_docs} >= {common.BIG_ID}, the padding id")
    if filt is not None:  # filtered rows take the id the kernel's range check drops
        row_ids = torch.where(filt != 0, row_ids, common.BIG_ID)
    row_ids = row_ids.contiguous()

    sm_count = torch.cuda.get_device_properties(q.device).multi_processor_count
    k, splits, rows_per_split = gathered_quantized_plan(bits, b, r, t, depth, sm_count)
    part_s = torch.empty((splits, b, k), dtype=torch.float32, device=q.device)
    part_i = torch.empty((splits, b, k), dtype=torch.int32, device=q.device)
    out_s = torch.empty((b, depth), dtype=torch.float32, device=q.device)
    out_i = torch.empty((b, depth), dtype=torch.int32, device=q.device)
    common.launch(
        _qlib(), "fused_topk_gathered_quantized_launch", q.device, _QUERY_DTYPES[q.dtype], bits,
        q.data_ptr(), store.data_ptr(), scale.data_ptr(), row_ids.data_ptr(), b, r, n_docs, t,
        store.shape[1], group, scale.shape[1], depth, k, splits, rows_per_split,
        common.row_alignment(store), part_s.data_ptr(), part_i.data_ptr(), out_s.data_ptr(),
        out_i.data_ptr())
    fused_topk_gathered_quantized.launches += 1
    return out_s, out_i


fused_topk_gathered_quantized.launches = 0  # type: ignore[attr-defined]
