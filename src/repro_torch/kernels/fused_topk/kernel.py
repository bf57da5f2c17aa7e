"""Wrapper of the fused streaming score -> top-k CUDA kernel
(``csrc/fused_topk.cu``; replaces ``repro/kernels/fused_topk/kernel.py::
fused_topk``).

Routing follows the tensors' device: on the CPU the plain version
(:func:`.ref.fused_topk_ref`) runs; on a CUDA device the kernel launches on
the current stream, or the call raises.  ``fused_topk.launches`` counts the
calls that launched on the card; each such call launches two CUDA kernels,
pass 1 (``fused_topk_partial``) and the merge (``fused_topk_merge``).
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


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = common.load_library("fused_topk")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fused_topk_plan.argtypes = [i, i, i, i, ctypes.POINTER(i)]
    lib.fused_topk_plan.restype = i
    lib.fused_topk_launch.argtypes = [
        i, i, p, p, p, ll, i, i, i, i, i, i, i, i, p, p, p, p, p]
    lib.fused_topk_launch.restype = i
    lib.fused_topk_error_string.argtypes = [i]
    lib.fused_topk_error_string.restype = ctypes.c_char_p
    return lib


def plan(b: int, n_docs: int, depth: int, sm_count: int) -> Tuple[int, int, int, int]:
    """The source's launch shape (``fused_topk_plan``): (queries per block,
    running-list width K, N-splits, doc tiles per split)."""
    out = (ctypes.c_int * 4)()
    if _lib().fused_topk_plan(b, n_docs, depth, sm_count, out) != 0:
        raise ValueError(f"depth {depth}: the running lists do not fit in shared memory")
    return tuple(out)


def _aligned(x: torch.Tensor) -> int:
    """1 if every row of the contiguous 2-D ``x`` starts 16-byte aligned."""
    return int(x.data_ptr() % 16 == 0 and x.shape[1] * x.element_size() % 16 == 0)


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
    devices = {q.device, docs.device} | ({filt.device} if filt is not None else set())
    if devices == {torch.device("cpu")}:
        return ref.fused_topk_ref(q, docs, depth, mode, filt, n_docs)
    if len(devices) != 1 or q.device.type != "cuda":
        raise ValueError(f"operands must all lie on the CPU or on one CUDA device, got {devices}")

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
    bq, k, splits, tiles_per_split = plan(b, n_docs, depth, sm_count)
    with torch.cuda.device(q.device):
        part_s = torch.empty((splits, b, k), dtype=torch.float32, device=q.device)
        part_i = torch.empty((splits, b, k), dtype=torch.int32, device=q.device)
        out_s = torch.empty((b, depth), dtype=torch.float32, device=q.device)
        out_i = torch.empty((b, depth), dtype=torch.int32, device=q.device)
        lib = _lib()
        err = lib.fused_topk_launch(
            code, bq, q.data_ptr(), docs.data_ptr(), f_ptr, f_stride, b, n_docs, t, depth,
            k, splits, tiles_per_split, _aligned(q) | _aligned(docs) << 1,
            part_s.data_ptr(), part_i.data_ptr(),
            out_s.data_ptr(), out_i.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        msg = lib.fused_topk_error_string(err).decode()
        raise RuntimeError(f"fused_topk launch failed: cudaError {err} ({msg})")
    fused_topk.launches += 1
    return out_s, out_i


fused_topk.launches = 0  # type: ignore[attr-defined]
