"""Wrapper of the dense fake-words score kernel (K7):
:func:`score_matmul` replaces ``repro/kernels/fakewords_score/kernel.py::
score_matmul``, in ``csrc/fakewords_score.cu``.

Routing follows the tensors' device: on the CPU the plain version
(:mod:`.ref`) runs; on one CUDA device the kernel launches on the current
stream, or the call raises.  ``score_matmul.launches`` counts the calls that
launched on the card (one CUDA kernel each).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import common
from repro_torch.kernels.fakewords_score import ref

_MODES = {torch.bfloat16: 1, torch.int8: 2}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    return common.bind("fakewords_score", score_matmul_launch=[i, i, p, p, p, i, i, i, i, i, p])


def score_matmul(q: torch.Tensor, docs: torch.Tensor,
                 out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, N) ``q @ docs.T`` for q (B, T) and docs (N, T): bf16 operands
    accumulate in f32 (classic); int8 operands accumulate in int32 and are
    written as ``out_dtype`` (f32, the default, or int32; dot)."""
    if q.dim() != 2 or docs.dim() != 2 or q.shape[1] != docs.shape[1]:
        raise ValueError(f"want q (B, T) and docs (N, T), got {tuple(q.shape)}, "
                         f"{tuple(docs.shape)}")
    if q.dtype != docs.dtype or q.dtype not in _MODES:
        raise TypeError(f"q and docs must both be bf16 or both int8, got {q.dtype} and "
                        f"{docs.dtype}")
    if out_dtype not in (torch.float32, torch.int32) or (
            out_dtype == torch.int32 and q.dtype != torch.int8):
        raise TypeError(f"out_dtype {out_dtype} for {q.dtype} operands: f32, or int32 for int8")
    if common.on_cpu(q, docs):
        return ref.score_matmul_ref(q, docs, out_dtype)
    if not (q.is_contiguous() and docs.is_contiguous()):
        raise ValueError("q and docs must be contiguous")
    b, t = q.shape
    n = docs.shape[0]
    out = torch.empty((b, n), dtype=out_dtype, device=q.device)
    common.launch(_lib(), "score_matmul_launch", q.device, _MODES[q.dtype],
                  int(out_dtype == torch.int32), q.data_ptr(), docs.data_ptr(), out.data_ptr(),
                  b, n, t, common.row_alignment(q), common.row_alignment(docs))
    score_matmul.launches += 1
    return out


score_matmul.launches = 0  # type: ignore[attr-defined]
