"""Wrapper of the dense cosine score kernel (K6): :func:`cosine_scores`
replaces ``repro/kernels/cosine_score/kernel.py::cosine_scores``, in
``csrc/cosine_score.cu``: split TF32 on ``mma.sync`` tensor cores, the body
of ``kernels/csrc/score_matmul.cuh`` that K7 runs too (its arithmetic is
emulated by ``tests/torch_parity.split_tf32x3_scores(q, docs, chunk=16)``).

Routing follows the tensors' device: on the CPU the plain version
(:mod:`.ref`) runs; on one CUDA device the kernel launches on the current
stream, or the call raises.  ``cosine_scores.launches`` counts the calls that
launched on the card (one CUDA kernel each).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import common
from repro_torch.kernels.cosine_score import ref


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    return common.bind("cosine_score", cosine_scores_launch=[p, p, p, p, i, i, i, i, i, p])


def cosine_scores(q: torch.Tensor, docs: torch.Tensor, inv_norm: torch.Tensor) -> torch.Tensor:
    """(B, N) f32 ``(q @ docs.T) * inv_norm`` for unit queries q (B, dim),
    raw documents docs (N, dim) and their inverse norms (N,); the norms are
    applied in the kernel's epilogue.  The kernel takes f32 only; on the CPU
    the plain version also takes bf16, products summed in f32."""
    if (q.dim() != 2 or docs.dim() != 2 or q.shape[1] != docs.shape[1]
            or tuple(inv_norm.shape) != (docs.shape[0],)):
        raise ValueError(f"want q (B, dim), docs (N, dim), inv_norm (N,), got {tuple(q.shape)}, "
                         f"{tuple(docs.shape)}, {tuple(inv_norm.shape)}")
    # The plain version sums any dtype in f32, as the reference does.
    if common.on_cpu(q, docs, inv_norm):
        return ref.cosine_scores_ref(q, docs, inv_norm)
    if {q.dtype, docs.dtype, inv_norm.dtype} != {torch.float32}:
        raise TypeError(f"q, docs and inv_norm must be float32, got {q.dtype}, {docs.dtype}, "
                        f"{inv_norm.dtype}")
    if not (q.is_contiguous() and docs.is_contiguous() and inv_norm.is_contiguous()):
        raise ValueError("q, docs and inv_norm must be contiguous")
    b, dim = q.shape
    n = docs.shape[0]
    out = torch.empty((b, n), dtype=torch.float32, device=q.device)
    common.launch(_lib(), "cosine_scores_launch", q.device, q.data_ptr(), docs.data_ptr(),
                  inv_norm.data_ptr(), out.data_ptr(), b, n, dim, common.row_alignment(q),
                  common.row_alignment(docs))
    cosine_scores.launches += 1
    return out


cosine_scores.launches = 0  # type: ignore[attr-defined]
