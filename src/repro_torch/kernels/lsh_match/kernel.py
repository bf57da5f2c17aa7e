"""Wrapper of the dense MinHash collision-count kernel (K8):
:func:`lsh_match_scores` replaces ``repro/kernels/lsh_match/kernel.py::
lsh_match_scores``, in ``csrc/lsh_match.cu``.

Routing follows the tensors' device: on the CPU the plain version
(:mod:`.ref`) runs; on one CUDA device the kernel launches on the current
stream, or the call raises.  ``lsh_match_scores.launches`` counts the calls
that launched on the card (one CUDA kernel each).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import common
from repro_torch.kernels.lsh_match import ref


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    p, i, pi = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    return common.bind("lsh_match", lsh_match_plan=[i, i, i, i, pi],
                       lsh_match_scores_launch=[p, p, p, i, i, i, i, i, p])


def plan(b: int, n: int, s: int, sm_count: int) -> Tuple[int, int, int, int, int]:
    """The kernel's launch shape for B queries over N docs of S slots
    (``lsh_match_plan``, next to the shared-memory layout it depends on):
    (queries a block, N-splits, doc tiles a split, docs a tile, blocks an
    SM).  It needs the built library."""
    out = (ctypes.c_int * 5)()
    if _lib().lsh_match_plan(b, n, s, sm_count, out) != 0:
        raise ValueError(f"no plan for B={b}, N={n}, S={s}: empty, or S >= 2**24")
    return tuple(out)


def lsh_match_scores(sig_q: torch.Tensor, sig_d: torch.Tensor) -> torch.Tensor:
    """(B, N) int32 collision counts of uint32 signatures sig_q (B, S)
    against sig_d (N, S): slots that are equal and not the query-side
    sentinel 0xFFFFFFFF."""
    if sig_q.dim() != 2 or sig_d.dim() != 2 or sig_q.shape[1] != sig_d.shape[1]:
        raise ValueError(f"want sig_q (B, S) and sig_d (N, S), got {tuple(sig_q.shape)}, "
                         f"{tuple(sig_d.shape)}")
    if sig_q.dtype != torch.uint32 or sig_d.dtype != torch.uint32:
        raise TypeError(f"signatures must be uint32, got {sig_q.dtype} and {sig_d.dtype}")
    if common.on_cpu(sig_q, sig_d):
        return ref.lsh_match_scores_ref(sig_q, sig_d)
    if not (sig_q.is_contiguous() and sig_d.is_contiguous()):
        raise ValueError("sig_q and sig_d must be contiguous")
    b, s = sig_q.shape
    n = sig_d.shape[0]
    out = torch.empty((b, n), dtype=torch.int32, device=sig_q.device)
    common.launch(_lib(), "lsh_match_scores_launch", sig_q.device, sig_q.data_ptr(),
                  sig_d.data_ptr(), out.data_ptr(), b, n, s, common.row_alignment(sig_q),
                  common.row_alignment(sig_d))
    lsh_match_scores.launches += 1
    return out


lsh_match_scores.launches = 0  # type: ignore[attr-defined]
