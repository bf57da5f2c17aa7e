"""Plain PyTorch version of the MinHash collision counts (port of
``repro/kernels/lsh_match/ref.py``, the same math as
``core.lexical_lsh.match_scores``): what :func:`..kernel.lsh_match_scores`
runs for tensors on the CPU, and what the card's kernel is held against.
uint32 tensors have few operators in torch (and no CUDA indexing), so the
counts work on their int32 bits, where the sentinel 0xFFFFFFFF is -1."""
from __future__ import annotations

import torch

SENTINEL = 0xFFFFFFFF
_TILE_ELEMS = 2**27  # bound on the (B, tile, S) compare held at once


def lsh_match_scores_ref(sig_q: torch.Tensor, sig_d: torch.Tensor) -> torch.Tensor:
    """(B, N) int32: #{s : sig_q[b, s] == sig_d[n, s] != SENTINEL}."""
    qb, db = sig_q.view(torch.int32), sig_d.view(torch.int32)
    valid = (qb != -1)[:, None, :]
    tile = max(1, _TILE_ELEMS // max(1, qb.numel()))
    return torch.cat([
        ((qb[:, None, :] == db[None, i:i + tile, :]) & valid).sum(-1, dtype=torch.int32)
        for i in range(0, db.shape[0], tile)], dim=1)
