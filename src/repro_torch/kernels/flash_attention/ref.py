"""Plain PyTorch version of causal GQA attention (port of
``repro/kernels/flash_attention/ref.py``): what
:func:`..kernel.flash_attention` runs for tensors on the CPU, and what the
card's kernel is held against."""
from __future__ import annotations

import torch

from repro_torch.kernels.common import f32_matmul

_NEG_INF = -1e30
_TILE_ELEMS = 2**28  # bound on the f32 logits held at once (1 GiB)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal attention of q (B, Hq, S, D) over k, v (B, Hkv, S, D): the KV
    heads repeated to Hq, f32 logits ``scale * q k^T`` (scale 1/sqrt(D)),
    the upper triangle masked to -1e30, softmax, the product with v in f32,
    cast to ``q.dtype``.  Query rows are independent, so the logits are
    formed a block of heads and rows at a time (at most ``_TILE_ELEMS`` of
    them); the arithmetic is the reference's."""
    b, hq, s, d = q.shape
    group = hq // k.shape[1]
    kk = torch.repeat_interleave(k, group, dim=1)
    vv = torch.repeat_interleave(v, group, dim=1)
    scale = 1.0 / d**0.5
    out = torch.empty_like(q)
    heads = max(1, min(hq, _TILE_ELEMS // (b * s * s)))
    rows = max(1, min(s, _TILE_ELEMS // (b * heads * s)))
    key_pos = torch.arange(s, device=q.device)
    for h in range(0, hq, heads):
        kh, vh = kk[:, h:h + heads], vv[:, h:h + heads]
        for r in range(0, s, rows):
            qh = q[:, h:h + heads, r:r + rows]
            logits = scale * f32_matmul(qh, kh.transpose(-1, -2))
            row_pos = torch.arange(r, r + qh.shape[2], device=q.device)
            logits = torch.where(key_pos[None, :] <= row_pos[:, None], logits, _NEG_INF)
            probs = torch.softmax(logits, dim=-1)
            out[:, h:h + heads, r:r + rows] = f32_matmul(probs, vh).to(q.dtype)
    return out
