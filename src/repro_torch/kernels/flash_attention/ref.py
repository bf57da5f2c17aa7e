"""Plain PyTorch versions of causal GQA attention (port of
``repro/kernels/flash_attention/ref.py``) and of its gradient: what the
wrappers of :mod:`..kernel` run for tensors on the CPU, and what the card's
kernels are held against."""
from __future__ import annotations

from typing import Iterator, Optional, Tuple

import torch

from repro_torch.kernels.common import f32_matmul

_NEG_INF = -1e30
_TILE_ELEMS = 2**28  # bound on the f32 logits held at once (1 GiB)


def _blocks(b: int, hq: int, s: int) -> Iterator[Tuple[int, int, int, int]]:
    """(h0, h1, r0, r1): the blocks of heads and query rows whose (B, heads,
    rows, S) f32 logits hold at most ``_TILE_ELEMS`` elements."""
    heads = max(1, min(hq, _TILE_ELEMS // (b * s * s)))
    rows = max(1, min(s, _TILE_ELEMS // (b * heads * s)))
    for h in range(0, hq, heads):
        for r in range(0, s, rows):
            yield h, min(h + heads, hq), r, min(r + rows, s)


def _causal(logits: torch.Tensor, r0: int) -> torch.Tensor:
    """The mask of a block of logits (..., rows, S) whose first row is r0:
    True where the key is at or before the row."""
    s = logits.shape[-1]
    key_pos = torch.arange(s, device=logits.device)
    row_pos = torch.arange(r0, r0 + logits.shape[-2], device=logits.device)
    return key_pos[None, :] <= row_pos[:, None]


def _forward(q, k, v, lse: Optional[torch.Tensor]) -> torch.Tensor:
    b, hq, s, d = q.shape
    group = hq // k.shape[1]
    kk = torch.repeat_interleave(k, group, dim=1)
    vv = torch.repeat_interleave(v, group, dim=1)
    scale = 1.0 / d**0.5
    out = torch.empty_like(q)
    for h0, h1, r0, r1 in _blocks(b, hq, s):
        logits = scale * f32_matmul(q[:, h0:h1, r0:r1], kk[:, h0:h1].transpose(-1, -2))
        logits = torch.where(_causal(logits, r0), logits, _NEG_INF)
        if lse is not None:
            lse[:, h0:h1, r0:r1] = torch.logsumexp(logits, dim=-1)
        probs = torch.softmax(logits, dim=-1)
        out[:, h0:h1, r0:r1] = f32_matmul(probs, vv[:, h0:h1]).to(q.dtype)
    return out


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal attention of q (B, Hq, S, D) over k, v (B, Hkv, S, D): the KV
    heads repeated to Hq, f32 logits ``scale * q k^T`` (scale 1/sqrt(D)),
    the upper triangle masked to -1e30, softmax, the product with v in f32,
    cast to ``q.dtype``.  Query rows are independent, so the logits are
    formed a block of heads and rows at a time (at most ``_TILE_ELEMS`` of
    them); the arithmetic is the reference's."""
    return _forward(q, k, v, None)


def attention_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(:func:`attention_ref`'s output, lse): lse (B, Hq, S) f32 is each
    row's ``logsumexp`` of its scaled, masked logits (natural log), which
    the backward recomputes the probabilities from."""
    b, hq, s, _ = q.shape
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    return _forward(q, k, v, lse), lse


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                      lse: torch.Tensor, dout: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients (dq, dk, dv) of :func:`attention_ref` given ``dout``,
    by the explicit formulas (not autograd), in f32 from the operands as
    given, each cast to its input's dtype:

      P = exp(scale q k^T - lse), 0 above the diagonal;
      Delta = rowsum(dout * out);
      dv = P^T dout;  dS = P * (dout v^T - Delta);
      dq = scale dS k;  dk = scale dS^T q;

    dk and dv summed over the query heads of each KV head.  The logits are
    formed in the forward's blocks of heads and rows, so no (B, Hq, S, S)
    tensor exists at once."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    group = hq // hkv
    kk = torch.repeat_interleave(k, group, dim=1)
    vv = torch.repeat_interleave(v, group, dim=1)
    scale = 1.0 / d**0.5
    delta = (dout.float() * out.float()).sum(-1)  # (B, Hq, S)
    dq = torch.empty_like(q)
    dk = torch.zeros((b, hq, s, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros((b, hq, s, d), dtype=torch.float32, device=q.device)
    for h0, h1, r0, r1 in _blocks(b, hq, s):
        qb, ob = q[:, h0:h1, r0:r1], dout[:, h0:h1, r0:r1]
        kb, vb = kk[:, h0:h1], vv[:, h0:h1]
        logits = scale * f32_matmul(qb, kb.transpose(-1, -2))
        p = torch.where(_causal(logits, r0), torch.exp(logits - lse[:, h0:h1, r0:r1, None]), 0.0)
        ds = p * (f32_matmul(ob, vb.transpose(-1, -2)) - delta[:, h0:h1, r0:r1, None])
        dq[:, h0:h1, r0:r1] = (scale * f32_matmul(ds, kb)).to(q.dtype)
        dk[:, h0:h1] += scale * f32_matmul(ds.transpose(-1, -2), qb)
        dv[:, h0:h1] += f32_matmul(p.transpose(-1, -2), ob)
    dk = dk.reshape(b, hkv, group, s, d).sum(2)
    dv = dv.reshape(b, hkv, group, s, d).sum(2)
    return dq, dk.to(k.dtype), dv.to(v.dtype)
