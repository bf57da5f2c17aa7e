"""Lexical LSH ANN encoding (paper §2); port of ``repro/core/lexical_lsh.py``.

Each feature w_i is rounded to the first decimal place and tagged with its
feature index (e.g. w = {0.12, 0.43, 0.74} -> tokens ``1_0.1 2_0.4 3_0.7``),
optionally aggregated into n-grams, then passed through MinHash (Lucene's
MinHashFilter) into ``b`` buckets with ``h`` hash functions.  Token strings
are 32-bit token ids; a document's signature is a dense (h*b,) uint32 row
with a sentinel for empty buckets, and matching counts signature collisions
(the fused top-k kernel's ``lsh`` mode).

The signatures equal the reference's bit for bit.  torch has almost no
uint32 arithmetic, so the hashing runs on uint32 values held in int64, with
every product taken modulo 2**32 without overflowing int64; only the
finished signatures are ``torch.uint32``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.types import LexicalLshConfig, LshIndex
from repro_torch.kernels.fused_topk import ref as fused_ref

SENTINEL = fused_ref.LSH_SENTINEL  # empty bucket: never counts as a collision
_GOLDEN = 0x9E3779B9
_MASK = 0xFFFFFFFF
_ROWS_PER_CHUNK = 2**17  # bounds the (rows, m) int64 intermediates of encode


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for x in [0, 2**32), in int64 without overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def mix32(x: torch.Tensor) -> torch.Tensor:
    """splitmix32 finalizer on the low 32 bits of ``x``; int64 in
    [0, 2**32)."""
    x = x.to(torch.int64) & _MASK
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def hash_seeds(hashes: int, seed: int, device=None) -> torch.Tensor:
    """Per-hash-function seeds derived from ``seed``: (hashes,) int64."""
    base = _mul32(torch.arange(1, hashes + 1, dtype=torch.int64, device=device), _GOLDEN)
    return mix32(base + (seed & _MASK))


def to_uint32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> torch.uint32 with the same bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32).view(torch.uint32)


def tokenize(vectors: torch.Tensor, config: LexicalLshConfig) -> torch.Tensor:
    """Quantize + tag features -> (N, T) token ids (uint32 values in int64).

    The token of feature i with rounded value r = round(w_i, decimals)
    (half to even, like ``jnp.round``) hashes (i, r); n-grams combine ``n``
    adjacent feature tokens into one id."""
    codes = torch.round(vectors * float(10**config.decimals)).to(torch.int32)
    ucodes = (codes.to(torch.int64) + (1 << 16)) & _MASK  # distinct codes stay distinct
    feat = torch.arange(vectors.shape[-1], dtype=torch.int64, device=vectors.device)
    toks = mix32(_mul32(feat, _GOLDEN) + ucodes)
    for _ in range(config.ngram - 1):
        toks = mix32(_mul32(toks[..., :-1], _GOLDEN) ^ toks[..., 1:])
    return toks


def minhash_signatures(tokens: torch.Tensor, config: LexicalLshConfig) -> torch.Tensor:
    """MinHash tokens into (N, h*b) uint32 signatures.

    For hash function k every token gets hv = mix32(tok ^ seed_k); it lands
    in bucket hv % b, and the bucket keeps the smallest hv.  Empty buckets
    hold the sentinel."""
    n = tokens.shape[0]
    b = config.buckets
    seeds = hash_seeds(config.hashes, config.seed, tokens.device)
    sigs = []
    for k in range(config.hashes):
        hv = mix32(tokens ^ seeds[k])
        sig_k = torch.full((n, b), SENTINEL, dtype=torch.int64, device=tokens.device)
        sigs.append(sig_k.scatter_reduce_(1, hv % b, hv, "amin", include_self=True))
    return to_uint32(torch.cat(sigs, dim=-1))


def encode(vectors: torch.Tensor, config: LexicalLshConfig) -> torch.Tensor:
    """(N, m) vectors -> (N, h*b) uint32 signatures, in row chunks so that
    the int64 intermediates stay a few hundred MB at N = 3M.  The chunks are
    joined as int32 bits: uint32 tensors take few operations on CUDA."""
    return torch.cat([
        minhash_signatures(tokenize(vectors[i:i + _ROWS_PER_CHUNK], config), config)
        .view(torch.int32) for i in range(0, vectors.shape[0], _ROWS_PER_CHUNK)
    ]).view(torch.uint32)


def build(
    vectors: torch.Tensor, config: LexicalLshConfig, keep_vectors: bool = True,
) -> LshIndex:
    """Thin wrapper over :class:`repro_torch.core.builder.BuildPipeline`
    (MinHashTransform -> LshPostings -> rerank store), on the device of
    ``vectors``."""
    from repro_torch.core import builder

    bp = builder.make_build_pipeline(config, "exact" if keep_vectors else "none")
    return bp.build_local(vectors)


def match_scores(sig_q: torch.Tensor, sig_d: torch.Tensor) -> torch.Tensor:
    """(B, N) int32 collision counts: slots where the signatures agree and
    the query's is not the sentinel (tiled over documents)."""
    return fused_ref.scores_ref(sig_q, sig_d, "lsh").to(torch.int32)


def search(
    index: LshIndex, sig_q: torch.Tensor, queries: Optional[torch.Tensor], k: int = 10,
    depth: int = 100, rerank: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Signature-collision search (K2, or its plain version on the CPU),
    optionally reranked: a thin wrapper over
    :class:`repro_torch.core.pipeline.LshMatcher` + the exact rerank."""
    from repro_torch.core import pipeline as pl

    return pl.match_rerank(pl.LshMatcher(), index, sig_q, queries, k, depth, rerank)
