"""Block upper-bound pruning, the WAND / BlockMax-WAND analogue (port of
``repro/core/blockmax.py``).

Documents are grouped into fixed-size blocks; each block stores per-term
upper bounds.  At query time

  1. every block's bound is scored against the query (a small product,
     (B, n_blocks)): optimistic block scores;
  2. the ``n_keep`` best blocks are kept (a stable sort: ties keep the lower
     block id, like ``lax.top_k``);
  3. the kept blocks' rows are scored exactly by the gathered fused top-k
     kernel (:func:`repro_torch.kernels.fused_topk.fused_topk_gathered`),
     which reads each row by id: the (B, R, T) gathered rows never exist.

Bounds per scoring mode:

  * classic: ub[b, t] = max over the block of the ``scored`` entry
    (non-negative); bound = q_tf @ ub.T.  Admissible.
  * dot: signed per-term doc values s = tf+ - tf- can be negative, so the
    bound stores [max(s); max(-s)] per block and is q_tf @ ub.T (the
    sign-split query is [relu(u); relu(-u)]).
  * lsh: bit (v & 31) of ub[b, s] is set iff some doc of block b holds
    MinHash value v in slot s; the bound counts the query slots whose bit
    is present (a superset test, admissible).

With packed int8 / int4 postings (``pq``) the classic and dot bounds are
block maxima of the DEQUANTIZED values (per-doc and per-group scales vary
inside a block, so the max does not commute with the dequant), and stage 2
scores the kept rows through the quantized gathered kernel
(:func:`repro_torch.kernels.fused_topk.fused_topk_gathered_quantized`).

Classic stage 2 scores the query as ``q_tf`` in bf16 WITHOUT the df-prune
keep mask, as the reference does; it agrees with the dense classic match
at ``df_max_ratio = 1.0`` (ROADMAP.md §C).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from repro_torch.core import fakewords, lexical_lsh
from repro_torch.core.types import FakeWordsIndex, LshIndex, QuantizedPostings
from repro_torch.kernels import common
from repro_torch.kernels.fused_topk import ops

AnyBlockIndex = Union[FakeWordsIndex, LshIndex]

_BLOCKS_PER_CHUNK = 1024  # bounds the int64 intermediates of the lsh bitmap build
_BOUND_CHUNK_ELEMS = 2**25  # bounds the (B, blocks, S) intermediate of lsh bounds


@dataclasses.dataclass(frozen=True)
class BlockMaxIndex:
    """Per-block upper bounds, block = ``block_size`` consecutive docs.

    classic: (n_blocks, 2m) max of the bf16 scored matrix;
    dot:     (n_blocks, 2m) [max(s); max(-s)] of the int8 s = tf+ - tf-;
    lsh:     (n_blocks, S) uint32 per-slot presence bitmaps.

    The classic and dot maxima are held widened to f32 (exact: they are
    bf16 and int8 values), the stage-1 product's operand.  ``dequantized``
    marks maxima of a packed store's dequantized f32 values: dot bounds are
    then not integers.
    """

    ub: torch.Tensor
    block_size: int
    mode: str = "classic"
    dequantized: bool = False

    @property
    def num_blocks(self) -> int:
        return self.ub.shape[0]


def _block_reduce_max(x: torch.Tensor, block_size: int, pad_value=0) -> torch.Tensor:
    n, t = x.shape
    n_pad = (-n) % block_size
    if n_pad:
        x = torch.cat([x, torch.full((n_pad, t), pad_value, dtype=x.dtype, device=x.device)])
    return torch.amax(x.reshape(-1, block_size, t), dim=1)


def _dequantized_f32(pq: QuantizedPostings) -> torch.Tensor:
    """The f32 values the score stage multiplies, per element: int8 ``q *
    scale`` (an exact f32 product); int4 the canonical dequant cast to bf16
    (the kernel's operand), widened to f32.  Block maxima of these bound the
    quantized scores."""
    if pq.bits == 8:
        return pq.q.to(torch.float32) * pq.scale
    return common.dequant_int4(pq.q, pq.scale, pq.group, torch.bfloat16)[:, : pq.cols].float()


def _or_reduce_rows(x: torch.Tensor) -> torch.Tensor:
    """Bitwise OR over dim 1 of (blocks, rows, S) int64, by halving."""
    while x.shape[1] > 1:
        if x.shape[1] % 2:
            x = torch.cat([x, torch.zeros_like(x[:, :1])], dim=1)
        half = x.shape[1] // 2
        x = x[:, :half] | x[:, half:]
    return x[:, 0]


def _lsh_block_bitmap(sig: torch.Tensor, block_size: int) -> torch.Tensor:
    """(n_blocks, S) uint32 presence bitmaps, built a chunk of blocks at a
    time (the per-row bits are int64: torch has no uint32 shifts)."""
    n, s = sig.shape
    bits32 = sig.view(torch.int32)
    rows = _BLOCKS_PER_CHUNK * block_size
    out = []
    for i in range(0, n, rows):
        v = bits32[i:i + rows].to(torch.int64) & 0xFFFFFFFF
        bits = torch.where(v != lexical_lsh.SENTINEL, 1 << (v & 31), 0)
        n_pad = (-bits.shape[0]) % block_size  # padded rows hold the sentinel: no bit
        if n_pad:
            bits = torch.cat([bits, bits.new_zeros((n_pad, s))])
        out.append(_or_reduce_rows(bits.reshape(-1, block_size, s)))
    return lexical_lsh.to_uint32(torch.cat(out))


def build_blockmax(
    index: AnyBlockIndex, block_size: int = 256, mode: Optional[str] = None,
) -> BlockMaxIndex:
    """Per-block upper bounds for a fake-words or LSH index.  ``mode``
    defaults to "lsh" for an LshIndex, else "classic" when the index carries
    a ``scored`` matrix, or a packed store beside ``tf`` (dot int4 drops
    ``tf``; dot int8 has no packed store), and "dot" otherwise."""
    if isinstance(index, LshIndex) or mode == "lsh":
        return BlockMaxIndex(_lsh_block_bitmap(index.sig, block_size), block_size, "lsh")
    pq = index.pq
    if mode is None:
        classic = index.scored is not None or (pq is not None and index.tf is not None)
        mode = "classic" if classic else "dot"
    if mode == "classic":
        if pq is not None:
            ub = _block_reduce_max(_dequantized_f32(pq), block_size)
            return BlockMaxIndex(ub, block_size, "classic", dequantized=True)
        if index.scored is None:
            raise ValueError("classic blockmax requires the scored matrix")
        ub = _block_reduce_max(index.scored, block_size)
        return BlockMaxIndex(ub.to(torch.float32), block_size, "classic")
    if mode != "dot":
        raise ValueError(f"unknown blockmax mode {mode!r}")
    if pq is not None:
        deq = _dequantized_f32(pq)
        m = deq.shape[1] // 2
        s = deq[:, :m] - deq[:, m:]
    else:
        m = index.tf.shape[1] // 2
        s = (index.tf[:, :m].to(torch.int32) - index.tf[:, m:].to(torch.int32)).to(torch.int8)
    ub = torch.cat([_block_reduce_max(s, block_size), _block_reduce_max(-s, block_size)], dim=-1)
    return BlockMaxIndex(ub.to(torch.float32), block_size, "dot", dequantized=pq is not None)


def block_bounds(bm: BlockMaxIndex, q: torch.Tensor) -> torch.Tensor:
    """Stage 1: (B, n_blocks) f32 optimistic block scores.  ``q`` is the
    (B, 2m) tf row for classic and dot, the (B, S) uint32 signature for lsh.

    Classic and dot are f32 products with TF32 off (the classic query is
    rounded to bf16 first, as stage 2 scores it: exact products).  Dot
    bounds of an int8 ``tf`` are integers, exact in f32 while every partial
    sum stays below 2**24; dequantized dot bounds are f32 sums, as in the
    reference."""
    if bm.mode == "classic":
        return common.f32_matmul(q.to(torch.bfloat16), bm.ub.T)
    if bm.mode == "dot":
        if not bm.dequantized and bm.ub.shape[1] * 127 * 127 >= 2**24:
            raise ValueError(f"T = {bm.ub.shape[1]}: dot bounds would not be exact in f32")
        return common.f32_matmul(q, bm.ub.T)
    qb = q.view(torch.int32)
    shift = (qb & 31)[:, None, :]
    valid = (qb != -1)[:, None, :]
    ub = bm.ub.view(torch.int32)
    step = max(1, _BOUND_CHUNK_ELEMS // max(1, qb.numel()))
    # (x >> s) & 1 is bit s of x for an int32 too: the sign fill lies above it.
    return torch.cat([
        (((ub[None, i:i + step, :] >> shift) & 1) * valid).sum(-1, dtype=torch.int32)
        for i in range(0, bm.num_blocks, step)], dim=1).float()


def _stage2_operands(
    index: AnyBlockIndex, bm: BlockMaxIndex, q: torch.Tensor
) -> Tuple[torch.Tensor, Union[torch.Tensor, QuantizedPostings], str]:
    """(query operand, stored matrix to gather from, kernel mode).  With a
    packed store the matrix slot holds the :class:`QuantizedPostings` and
    the mode is "quantized": stage 2 reads packed rows and their scales and
    dequantizes in the score stage, with a bf16 query."""
    pq = getattr(index, "pq", None)
    if bm.mode == "classic":
        if pq is not None:
            return q.to(torch.bfloat16), pq, "quantized"
        return q.to(torch.bfloat16), index.scored, "gemm"
    if bm.mode == "dot":
        u = fakewords.signed_query(q)
        lifted = torch.cat([u, -u], dim=-1)
        if pq is not None:
            return lifted.to(torch.bfloat16), pq, "quantized"
        return lifted.to(torch.int8), index.tf, "gemm"
    return q, index.sig, "lsh"


def kept_rows(bm: BlockMaxIndex, q: torch.Tensor, n_keep: int) -> torch.Tensor:
    """Stages 1-2: the (B, n_keep * block_size) int32 row ids of each
    query's ``n_keep`` best blocks, in bound order (a stable sort, so ties
    keep the lower block id).  ``n_keep`` must not exceed the block count."""
    keep = torch.sort(block_bounds(bm, q), dim=-1, descending=True, stable=True).indices
    offsets = torch.arange(bm.block_size, dtype=torch.int64, device=q.device)
    rows = keep[:, :n_keep, None] * bm.block_size + offsets
    return rows.reshape(q.shape[0], -1).to(torch.int32)


def pruned_topk(
    index: AnyBlockIndex, bm: BlockMaxIndex, q: torch.Tensor, n_keep: int, depth: int,
    filt: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-stage blockmax search core: bound pass -> keep ``n_keep`` blocks ->
    exact scoring of their rows.  Returns (scores f32 (B, depth), ids int32
    (B, depth)), ties to the lowest doc id, so at n_keep = every block the
    ids equal the dense paths'.

    ``filt`` ((N,) or (B, N) bool, True = keep) masks stage 2 only, through
    the gathered (B, R) bitmap of the kept rows.  Stage 1's bounds stay
    unfiltered: filtering only removes docs, so an unfiltered block maximum
    is still an admissible bound, and at every block kept the filtered
    result equals the dense filtered search.

    ``n_keep`` is clamped to the block count and the kernel's depth to the
    gathered row count; the output is padded back to ``depth`` with
    (-inf, -1)."""
    n_keep = min(n_keep, bm.num_blocks)
    eff_depth = min(depth, n_keep * bm.block_size)
    b = q.shape[0]
    qv, mat, mode = _stage2_operands(index, bm, q)
    rows = kept_rows(bm, q, n_keep)
    if mode == "quantized":
        d_s, d_i = ops.postings_topk_gathered(mat, qv.contiguous(), rows, eff_depth,
                                              index.num_docs, filt=filt)
    else:
        d_s, d_i = ops.fused_topk_gathered(qv.contiguous(), mat, rows, eff_depth,
                                           index.num_docs, mode=mode,
                                           filt=ops.gather_filt(filt, rows, index.num_docs))
    if eff_depth < depth:
        pad = depth - eff_depth
        d_s = torch.cat([d_s, d_s.new_full((b, pad), -torch.inf)], dim=-1)
        d_i = torch.cat([d_i, d_i.new_full((b, pad), -1)], dim=-1)
    return d_s, d_i


def pruned_search(
    index: AnyBlockIndex, bm: BlockMaxIndex, q: torch.Tensor, n_keep: int, depth: int,
    filt: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The standalone form of :func:`pruned_topk` (the reference jits it;
    here the two are one computation, kept under both names)."""
    return pruned_topk(index, bm, q, n_keep, depth, filt=filt)
