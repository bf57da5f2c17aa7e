"""Flat proximity-graph build and batched beam search (port of
``repro/core/graph.py``).

A single-layer Vamana-style navigable graph in place of a literal
multi-layer HNSW; every shape is static:

* Build: each row's exact top-``m`` cosine pool over all other rows (K1 f32
  through ``ops.cosine_topk``, in row chunks), Vamana's robust prune
  (``alpha``-slack occlusion) down to ``degree`` forward edges, then a
  sort-based reverse-edge pass that fills ``reverse_degree`` more slots
  (nearest sources first), and the entry points (the medoid, then strided
  rows).  The prune and the reverse pass are plain torch, as they are plain
  XLA in the reference.  :func:`build_graph_sharded` builds the same graph
  over a device mesh: the pools circulate the shards' row blocks around the
  ring, each step on K1 f32.

* Search: a batched best-first beam search of a fixed number of
  iterations.  Each query keeps two fixed-size lists: the traversal list
  (raw scores: masked nodes stay traversable, so the walk keeps its
  connectivity under a filter) and the result list (the filter applied, so
  masked nodes are never emitted), and a visited bitmap of (B, N) bits
  packed 32 to an int32 word (96 MB at B = 256 over 3M rows).  Each
  iteration's (B, beam * total_degree) neighbour block is scored by K3
  (``fused_topk_gathered``, f32) from the stored rows and the ids, so the
  gathered rows never exist.  On the card the whole traversal is one
  captured CUDA graph per shape and index (:data:`TRAVERSAL_CACHE`); on the
  CPU the same function runs eagerly, through the kernels' plain versions.

Tie order is the reference's kernel path (``use_kernel=True``): K3 returns
each block sorted by (score desc, id asc), and every top-k over the lists
is :func:`repro_torch.kernels.common.stable_topk` (``lax.top_k``'s order).
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from repro_torch.core.executables import ExecutableCache
from repro_torch.core.types import GraphConfig
from repro_torch.kernels.common import f32_matmul, stable_topk
from repro_torch.kernels.fused_topk import ops as fused

NO_EDGE = -1
_PRUNE_BLOCK = 4096  # rows robust-pruned per step: bounds the (nb, m, dim) candidate gather
_POOL_ROWS = 8192  # rows a K1 launch of the pools: its (splits, rows, K) partials stay small

# One captured traversal a (shape, knobs, index buffers), owned by the
# index's adjacency: its entries go when the adjacency is freed.  64 entries
# keep a segmented loop's traversals (one a segment and shape) resident.
TRAVERSAL_CACHE = ExecutableCache(capacity=64)


# --------------------------------------------------------------------------
# Build: candidate pools
# --------------------------------------------------------------------------


def _knn_pools(v: torch.Tensor, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n, m) exact top-``m`` cosine pools of every row over all other rows,
    ties to the lowest id.  Each chunk of rows runs K1 f32 at depth
    ``m + 1`` and drops the row's own id where it appears (else keeps the
    first ``m``): the other rows keep their order, which is the reference's
    tile-by-tile merge order."""
    n = v.shape[0]
    out_s = torch.empty((n, m), dtype=torch.float32, device=v.device)
    out_i = torch.empty((n, m), dtype=torch.int32, device=v.device)
    cols = torch.arange(m, device=v.device)
    for r0 in range(0, n, _POOL_ROWS):
        r1 = min(r0 + _POOL_ROWS, n)
        s, i = fused.cosine_topk(v, v[r0:r1], m + 1)
        own = i == torch.arange(r0, r1, dtype=torch.int32, device=v.device)[:, None]
        at = torch.where(own.any(dim=1), own.int().argmax(dim=1), m)  # m: not in the list
        pick = cols[None, :] + (cols[None, :] >= at[:, None]).long()
        out_s[r0:r1] = torch.gather(s, 1, pick)
        out_i[r0:r1] = torch.gather(i, 1, pick)
    return out_s, out_i


# --------------------------------------------------------------------------
# Build: Vamana robust prune
# --------------------------------------------------------------------------


def _prune_block(cand_s: torch.Tensor, cand_i: torch.Tensor, v_all: torch.Tensor, degree: int,
                 alpha: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Robust-prune one block of rows down to ``degree`` forward edges.

    Vamana's occlusion rule in cosine form (unit rows: d^2 / 2 = 1 - sim):
    after selecting s, candidate c is dropped when ``alpha * (1 - sim(s, c))
    <= (1 - sim(row, c))``."""
    nb = cand_i.shape[0]
    cvecs = v_all[cand_i.clamp_min(0).long()]  # (nb, m, dim)
    d_row = 1.0 - cand_s
    rows = torch.arange(nb, device=cand_s.device)
    alive = (cand_i >= 0) & (cand_s > -torch.inf)
    sel_s = torch.full((nb, degree), -torch.inf, dtype=torch.float32, device=cand_s.device)
    sel_i = torch.full((nb, degree), NO_EDGE, dtype=torch.int32, device=cand_s.device)
    for t in range(degree):
        score = torch.where(alive, cand_s, -torch.inf)
        j = torch.argmax(score, dim=1)  # the first maximum, as jnp.argmax
        best = score[rows, j]
        got = best > -torch.inf
        sel_i[:, t] = torch.where(got, cand_i[rows, j], NO_EDGE)
        sel_s[:, t] = torch.where(got, best, -torch.inf)
        sim_sel = f32_matmul(cvecs, cvecs[rows, j][:, :, None])[:, :, 0]  # (nb, m)
        occluded = alpha * (1.0 - sim_sel) <= d_row
        alive &= ~(occluded & got[:, None])
        alive[rows, j] = False
    return sel_s, sel_i


def _prune_all(cand_s: torch.Tensor, cand_i: torch.Tensor, v_all: torch.Tensor, degree: int,
               alpha: float) -> Tuple[torch.Tensor, torch.Tensor]:
    outs, outi = [], []
    for b0 in range(0, cand_i.shape[0], _PRUNE_BLOCK):
        b1 = b0 + _PRUNE_BLOCK
        s, i = _prune_block(cand_s[b0:b1], cand_i[b0:b1], v_all, degree, alpha)
        outs.append(s)
        outi.append(i)
    return torch.cat(outs, 0), torch.cat(outi, 0)


# --------------------------------------------------------------------------
# Build: reverse edges + entry points
# --------------------------------------------------------------------------


def _reverse_edges(fwd_i: torch.Tensor, fwd_s: torch.Tensor, n_total: int,
                   r_rev: int) -> torch.Tensor:
    """(n_total, r_rev) reverse adjacency from the forward lists: for every
    edge src -> dst, dst gains a slot pointing back at src; each node keeps
    its ``r_rev`` highest-scoring sources (ties by edge position).  A
    stable two-pass sort (by -score, then by dst), ranks within each dst by
    ``searchsorted``, and a scatter of the slots in range."""
    n, rf = fwd_i.shape
    dev = fwd_i.device
    src = torch.arange(n, dtype=torch.int32, device=dev)[:, None].expand(n, rf).reshape(-1)
    dst = fwd_i.reshape(-1)
    score = fwd_s.reshape(-1)
    ord1 = torch.sort(-score, stable=True).indices
    dst1 = torch.where(dst[ord1] >= 0, dst[ord1], n_total)
    sdst, ord2 = torch.sort(dst1, stable=True)
    ssrc = src[ord1[ord2]]
    rank = torch.arange(sdst.shape[0], device=dev) - torch.searchsorted(sdst, sdst, side="left")
    keep = (sdst < n_total) & (rank < r_rev)
    out = torch.full((n_total, r_rev), NO_EDGE, dtype=torch.int32, device=dev)
    out[sdst[keep].long(), rank[keep]] = ssrc[keep]
    return out


def _entry_points(v_all: torch.Tensor, n_entries: int) -> torch.Tensor:
    """The medoid (largest dot with the corpus mean), then strided seeds."""
    n = v_all.shape[0]
    mean = v_all.mean(dim=0)
    medoid = torch.argmax(f32_matmul(v_all, mean[:, None])[:, 0]).to(torch.int32)
    k = min(n_entries, n)
    stride = max(1, n // max(1, k))
    seeds = torch.arange(1, n_entries, dtype=torch.int32, device=v_all.device) * stride % max(n, 1)
    return torch.cat([medoid[None], seeds])


def build_graph(v: torch.Tensor, config: GraphConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-device graph build on ``v``'s device: (neighbors (N, R)
    int32, entry (entries,) int32)."""
    v = v.to(torch.float32).contiguous()
    n = v.shape[0]
    m = min(config.ef_construction, max(1, n - 1))
    cand_s, cand_i = _knn_pools(v, m)
    fwd_s, fwd_i = _prune_all(cand_s, cand_i, v, config.degree, config.alpha)
    del cand_s, cand_i
    rev = _reverse_edges(fwd_i, fwd_s, n, config.reverse_degree)
    return torch.cat([fwd_i, rev], dim=1), _entry_points(v, config.entries)


# --------------------------------------------------------------------------
# Build over a device mesh
# --------------------------------------------------------------------------


def _pool_step(rows: torch.Tensor, row_base: int, block: torch.Tensor, block_base: int,
               run_s: torch.Tensor, run_i: torch.Tensor, m: int):
    """Score ``rows`` (global ids from ``row_base``) against one block of
    rows (global ids from ``block_base``) on K1 f32 and merge each row's
    top ``m + 1`` of the block into its running top-``m`` pool, its own id
    masked out.  The merge keeps (score desc, global id asc), the order
    of :func:`_knn_pools` over the whole corpus, whatever the block order."""
    n, dev = rows.shape[0], rows.device
    out_s, out_i = torch.empty_like(run_s), torch.empty_like(run_i)
    depth = min(m + 1, block.shape[0])
    for r0 in range(0, n, _POOL_ROWS):
        r1 = min(r0 + _POOL_ROWS, n)
        s, i = fused.cosine_topk(block, rows[r0:r1], depth)
        gid = torch.where(i >= 0, i + block_base, NO_EDGE)
        own = gid == torch.arange(row_base + r0, row_base + r1, dtype=torch.int32,
                                  device=dev)[:, None]
        s = torch.where(own, -torch.inf, s)
        gid = torch.where(own, NO_EDGE, gid)
        cat_i, by_id = torch.sort(torch.cat([run_i[r0:r1], gid], dim=1), dim=1, stable=True)
        cat_s = torch.gather(torch.cat([run_s[r0:r1], s], dim=1), 1, by_id)
        top_s, pos = stable_topk(cat_s, m)
        out_s[r0:r1] = top_s
        out_i[r0:r1] = torch.where(top_s > -torch.inf, torch.gather(cat_i, 1, pos.long()),
                                   NO_EDGE)
    return out_s, out_i


def build_graph_sharded(v_local, config: GraphConfig, axes, n_total: int):
    """The graph build over a device mesh: ``v_local`` is the list of the
    shards' unit rows (flat order, each on its shard's device), and the
    result is each shard's adjacency rows (global neighbour ids) and the
    entry points, one copy a device, both lists.

    On one mesh axis the pools circulate the row blocks around the shard
    ring (``ppermute`` with ``perm = [(i, (i - 1) % S)]``: after step s a
    shard holds the block of shard ``flat + s``), each step a K1 f32 pass
    of the shard's rows over the block, merged by (score desc, global id
    asc); on several axes each shard scores its rows over the gathered
    corpus instead.  The prune reads candidate rows from the gathered
    corpus (the pools never need it, the prune does), and the reverse pass
    runs on the gathered forward lists, each shard keeping its slice.  The
    adjacency and entry points equal :func:`build_graph`'s."""
    from repro_torch.core import distributed

    n_shards = len(v_local)
    n_local = v_local[0].shape[0]
    devices = [x.device for x in v_local]
    v_local = [x.to(torch.float32).contiguous() for x in v_local]
    m = min(config.ef_construction, max(1, n_total - 1))

    def empty_pools(x):
        return (torch.full((x.shape[0], m), -torch.inf, device=x.device),
                torch.full((x.shape[0], m), NO_EDGE, dtype=torch.int32, device=x.device))

    pools = distributed.shard_map(empty_pools, devices, v_local)
    v_all = distributed.all_gather(v_local)
    v_alls = distributed.replicate(v_all, devices)
    if len(axes) == 1 and n_shards > 1:
        perm = [(i, (i - 1) % n_shards) for i in range(n_shards)]
        blocks = list(v_local)
        for step in range(n_shards):
            pools = distributed.shard_map(
                lambda rows, flat, block, pool: _pool_step(
                    rows, flat * n_local, block, ((flat + step) % n_shards) * n_local,
                    pool[0], pool[1], m),
                devices, v_local, range(n_shards), blocks, pools)
            if step + 1 < n_shards:
                blocks = distributed.ppermute(blocks, perm)
        del blocks
    else:
        pools = distributed.shard_map(
            lambda rows, flat, corpus, pool: _pool_step(rows, flat * n_local, corpus, 0,
                                                        pool[0], pool[1], m),
            devices, v_local, range(n_shards), v_alls, pools)
    fwd = distributed.shard_map(
        lambda pool, corpus: _prune_all(pool[0], pool[1], corpus, config.degree, config.alpha),
        devices, pools, v_alls)
    del pools
    fwd_i_all = distributed.all_gather([f[1] for f in fwd])
    fwd_s_all = distributed.all_gather([f[0] for f in fwd])
    rev_all = _reverse_edges(fwd_i_all, fwd_s_all, n_total, config.reverse_degree)
    rev = [distributed.move(rev_all.narrow(0, s * n_local, n_local), d)
           for s, d in enumerate(devices)]
    neighbors = distributed.shard_map(lambda f, r: torch.cat([f[1], r], dim=1), devices, fwd,
                                      rev)
    entry = _entry_points(v_all, config.entries)
    return neighbors, distributed.replicate(entry, devices)


# --------------------------------------------------------------------------
# Search: batched fixed-iteration beam traversal
# --------------------------------------------------------------------------


def _gather_bits(filt: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(B, m) keep bits at ``ids`` (-1 = invalid) from an (N,) or (B, N)
    bitmap."""
    safe = ids.clamp_min(0).long()
    bits = filt[safe] if filt.dim() == 1 else torch.gather(filt, 1, safe)
    return (bits != 0) & (ids >= 0)


def _dedup_block(ids: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Drop later duplicates inside one block (the first valid occurrence
    stays), so no id enters the lists twice in a round.  A stable sort of
    the valid ids (invalid slots as -1) puts each id's first occurrence
    first in its run; the rest of the run are the duplicates."""
    key, order = torch.sort(torch.where(valid, ids, NO_EDGE), dim=1, stable=True)
    dup = torch.zeros_like(valid)
    dup[:, 1:] = (key[:, 1:] == key[:, :-1]) & (key[:, 1:] >= 0)
    return valid & ~torch.zeros_like(valid).scatter(1, order, dup)


def _word_bit(ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The visited bitmap's word (int64) and bit (int32) of each id (-1
    read as 0): bit ``i & 31`` of word ``i >> 5``."""
    safe = ids.clamp_min(0)
    return (safe >> 5).long(), safe & 31


def _seen(visited: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    word, bit = _word_bit(ids)
    return ((torch.gather(visited, 1, word) >> bit) & 1) != 0


def _mark(visited: torch.Tensor, ids: torch.Tensor, valid: torch.Tensor) -> None:
    """Set the bits of the valid ids (the reference's scatter-max).  They
    are distinct and unset, so adding their bits is OR-ing them in; the
    other slots add 0."""
    word, bit = _word_bit(ids)
    ones = torch.bitwise_left_shift(torch.ones_like(bit), bit)
    visited.scatter_add_(1, word, torch.where(valid, ones, 0))


def _score_block(q: torch.Tensor, vectors: torch.Tensor, ids: torch.Tensor, valid: torch.Tensor,
                 n_docs: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact cosine scores of one id block through K3 in f32: (B, m) sorted
    by (score desc, id asc), invalid slots (-inf, -1)."""
    row_ids = torch.where(valid, ids, n_docs)
    return fused.fused_topk_gathered(q, vectors, row_ids, depth=ids.shape[1], n_docs=n_docs)


def _merge_topk(run_s, run_i, blk_s, blk_i, m: int):
    """Merge a scored block into running (., m) lists; also returns the
    positions picked, for what travels with the lists."""
    s = torch.cat([run_s, blk_s], dim=1)
    i = torch.cat([run_i, blk_i], dim=1)
    top_s, pos = stable_topk(s, m)
    return top_s, torch.gather(i, 1, pos.long()), pos.long()


def _traverse(vectors, neighbors, entry, q, filt, *, depth: int, ef: int, beam: int, iters: int,
              n_docs: int):
    """The traversal itself (no host synchronisation, so a CUDA graph can
    hold it): (result scores, result ids, scored rows), each (B, .)."""
    b = q.shape[0]
    n = vectors.shape[0]
    r = neighbors.shape[1]
    m = beam * r
    dev = q.device

    def padded(s, i, width):
        pad = width - s.shape[1]
        if pad > 0:
            return (torch.cat([s, torch.full((b, pad), -torch.inf, device=dev)], dim=1),
                    torch.cat([i, torch.full((b, pad), NO_EDGE, dtype=torch.int32, device=dev)],
                              dim=1))
        top_s, pos = stable_topk(s, width)
        return top_s, torch.gather(i, 1, pos.long())

    def masked(s, i):
        if filt is None:
            return s, i
        keep = _gather_bits(filt, i)
        return torch.where(keep, s, -torch.inf), torch.where(keep, i, NO_EDGE)

    visited = torch.zeros((b, (n + 31) // 32), dtype=torch.int32, device=dev)
    init_i = entry[None, :].to(torch.int32).expand(b, entry.shape[0])
    init_valid = _dedup_block(init_i, init_i < n_docs)
    init_s, init_ids = _score_block(q, vectors, init_i, init_valid, n_docs)
    _mark(visited, init_i, init_valid)

    cand_s, cand_i = padded(init_s, init_ids, ef)
    cand_f = torch.zeros((b, ef), dtype=torch.bool, device=dev)
    res_s, res_i = padded(*masked(init_s, init_ids), depth)
    scored = init_valid.sum(dim=1, dtype=torch.int32)
    fresh = torch.zeros((b, m), dtype=torch.bool, device=dev)

    for _ in range(iters):
        avail = torch.where(~cand_f & (cand_i >= 0), cand_s, -torch.inf)
        pick_s, pos = stable_topk(avail, beam)  # positions into the traversal list
        pos = pos.long()
        live = pick_s > -torch.inf  # (B, beam)
        frontier = torch.where(live, torch.gather(cand_i, 1, pos), NO_EDGE)
        cand_f = cand_f.scatter(1, pos, True)

        nbr = neighbors[frontier.clamp_min(0).long()].reshape(b, m)
        valid = (nbr >= 0) & live[:, :, None].expand(b, beam, r).reshape(b, m)
        valid = _dedup_block(nbr, valid & ~_seen(visited, nbr))
        blk_s, blk_i = _score_block(q, vectors, nbr, valid, n_docs)
        _mark(visited, nbr, valid)
        scored = scored + valid.sum(dim=1, dtype=torch.int32)

        # The expanded flags travel with the re-sort (new entries start
        # unexpanded): the positions the merge picked.
        cand_s, cand_i, fpos = _merge_topk(cand_s, cand_i, blk_s, blk_i, ef)
        cand_f = torch.gather(torch.cat([cand_f, fresh], dim=1), 1, fpos)

        mblk_s, mblk_i = masked(blk_s, blk_i)
        res_s, res_i, _ = _merge_topk(res_s, res_i, mblk_s, mblk_i, depth)

    res_s = torch.where(res_i >= 0, res_s, -torch.inf)
    return res_s, res_i, scored


def search_graph(vectors: torch.Tensor, neighbors: torch.Tensor, entry: torch.Tensor,
                 q: torch.Tensor, depth: int, *, ef: int, beam: int, iters: int, n_docs: int,
                 filt: Optional[torch.Tensor] = None, with_stats: bool = False):
    """Batched best-first beam search over the flat graph.

    Each of the ``iters`` iterations expands the best ``beam`` unexpanded
    traversal candidates, gathers their adjacency rows as one (B, beam * R)
    block, drops ids already visited or repeated, scores the block on K3,
    and merges both lists.  ``filt`` ((N,) or (B, N) bool keep bitmap)
    masks the result list only.  Returns (scores (B, depth), ids (B,
    depth)), and (B,) int32 scored-row counts with ``with_stats``.

    On a CUDA device the traversal is one CUDA graph, captured once per
    (B, depth, ef, beam, iters, mask layout) and index
    (:data:`TRAVERSAL_CACHE`); on the CPU it runs op by op.  Both launch K3
    at every iteration."""
    q = q.to(torch.float32).contiguous()
    knobs = dict(depth=depth, ef=ef, beam=beam, iters=iters, n_docs=n_docs)
    run = functools.partial(_traverse, **knobs)
    if q.is_cuda:
        resident, fed = (vectors, neighbors, entry), (q, filt)
        key = ("graph",) + tuple(sorted(knobs.items()))
        out = TRAVERSAL_CACHE.get(key, neighbors, lambda: run, resident, fed)(resident, fed)
    else:
        out = run(vectors, neighbors, entry, q, filt)
    return out if with_stats else out[:2]
