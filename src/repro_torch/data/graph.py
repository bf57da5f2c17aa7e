"""Synthetic graphs in CSR + a uniform neighbor sampler on the device (port
of ``repro/data/graph.py``).

Graphs are generated with power-law degrees (preferential-attachment-like)
to match Reddit / ogbn-products degree skew.  :func:`make_graph` is the
reference's numpy generator line for line (its float64 -> int64 cast
overflows for the smallest uniforms, a few hundred times in Reddit's 229M
draws, and the copy keeps that), so the CSR arrays, features and labels
are the reference's bit for bit; they are moved to the device at the end.
The sampler is the GraphSAGE with-replacement uniform sampler: for each
seed node it draws ``fanout`` uniform positions in [0, deg) and gathers
column ids from CSR; isolated nodes yield -1 padding.  It and the other
draws (:func:`batch_seeds`, :func:`make_molecule_batch`) run on the device
of their ``torch.Generator``; the reference's threefry draws are not
reproduced.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.index import _check_device


@dataclasses.dataclass(frozen=True)
class GraphConfig:
    n_nodes: int = 10_000
    n_edges: int = 200_000
    d_feat: int = 128
    n_classes: int = 41
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class CsrGraph:
    """Compressed sparse row adjacency + features + labels (tensors on one
    device)."""

    indptr: torch.Tensor   # (N+1,) int32
    indices: torch.Tensor  # (E,) int32 — neighbor ids
    feats: torch.Tensor    # (N, d_feat) float32
    labels: torch.Tensor   # (N,) int32

    @property
    def n_nodes(self) -> int:
        return self.indptr.shape[0] - 1

    @property
    def n_edges(self) -> int:
        return self.indices.shape[0]

    def edge_list(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(src, dst) int32 for full-batch message passing (dst = CSR row)."""
        deg = self.indptr[1:] - self.indptr[:-1]
        nodes = torch.arange(self.n_nodes, dtype=torch.int32, device=self.indptr.device)
        return self.indices, torch.repeat_interleave(nodes, deg, output_size=self.n_edges)


def make_graph(cfg: GraphConfig, device="cuda") -> CsrGraph:
    """Power-law multigraph: endpoint sampling ~ Zipf over node ids (hub
    formation), self-loops removed by +1 shift.  Built on the host (the
    reference's numpy, line for line), then moved to ``device``."""
    dev = _check_device(device)
    rng = np.random.default_rng(cfg.seed)
    a = 1.3
    u = rng.random(cfg.n_edges * 2).astype(np.float64)
    with np.errstate(invalid="ignore"):  # the reference's overflowing cast, kept
        ranks = np.floor(u ** (-1.0 / (a - 1.0))).astype(np.int64)
    nodes = np.minimum(ranks, cfg.n_nodes - 1).astype(np.int32)
    perm = rng.permutation(cfg.n_nodes).astype(np.int32)  # decorrelate hubs
    nodes = perm[nodes]
    src, dst = nodes[: cfg.n_edges], nodes[cfg.n_edges:]
    dst = np.where(src == dst, (dst + 1) % cfg.n_nodes, dst)
    # CSR by dst (incoming neighbors define the aggregation set).
    order = np.argsort(dst, kind="stable")
    src_s, dst_s = src[order], dst[order]
    counts = np.bincount(dst_s, minlength=cfg.n_nodes)
    indptr = np.zeros(cfg.n_nodes + 1, np.int32)
    np.cumsum(counts, out=indptr[1:])
    feats = rng.standard_normal((cfg.n_nodes, cfg.d_feat)).astype(np.float32)
    labels = rng.integers(0, cfg.n_classes, cfg.n_nodes).astype(np.int32)
    return CsrGraph(
        indptr=torch.from_numpy(indptr).to(dev),
        indices=torch.from_numpy(src_s).to(dev),
        feats=torch.from_numpy(feats).to(dev),
        labels=torch.from_numpy(labels).to(dev),
    )


def sample_neighbors(
    generator: torch.Generator,
    indptr: torch.Tensor,
    indices: torch.Tensor,
    seeds: torch.Tensor,   # (B,) node ids
    fanout: int,
) -> torch.Tensor:
    """(B, fanout) int32 uniform with-replacement samples of incoming
    neighbors; -1 where the node has no neighbors.  Pure gather."""
    s = seeds.long()
    start = indptr[s].long()              # (B,)
    deg = indptr[s + 1].long() - start    # (B,)
    u = torch.randint(0, 1 << 30, (s.shape[0], fanout), generator=generator,
                      device=seeds.device)
    pos = u % torch.clamp_min(deg, 1)[:, None]
    # an isolated node's slot may point one past the last edge: clamped (as
    # JAX clamps the gather), then masked
    nbr = indices[torch.clamp_max(start[:, None] + pos, indices.shape[0] - 1)]
    return torch.where(deg[:, None] > 0, nbr, -1).to(torch.int32)


def sample_two_hop(
    generator: torch.Generator,
    indptr: torch.Tensor,
    indices: torch.Tensor,
    seeds: torch.Tensor,
    fanouts: Tuple[int, int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """GraphSAGE 2-layer sampling: (B, f1) and (B, f1, f2) index blocks."""
    f1, f2 = fanouts
    nbr1 = sample_neighbors(generator, indptr, indices, seeds, f1)  # (B, f1)
    flat = torch.clamp_min(nbr1.reshape(-1), 0)
    nbr2 = sample_neighbors(generator, indptr, indices, flat, f2)
    nbr2 = torch.where((nbr1.reshape(-1) >= 0)[:, None], nbr2, -1)
    return nbr1, nbr2.reshape(seeds.shape[0], f1, f2)


def batch_seeds(generator: torch.Generator, n_nodes: int, batch: int) -> torch.Tensor:
    return torch.randint(0, n_nodes, (batch,), generator=generator, device=generator.device,
                         dtype=torch.int32)


def make_molecule_batch(
    generator: torch.Generator, batch: int, n_nodes: int, n_edges: int, d_feat: int,
    n_classes: int,
) -> dict:
    """Batch of small fixed-size random graphs (molecule cell), on the
    generator's device."""
    dev = generator.device

    def ints(high, shape):
        return torch.randint(0, high, shape, generator=generator, device=dev, dtype=torch.int32)

    return {
        "feats": torch.randn((batch, n_nodes, d_feat), generator=generator, device=dev),
        "src": ints(n_nodes, (batch, n_edges)),
        "dst": ints(n_nodes, (batch, n_edges)),
        "labels": ints(n_classes, (batch,)),
    }
