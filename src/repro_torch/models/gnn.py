"""GraphSAGE (Hamilton et al. 2017) — mean aggregator, full-batch + sampled
(port of ``repro/models/gnn.py``).

Message passing is gather(src) → scatter-add(dst) → divide(degree):
``index_select`` + ``index_add_`` (the reference's take + segment_sum;
no Pallas kernel there, plain PyTorch here):

    h_neigh[v] = mean_{u in N(v)} h[u]
    h'[v]      = relu(W_self h[v] + W_neigh h_neigh[v])      (+ l2 normalize)

Three execution paths cover the assigned shapes:

* :func:`forward_full`    — whole-graph message passing (full_graph_sm /
  ogb_products), over edge slices of ``_EDGE_SLICE`` edges forward and
  backward: ogbn-products' whole (E, d) message block would take 24.7 GB
  at d 100 and 31.7 GB at d 128.
* :func:`forward_sampled` — GraphSAGE minibatch: dense (B, f1) / (B, f1, f2)
  sampled neighbor indices (``data/graph.py``'s sampler), -1 slots masked
  out of the mean (minibatch_lg).
* :func:`forward_batched` — a batch of G small graphs of n nodes as one
  graph of G·n nodes (node ids offset by g·n), with a mean-pool readout a
  graph (molecule; the reference's ``vmap``).

Trained node embeddings are the arbitrary dense vectors the paper indexes:
``examples/graph_embeddings_torch.py`` feeds them to the fake-words index.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

from repro_torch.core.index import _check_device
from repro_torch.models.params import Params, from_numpy, tree_map


@dataclasses.dataclass(frozen=True)
class SageConfig:
    name: str = "graphsage"
    n_layers: int = 2
    d_in: int = 602
    d_hidden: int = 128
    n_classes: int = 41
    aggregator: str = "mean"
    fanouts: Tuple[int, ...] = (25, 10)  # paper's sample_sizes, hop 1..L
    l2_normalize: bool = True
    dtype: Any = torch.float32

    def __post_init__(self):
        if self.aggregator != "mean":
            raise ValueError("only the mean aggregator is implemented")
        if len(self.fanouts) != self.n_layers:
            raise ValueError("need one fanout per layer")


def param_shapes(cfg: SageConfig) -> Params:
    shapes: Params = {}
    d_prev = cfg.d_in
    for layer in range(cfg.n_layers):
        shapes[f"layer{layer}"] = {
            "w_self": (d_prev, cfg.d_hidden),
            "w_neigh": (d_prev, cfg.d_hidden),
            "bias": (cfg.d_hidden,),
        }
        d_prev = cfg.d_hidden
    shapes["classifier"] = {"w": (d_prev, cfg.n_classes), "b": (cfg.n_classes,)}
    return shapes


def init_params(cfg: SageConfig, generator: Optional[torch.Generator] = None,
                device="cuda") -> Params:
    """Random parameters by the reference's rule: a matrix draws N(0, 1 /
    fan_in), a bias is zeros; f32, drawn in the tree's sorted order from
    ``generator`` (a ``torch.Generator`` on ``device``; seed 0 when None)."""
    dev = _check_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    def leaf(_, shape):
        if len(shape) == 2:
            w = torch.randn(shape, generator=generator, device=dev, dtype=torch.float32)
            return w.div_(math.sqrt(shape[0]))
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    return tree_map(leaf, param_shapes(cfg))


def params_from_numpy(tree: Params, cfg: SageConfig, device="cuda") -> Params:
    """The JAX package's parameter tree as the port's (f32, on ``device``).
    Raises unless the tree has exactly :func:`param_shapes`' leaves and
    shapes."""
    return from_numpy(tree, param_shapes(cfg), _check_device(device), torch.float32)


def _sage_combine(h_self, h_neigh, layer, last: bool, cfg: SageConfig):
    h = h_self @ layer["w_self"] + h_neigh @ layer["w_neigh"] + layer["bias"]
    if not last:
        h = torch.relu(h)
    if cfg.l2_normalize:
        h = h / torch.clamp_min(torch.linalg.vector_norm(h, dim=-1, keepdim=True), 1e-12)
    return h


# --------------------------------------------------------------------------
# Full-batch message passing
# --------------------------------------------------------------------------


# Edges a gather-scatter slice: its (slice, d) message block takes 4.3 GB at
# d 128, where ogbn-products' whole (E, d) block would take 31.7 GB.
_EDGE_SLICE = 1 << 23


def _gather_scatter(h: torch.Tensor, src: torch.Tensor, dst: torch.Tensor, n: int):
    """out[v] = sum of h[src[e]] over the edges e with dst[e] = v (n rows):
    ``index_select`` + ``index_add_``, one edge slice at a time."""
    out = torch.zeros((n, h.shape[1]), dtype=h.dtype, device=h.device)
    for a in range(0, src.shape[0], _EDGE_SLICE):
        out.index_add_(0, dst[a:a + _EDGE_SLICE], h.index_select(0, src[a:a + _EDGE_SLICE]))
    return out


class _SumAggregate(torch.autograd.Function):
    """The neighbour sum and its gradient, the transposed sum (grad_h[u] =
    sum of grad[dst[e]] over the edges e with src[e] = u), both over edge
    slices: autograd's own ``index_add`` keeps its (E, d) source for the
    backward, which at ogbn-products' size would hold 24.7 + 31.7 GB."""

    @staticmethod
    def forward(ctx, h, src, dst, n):
        ctx.save_for_backward(src, dst)
        ctx.n_in = h.shape[0]
        return _gather_scatter(h, src, dst, n)

    @staticmethod
    def backward(ctx, grad):
        src, dst = ctx.saved_tensors
        return _gather_scatter(grad.contiguous(), dst, src, ctx.n_in), None, None, None


def mean_aggregate(
    h: torch.Tensor, src: torch.Tensor, dst: torch.Tensor, num_nodes: int
) -> torch.Tensor:
    """h_neigh[v] = mean of h[src] over edges (src -> dst=v).

    ``index_select`` + ``index_add_`` over edge slices (:class:`_SumAggregate`);
    the degree is counted by the same scatter, so an isolated node gets 0
    (GraphSAGE's convention: an empty neighbourhood gives zeros)."""
    src, dst = src.long(), dst.long()
    agg = _SumAggregate.apply(h, src, dst, num_nodes)
    deg = torch.zeros(num_nodes, dtype=h.dtype, device=h.device).index_add_(
        0, dst, torch.ones(dst.shape[0], dtype=h.dtype, device=h.device))
    return agg / torch.clamp_min(deg, 1.0)[:, None]


def _layers_full(params, feats, src, dst, cfg: SageConfig) -> torch.Tensor:
    n = feats.shape[0]
    src, dst = src.long(), dst.long()
    h = feats.to(cfg.dtype)
    for layer in range(cfg.n_layers):
        h_neigh = mean_aggregate(h, src, dst, n)
        h = _sage_combine(h, h_neigh, params[f"layer{layer}"], layer == cfg.n_layers - 1, cfg)
    return h


def forward_full(
    params: Params, feats: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
    cfg: SageConfig,
) -> torch.Tensor:
    """feats: (N, d_in); src/dst: (E,) int -> logits (N, n_classes)."""
    h = _layers_full(params, feats, src, dst, cfg)
    return h @ params["classifier"]["w"] + params["classifier"]["b"]


def embeddings_full(params, feats, src, dst, cfg: SageConfig) -> torch.Tensor:
    """Node embeddings (pre-classifier) — the dense vectors the paper's ANN
    layer indexes."""
    return _layers_full(params, feats, src, dst, cfg)


# --------------------------------------------------------------------------
# Sampled minibatch (GraphSAGE alg. 2): dense neighbor blocks
# --------------------------------------------------------------------------


def forward_sampled(
    params: Params,
    feats: torch.Tensor,        # (N, d_in) full feature table
    batch_nodes: torch.Tensor,  # (B,) int
    nbr1: torch.Tensor,         # (B, f1) int — hop-1 samples of batch nodes
    nbr2: torch.Tensor,         # (B, f1, f2) int — hop-2 samples of nbr1
    cfg: SageConfig,
) -> torch.Tensor:
    """Two-layer sampled forward (fanouts f1, f2).  -1 indices = padding
    (isolated-node slots) and contribute zeros to the mean."""
    if cfg.n_layers != 2:
        raise ValueError("the sampled path implements the paper's 2-layer setting")

    def gather(table, idx):
        safe = idx.clamp_min(0)
        x = table.index_select(0, safe.reshape(-1).long()).reshape(*idx.shape, -1)
        return torch.where((idx >= 0)[..., None], x, 0.0).to(cfg.dtype)

    def masked_mean(x, idx):
        cnt = torch.sum(idx >= 0, dim=-1, keepdim=True).to(x.dtype)
        return torch.sum(x, dim=-2) / torch.clamp_min(cnt, 1.0)

    x_b = gather(feats, batch_nodes)          # (B, d)
    x_1 = gather(feats, nbr1)                 # (B, f1, d)
    x_2 = gather(feats, nbr2)                 # (B, f1, f2, d)

    # Layer 0: update batch nodes (from nbr1) and nbr1 nodes (from nbr2).
    l0 = params["layer0"]
    h_b = _sage_combine(x_b, masked_mean(x_1, nbr1), l0, False, cfg)
    h_1 = _sage_combine(x_1, masked_mean(x_2, nbr2), l0, False, cfg)
    # Layer 1: final update of batch nodes from updated nbr1.
    h = _sage_combine(h_b, masked_mean(h_1, nbr1), params["layer1"], True, cfg)
    return h @ params["classifier"]["w"] + params["classifier"]["b"]


# --------------------------------------------------------------------------
# Batched small graphs (molecule): one graph of G·n nodes + mean-pool readout
# --------------------------------------------------------------------------


def forward_batched(
    params: Params,
    feats: torch.Tensor,  # (G, n_nodes, d_in)
    src: torch.Tensor,    # (G, n_edges) int
    dst: torch.Tensor,    # (G, n_edges) int
    cfg: SageConfig,
) -> torch.Tensor:
    """Graph-level logits (G, n_classes): the G graphs' message passing as
    one graph of G·n nodes (graph g's ids offset by g·n: no edge crosses
    graphs), then a mean-pool readout a graph."""
    g, n = feats.shape[:2]
    off = (torch.arange(g, device=src.device, dtype=torch.int64) * n)[:, None]
    h = _layers_full(params, feats.reshape(g * n, -1), (src.long() + off).reshape(-1),
                     (dst.long() + off).reshape(-1), cfg)
    pooled = torch.mean(h.reshape(g, n, -1), dim=1)  # readout
    return pooled @ params["classifier"]["w"] + params["classifier"]["b"]


# --------------------------------------------------------------------------
# Losses
# --------------------------------------------------------------------------


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor, mask=None) -> torch.Tensor:
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - ll
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return torch.mean(nll)


def loss_full(params, feats, src, dst, labels, mask, cfg: SageConfig):
    return softmax_xent(forward_full(params, feats, src, dst, cfg), labels, mask)


def loss_sampled(params, feats, batch_nodes, nbr1, nbr2, labels, cfg: SageConfig):
    return softmax_xent(forward_sampled(params, feats, batch_nodes, nbr1, nbr2, cfg), labels)


def loss_batched(params, feats, src, dst, labels, cfg: SageConfig):
    return softmax_xent(forward_batched(params, feats, src, dst, cfg), labels)
