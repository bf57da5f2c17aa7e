"""RecSys towers: FM, DeepFM, DLRM (RM-2), xDeepFM over huge sparse tables
(port of ``repro/models/recsys.py``).

All categorical fields share ONE concatenated (total_rows, dim) table with
per-field row offsets (:class:`TableSpec`).  A bag lookup is
``index_select`` + a masked sum over a dense (B, F, nnz) index block
(:func:`embedding_bag_dense`, the path the forward passes take) or
``index_select`` + ``index_add_`` over a ragged (NNZ,) stream
(:func:`embedding_bag_ragged`); -1 ids of the dense block are padding.
The table's gradient is dense, as JAX's gradient of ``take`` is (a sparse
one would change what AdamW's decay and moments do to rows a batch does
not touch).

Feature interactions:
  * FM      — pairwise <v_i, v_j> x_i x_j via the sum-square trick
              0.5 * ((Σ v)² − Σ v²) (Rendle 2010).
  * DeepFM  — FM + shared-embedding MLP (400-400-400).
  * DLRM    — bottom MLP on 13 dense feats → dot interaction among 27
              vectors (upper triangle, row-major pairs) → top MLP.
  * xDeepFM — CIN (200-200-200) over the outer product, + DNN.

No op here has a Pallas kernel in the reference, so every one is plain
PyTorch, on the device of its operands.  ``retrieval_cand`` (1 query ×
10⁶ candidates) scores item embeddings by inner product: the arbitrary
dense vectors the paper indexes (``examples/recsys_retrieval_torch.py``
puts them through the fake-words index, K1 on the card).
:func:`retrieval_topk` keeps ``lax.top_k``'s order (``stable_topk``: ties
to the lowest id).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence, Tuple

import torch

from repro_torch.core.index import _check_device
from repro_torch.kernels.common import f32_matmul, stable_topk
from repro_torch.models.params import Params, from_numpy, tree_map

# --------------------------------------------------------------------------
# Table spec + EmbeddingBag
# --------------------------------------------------------------------------


def criteo_row_counts(n_fields: int, total_rows: int, alpha: float = 1.6) -> Tuple[int, ...]:
    """Deterministic power-law per-field row counts summing to ~total_rows
    (Criteo-like: a few huge id spaces, a long tail of small ones).  The
    total is padded up to a multiple of 512 so the concatenated table's rows
    shard evenly over any production mesh axis."""
    raw = [(i + 1) ** (-alpha) for i in range(n_fields)]
    s = sum(raw)
    counts = [max(4, int(total_rows * r / s)) for r in raw]
    counts[0] += (-sum(counts)) % 512
    return tuple(counts)


@dataclasses.dataclass(frozen=True)
class TableSpec:
    """One concatenated embedding table for all categorical fields."""

    row_counts: Tuple[int, ...]
    dim: int

    @property
    def n_fields(self) -> int:
        return len(self.row_counts)

    @property
    def total_rows(self) -> int:
        return sum(self.row_counts)

    @property
    def offsets(self) -> Tuple[int, ...]:
        out, acc = [], 0
        for c in self.row_counts:
            out.append(acc)
            acc += c
        return tuple(out)

    def globalize(self, idx: torch.Tensor) -> torch.Tensor:
        """Per-field local ids (B, F, ...) -> global row ids in the
        concatenated table (field axis must be axis 1)."""
        off = torch.tensor(self.offsets, dtype=idx.dtype, device=idx.device)
        return idx + off.reshape((1, self.n_fields) + (1,) * (idx.dim() - 2))


def embedding_bag_dense(
    table: torch.Tensor, idx: torch.Tensor, weights: Optional[torch.Tensor] = None,
    combine: str = "sum",
) -> torch.Tensor:
    """Fixed-nnz bag lookup: idx (B, F, nnz) global rows -> (B, F, dim).
    -1 indices are padding: one gather plus a dense masked reduction."""
    safe = idx.clamp_min(0)
    vecs = table.index_select(0, safe.reshape(-1).long()).reshape(*idx.shape, -1)
    mask = (idx >= 0)[..., None].to(vecs.dtype)
    if weights is not None:
        mask = mask * weights[..., None]
    out = torch.sum(vecs * mask, dim=-2)
    if combine == "mean":
        cnt = torch.sum(idx >= 0, dim=-1, keepdim=True).to(vecs.dtype)
        out = out / torch.clamp_min(cnt, 1.0)
    return out


def embedding_bag_ragged(
    table: torch.Tensor,
    values: torch.Tensor,    # (NNZ,) global row ids
    bag_ids: torch.Tensor,   # (NNZ,) target bag per value, in [0, n_bags)
    n_bags: int,
    weights: Optional[torch.Tensor] = None,
    combine: str = "sum",
) -> torch.Tensor:
    """Ragged EmbeddingBag: ``index_select`` + ``index_add_`` over
    ``bag_ids`` (the reference's take + segment_sum)."""
    vecs = table.index_select(0, values.long())  # (NNZ, dim)
    if weights is not None:
        vecs = vecs * weights[:, None]
    bags = bag_ids.long()
    out = torch.zeros((n_bags, vecs.shape[1]), dtype=vecs.dtype, device=vecs.device)
    out = out.index_add(0, bags, vecs)
    if combine == "mean":
        cnt = torch.zeros(n_bags, dtype=vecs.dtype, device=vecs.device).index_add_(
            0, bags, torch.ones_like(bags, dtype=vecs.dtype))
        out = out / torch.clamp_min(cnt, 1.0)[:, None]
    return out


# --------------------------------------------------------------------------
# Configs
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str = "fm"
    model: str = "fm"  # "fm" | "deepfm" | "dlrm" | "xdeepfm"
    table: TableSpec = dataclasses.field(
        default_factory=lambda: TableSpec(criteo_row_counts(39, 1_300_000), 10)
    )
    nnz: int = 1              # multi-hot width per field
    n_dense: int = 0          # dense (continuous) features (DLRM: 13)
    bot_mlp: Tuple[int, ...] = ()        # DLRM bottom MLP widths
    top_mlp: Tuple[int, ...] = ()        # DLRM top MLP widths (last = 1)
    mlp: Tuple[int, ...] = ()            # DeepFM / xDeepFM DNN widths
    cin_layers: Tuple[int, ...] = ()     # xDeepFM CIN feature-map counts
    dtype: Any = torch.float32
    param_dtype: Any = torch.float32

    @property
    def n_fields(self) -> int:
        return self.table.n_fields

    @property
    def dim(self) -> int:
        return self.table.dim

    def param_count(self) -> int:
        leaves = []
        tree_map(lambda _, s: leaves.append(math.prod(s)), param_shapes(self))
        return sum(leaves)


def _mlp_shapes(widths: Sequence[int], d_in: int, prefix: str) -> Params:
    shapes: Params = {}
    prev = d_in
    for i, w in enumerate(widths):
        shapes[f"{prefix}{i}"] = {"w": (prev, w), "b": (w,)}
        prev = w
    return shapes


def param_shapes(cfg: RecsysConfig) -> Params:
    f, d = cfg.n_fields, cfg.dim
    shapes: Params = {
        "table": (cfg.table.total_rows, d),
        "linear": (cfg.table.total_rows, 1),
        "bias": (1,),
    }
    if cfg.model == "fm":
        pass
    elif cfg.model == "deepfm":
        shapes.update(_mlp_shapes(cfg.mlp + (1,), f * d, "mlp"))
    elif cfg.model == "dlrm":
        shapes.pop("linear")
        shapes.update(_mlp_shapes(cfg.bot_mlp, cfg.n_dense, "bot"))
        n_vec = f + 1
        d_inter = n_vec * (n_vec - 1) // 2 + cfg.bot_mlp[-1]
        shapes.update(_mlp_shapes(cfg.top_mlp, d_inter, "top"))
    elif cfg.model == "xdeepfm":
        shapes.update(_mlp_shapes(cfg.mlp + (1,), f * d, "mlp"))
        prev_maps = f
        for i, h in enumerate(cfg.cin_layers):
            shapes[f"cin{i}"] = {"w": (prev_maps * f, h)}
            prev_maps = h
        shapes["cin_out"] = {"w": (sum(cfg.cin_layers), 1)}
    else:
        raise ValueError(cfg.model)
    return shapes


def init_params(cfg: RecsysConfig, generator: Optional[torch.Generator] = None,
                device="cuda") -> Params:
    """Random parameters by the reference's rule: a rank-1 leaf (biases) is
    zeros, any other draws N(0, 1 / s[0]) with s[0] its first dimension
    (the table's: its row count).  Leaves are drawn in the tree's sorted
    order from ``generator`` (a ``torch.Generator`` on ``device``; seed 0
    when None), in f32, then cast to ``param_dtype``."""
    dev = _check_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    def leaf(_, shape):
        if len(shape) == 1:
            return torch.zeros(shape, dtype=cfg.param_dtype, device=dev)
        w = torch.randn(shape, generator=generator, device=dev, dtype=torch.float32)
        return w.mul_(1.0 / math.sqrt(shape[0])).to(cfg.param_dtype)

    return tree_map(leaf, param_shapes(cfg))


def params_from_numpy(tree: Params, cfg: RecsysConfig, device="cuda") -> Params:
    """The JAX package's parameter tree as the port's: the same leaves, on
    ``device``, in ``param_dtype``.  Raises unless the tree has exactly
    :func:`param_shapes`' leaves and shapes."""
    return from_numpy(tree, param_shapes(cfg), _check_device(device), cfg.param_dtype)


# --------------------------------------------------------------------------
# Interactions
# --------------------------------------------------------------------------


def fm_interaction(emb: torch.Tensor) -> torch.Tensor:
    """emb (B, F, d) -> (B,) second-order FM term via the sum-square trick:
    0.5 * Σ_d ((Σ_i v_id)² − Σ_i v_id²) — O(F·d), not O(F²·d)."""
    s = torch.sum(emb, dim=1)          # (B, d)
    s2 = torch.sum(emb * emb, dim=1)   # (B, d)
    return 0.5 * torch.sum(s * s - s2, dim=-1)


def dot_interaction(vecs: torch.Tensor) -> torch.Tensor:
    """vecs (B, n, d) -> (B, n(n-1)/2) pairwise dots (upper triangle in
    row-major order, DLRM's interaction)."""
    n = vecs.shape[1]
    gram = torch.bmm(vecs, vecs.transpose(1, 2))
    iu, ju = torch.triu_indices(n, n, 1, device=vecs.device)
    return gram[:, iu, ju]


# Rows a CIN pass: the outer product holds B x H_{k-1} x F x d values (312 KB
# a row at xDeepFM's 200 maps, 39 fields, d 10), so a batch goes through in
# slices of this many rows (rows are independent): 5.1 GB a slice, where
# serve_bulk's 262,144 rows at once would take 81.8 GB.
_CIN_ROWS = 1 << 14


def _cin_rows(emb: torch.Tensor, params: Params, layer_maps: Sequence[int]) -> torch.Tensor:
    b, _, d = emb.shape
    x0 = emb
    xk = emb
    pooled = []
    for i, _h in enumerate(layer_maps):
        outer = torch.einsum("bid,bjd->bijd", xk, x0)  # (B, Hk-1, F, d)
        flat = outer.reshape(b, -1, d)                 # (B, Hk-1*F, d)
        xk = torch.einsum("bmd,mh->bhd", flat, params[f"cin{i}"]["w"])
        pooled.append(torch.sum(xk, dim=-1))           # (B, Hk)
    return torch.cat(pooled, dim=-1)


def cin(emb: torch.Tensor, params: Params, layer_maps: Sequence[int]) -> torch.Tensor:
    """Compressed Interaction Network (xDeepFM).  emb (B, F, d).

    x^k[h] = Σ_{i,j} W^k[h,(i,j)] * (x^{k-1}[i] ∘ x^0[j]); sum-pool each
    layer's maps over d and concatenate.  ``_CIN_ROWS`` rows at a time."""
    return torch.cat([_cin_rows(part, params, layer_maps) for part in emb.split(_CIN_ROWS)])


def mlp_apply(x: torch.Tensor, params: Params, n: int, prefix: str,
              final_act: bool = False) -> torch.Tensor:
    for i in range(n):
        p = params[f"{prefix}{i}"]
        x = x @ p["w"].to(x.dtype) + p["b"].to(x.dtype)
        if i < n - 1 or final_act:
            x = torch.relu(x)
    return x


# --------------------------------------------------------------------------
# Forward passes  (logits, pre-sigmoid)
# --------------------------------------------------------------------------


def _lookup(params: Params, cfg: RecsysConfig, sparse_idx: torch.Tensor) -> torch.Tensor:
    """sparse_idx: (B, F, nnz) local per-field ids -> (B, F, dim)."""
    gidx = cfg.table.globalize(sparse_idx)
    return embedding_bag_dense(params["table"].to(cfg.dtype), gidx)


def _linear_term(params: Params, cfg: RecsysConfig, sparse_idx: torch.Tensor) -> torch.Tensor:
    gidx = cfg.table.globalize(sparse_idx)
    w = embedding_bag_dense(params["linear"].to(cfg.dtype), gidx)  # (B, F, 1)
    return torch.sum(w[..., 0], dim=-1)


def forward(
    params: Params,
    cfg: RecsysConfig,
    sparse_idx: torch.Tensor,                  # (B, F, nnz) int, -1 pad
    dense_feats: Optional[torch.Tensor] = None,  # (B, n_dense) float
) -> torch.Tensor:
    """CTR logit (B,)."""
    emb = _lookup(params, cfg, sparse_idx)  # (B, F, d)
    b = emb.shape[0]

    if cfg.model == "fm":
        return params["bias"][0] + _linear_term(params, cfg, sparse_idx) + fm_interaction(emb)

    if cfg.model == "deepfm":
        y_fm = _linear_term(params, cfg, sparse_idx) + fm_interaction(emb)
        y_dnn = mlp_apply(emb.reshape(b, -1), params, len(cfg.mlp) + 1, "mlp")[:, 0]
        return params["bias"][0] + y_fm + y_dnn

    if cfg.model == "dlrm":
        if dense_feats is None:
            raise ValueError("dlrm needs dense_feats")
        x_bot = mlp_apply(dense_feats.to(cfg.dtype), params, len(cfg.bot_mlp), "bot",
                          final_act=True)  # (B, d)
        vecs = torch.cat([x_bot[:, None, :], emb], dim=1)  # (B, F+1, d)
        inter = torch.cat([dot_interaction(vecs), x_bot], dim=-1)
        return mlp_apply(inter, params, len(cfg.top_mlp), "top")[:, 0]

    if cfg.model == "xdeepfm":
        y_lin = _linear_term(params, cfg, sparse_idx)
        y_cin = (cin(emb, params, cfg.cin_layers) @ params["cin_out"]["w"])[:, 0]
        y_dnn = mlp_apply(emb.reshape(b, -1), params, len(cfg.mlp) + 1, "mlp")[:, 0]
        return params["bias"][0] + y_lin + y_cin + y_dnn

    raise ValueError(cfg.model)


def bce_loss(
    params: Params,
    cfg: RecsysConfig,
    sparse_idx: torch.Tensor,
    labels: torch.Tensor,
    dense_feats: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    logit = forward(params, cfg, sparse_idx, dense_feats)
    y = labels.to(torch.float32)
    z = logit.to(torch.float32)
    # numerically-stable BCE-with-logits
    return torch.mean(torch.clamp_min(z, 0) - z * y + torch.log1p(torch.exp(-torch.abs(z))))


# --------------------------------------------------------------------------
# Retrieval scoring (retrieval_cand): 1 query vs 10^6 candidates
# --------------------------------------------------------------------------


def retrieval_scores(user_vec: torch.Tensor, cand_table: torch.Tensor) -> torch.Tensor:
    """Batched f32 dot scoring (B, d) x (N_cand, d) -> (B, N_cand)."""
    return f32_matmul(user_vec, cand_table.T)


def retrieval_topk(
    user_vec: torch.Tensor, cand_table: torch.Tensor, k: int = 100
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores, int32 ids) of the top ``k`` candidates, ``lax.top_k``'s
    order: descending, ties to the lowest id."""
    return stable_topk(retrieval_scores(user_vec, cand_table), k)


def user_tower(
    params: Params, cfg: RecsysConfig, sparse_idx: torch.Tensor,
    dense_feats: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Query-side embedding for retrieval: mean of field embeddings (+ DLRM
    bottom-MLP dense vector when present)."""
    emb = _lookup(params, cfg, sparse_idx)
    u = torch.mean(emb, dim=1)
    if cfg.model == "dlrm" and dense_feats is not None:
        u = u + mlp_apply(dense_feats.to(cfg.dtype), params, len(cfg.bot_mlp), "bot",
                          final_act=True)
    return u
