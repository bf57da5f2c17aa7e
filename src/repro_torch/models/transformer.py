"""Decoder-only transformer LM: GQA + RoPE + SwiGLU, optional interleaved
MoE (port of ``repro/models/transformer.py``).

Covers the five LM architectures of ``repro_torch.configs`` (phi3-mini /
medium, deepseek-coder, phi3.5-moe, llama4-maverick).  The parameters are
the reference's tree of tensors, leaf for leaf: every per-layer leaf has a
leading ``n_blocks`` axis (``layers``; or ``moe_layers`` and, with
``moe.period`` 2, ``dense_layers`` of (n_blocks, period - 1, ...)), so
:func:`params_from_numpy` carries the JAX package's parameters across
unchanged.  The layers run eagerly in a Python loop over that axis, each
stacked leaf split once a call (``torch.unbind``), so that its gradient is
one ``stack`` of the layers' and not a full-size add a layer.
:func:`forward` and :func:`loss_fn` are differentiable: with gradients
enabled each layer runs under activation checkpointing
(``torch.utils.checkpoint``, non-reentrant), as the reference wraps each
block in ``jax.checkpoint(..., nothing_saveable)``, so a layer keeps only
its input and is recomputed in the backward pass.  :func:`prefill` and
:func:`decode_step` run under ``torch.no_grad``.

Attention has one route.  Prefill and :func:`forward` start at position 0,
where causal attention is exactly what the flash-attention kernel K9
computes, so every layer calls
:func:`repro_torch.kernels.flash_attention.ops.causal_attention`: on the
card the kernel (which takes head dims 32, 64, 96 and 128 and raises for
any other), on the CPU its plain version; with gradients, K9's forward
that keeps each row's log-sum-exp and K9's backward kernel.  The reference's einsum /
blockwise switch (``attn_impl``, ``blockwise_q``, ``blockwise_kv``) and
``scan_unroll`` stay as config fields and choose nothing; its sharding
fields have no counterpart.  K9's plain version multiplies the
probabilities by V in f32 where the reference's einsum casts them to bf16
first, so bf16 results agree within K9's rule, not bit for bit.  Decode
attention (one query against the cache) has no kernel in the reference
and is plain torch here.

dtypes follow the reference: f32 parameters (``param_dtype``) cast to the
compute dtype at each use; ``rms_norm`` sums the variance in f32 and casts
its inverse to x's dtype before the products; ``rope`` takes its angles in
f32 and its bf16 x f32 products in f32; logits are f32.  MoE routing takes
the top-k with ties to the lowest expert (``stable_topk``, ``lax.top_k``'s
order) and dispatches by a stable sort with static capacity.

Decode runs against a (layers, B, T_max, Hkv, dh) KV cache, the
reference's layout; :func:`decode_step` writes its token's K and V into
the cache's tensors in place (the reference donates them).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.index import _check_device
from repro_torch.kernels.common import f32_matmul, stable_topk
from repro_torch.kernels.flash_attention import ops as fa_ops

Params = Dict[str, Any]
_NEG = -1e30  # the reference's masked logit


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 16
    top_k: int = 2
    d_ff: int = 6400
    period: int = 1  # an MoE layer every `period` layers
    capacity_factor: float = 1.25
    shared_expert: bool = False  # an always-active expert beside the routed ones


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str = "tiny"
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 256
    vocab: int = 1024
    head_dim: Optional[int] = None  # default d_model // n_heads
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    moe: Optional[MoEConfig] = None
    dtype: torch.dtype = torch.bfloat16  # compute / activation dtype
    param_dtype: torch.dtype = torch.float32
    # The reference's attention switch and analysis mode: kept so configs
    # carry across; every prefill and forward runs K9 (module docstring).
    attn_impl: str = "auto"
    blockwise_q: int = 1024
    blockwise_kv: int = 1024
    tie_embeddings: bool = False
    scan_unroll: bool = False

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def moe_period(self) -> int:
        return self.moe.period if self.moe else 0

    @property
    def n_blocks(self) -> int:
        if not self.moe:
            return self.n_layers
        if self.n_layers % self.moe.period:
            raise ValueError(f"n_layers {self.n_layers} is not a multiple of the MoE period "
                             f"{self.moe.period}")
        return self.n_layers // self.moe.period

    @property
    def dense_per_block(self) -> int:
        return 0 if not self.moe else self.moe.period - 1

    def param_count(self) -> Tuple[int, int]:
        """(total, active) parameter counts (active differs for MoE)."""
        d, dh = self.d_model, self.dh
        attn = d * (self.n_heads * dh) + 2 * d * (self.n_kv_heads * dh) + (self.n_heads * dh) * d
        dense_ffn = 3 * d * self.d_ff
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        norms = 2 * d
        if not self.moe:
            total = self.n_layers * (attn + dense_ffn + norms) + emb + d
            return total, total
        moe_ffn = 3 * d * self.moe.d_ff
        shared = moe_ffn if self.moe.shared_expert else 0
        router = d * self.moe.num_experts
        n_moe = self.n_blocks
        dense = (self.n_layers - n_moe) * (attn + dense_ffn + norms) + emb + d
        total = dense + n_moe * (attn + router + self.moe.num_experts * moe_ffn + shared + norms)
        active = dense + n_moe * (attn + router + self.moe.top_k * moe_ffn + shared + norms)
        return total, active


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------


def _dense_layer_shapes(cfg: TransformerConfig, d_ff: int) -> Dict[str, tuple]:
    d, dh = cfg.d_model, cfg.dh
    return {
        "ln1": (d,), "ln2": (d,),
        "wq": (d, cfg.n_heads * dh), "wk": (d, cfg.n_kv_heads * dh),
        "wv": (d, cfg.n_kv_heads * dh), "wo": (cfg.n_heads * dh, d),
        "w_gate": (d, d_ff), "w_up": (d, d_ff), "w_down": (d_ff, d),
    }


def _moe_layer_shapes(cfg: TransformerConfig) -> Dict[str, tuple]:
    d, m = cfg.d_model, cfg.moe
    shapes = {k: v for k, v in _dense_layer_shapes(cfg, m.d_ff).items()
              if m.shared_expert or not k.startswith("w_")}
    shapes.update({
        "router": (d, m.num_experts),
        "moe_gate": (m.num_experts, d, m.d_ff),
        "moe_up": (m.num_experts, d, m.d_ff),
        "moe_down": (m.num_experts, m.d_ff, d),
    })
    return shapes


def param_shapes(cfg: TransformerConfig) -> Params:
    """The parameter tree's shapes (tuples), the reference's tree."""
    nb = cfg.n_blocks
    shapes: Params = {"embed": (cfg.vocab, cfg.d_model), "final_ln": (cfg.d_model,)}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (cfg.d_model, cfg.vocab)
    if cfg.moe:
        if cfg.dense_per_block:
            shapes["dense_layers"] = {k: (nb, cfg.dense_per_block) + s
                                      for k, s in _dense_layer_shapes(cfg, cfg.d_ff).items()}
        shapes["moe_layers"] = {k: (nb,) + s for k, s in _moe_layer_shapes(cfg).items()}
    else:
        shapes["layers"] = {k: (nb,) + s for k, s in _dense_layer_shapes(cfg, cfg.d_ff).items()}
    return shapes


def tree_map(fn, tree: Params, prefix: str = "") -> Params:
    """``fn(dotted name, leaf)`` on every leaf of a nested dict, keys sorted
    (the JAX tree's flattening order)."""
    return {k: tree_map(fn, tree[k], f"{prefix}{k}.") if isinstance(tree[k], dict)
            else fn(prefix + k, tree[k]) for k in sorted(tree)}


def init_params(cfg: TransformerConfig, generator: Optional[torch.Generator] = None,
                device="cuda") -> Params:
    """Random parameters by the reference's rule: a leaf of rank >= 2 draws
    N(0, 1 / fan_in) with fan_in its second-to-last dimension (so the
    stacked (n_blocks, d) norms of the layers draw too), a rank-1 leaf
    (``final_ln``) is ones, ``embed`` draws N(0, 0.02^2).  Leaves are drawn
    in the tree's sorted order from ``generator`` (a ``torch.Generator`` on
    ``device``; seed 0 when None), in f32, then cast to ``param_dtype``."""
    dev = _check_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    def leaf(name, shape):
        if len(shape) < 2:
            return torch.ones(shape, dtype=cfg.param_dtype, device=dev)
        std = 0.02 if name == "embed" else 1.0 / math.sqrt(shape[-2])
        w = torch.randn(shape, generator=generator, device=dev, dtype=torch.float32)
        return w.mul_(std).to(cfg.param_dtype)

    return tree_map(leaf, param_shapes(cfg))


def params_from_numpy(tree: Params, cfg: TransformerConfig, device="cuda") -> Params:
    """The JAX package's parameter tree (numpy or JAX arrays, bfloat16 ones
    included) as the port's: the same leaves, on ``device``, in
    ``param_dtype``.  Raises unless the tree has exactly
    :func:`param_shapes`' leaves and shapes."""
    dev = _check_device(device)
    shapes = param_shapes(cfg)

    def walk(t, s, prefix):
        if set(t) != set(s):
            raise ValueError(f"parameter tree {prefix or 'root'} has keys {sorted(t)}, want "
                             f"{sorted(s)}")
        out = {}
        for k in sorted(s):
            if isinstance(s[k], dict):
                out[k] = walk(t[k], s[k], f"{prefix}{k}.")
                continue
            a = np.asarray(t[k])
            x = (torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
                 if a.dtype.name == "bfloat16" else torch.from_numpy(np.array(a)))
            if tuple(x.shape) != tuple(s[k]):
                raise ValueError(f"{prefix}{k}: shape {tuple(x.shape)}, want {s[k]}")
            out[k] = x.to(device=dev, dtype=cfg.param_dtype)
        return out

    return walk(tree, shapes, "")


def params_to_numpy(params: Params) -> Params:
    """The inverse of :func:`params_from_numpy`: numpy leaves (bf16 leaves
    widened to f32, which numpy lacks)."""
    return tree_map(lambda _, x: (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy(),
                     params)


# --------------------------------------------------------------------------
# Primitives
# --------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """The variance summed in f32, its inverse cast to x's dtype before the
    products (the reference's order)."""
    xf = x.float()
    var = (xf * xf).sum(-1) / x.shape[-1]
    inv = torch.rsqrt(var + eps)[..., None].to(x.dtype)
    return x * inv * w.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, dh); positions: (..., S).  Angles in f32; the products
    of a bf16 x with the f32 cos / sin are f32, cast back at the end."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., S, half)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def qkv(x, layer, cfg: TransformerConfig, positions):
    """The normalized x (B, S, d) projected to q (B, S, Hq, dh), k and v
    (B, S, Hkv, dh), q and k rotated to ``positions`` (B, S)."""
    b, s, _ = x.shape
    q = (x @ layer["wq"].to(x.dtype)).reshape(b, s, cfg.n_heads, cfg.dh)
    k = (x @ layer["wk"].to(x.dtype)).reshape(b, s, cfg.n_kv_heads, cfg.dh)
    v = (x @ layer["wv"].to(x.dtype)).reshape(b, s, cfg.n_kv_heads, cfg.dh)
    return rope(q, positions, cfg.rope_theta), rope(k, positions, cfg.rope_theta), v


def attention(x, layer, cfg: TransformerConfig, positions,
              kv: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None) -> torch.Tensor:
    """Causal self-attention of the normalized x (B, S, d) from position 0,
    through K9 (:func:`~repro_torch.kernels.flash_attention.ops.
    causal_attention`, which takes (B, H, S, D): q, k and v are transposed
    to it and the output back).  Query head h reads KV head h // group, the
    reference's GQA grouping and K9's.  ``kv``, when given, receives the
    layer's rotated K and its V (B, S, Hkv, dh): the prefill's cache
    entries (the reference's ``_layer_kv`` computes the same values a
    second time)."""
    b, s, _ = x.shape
    q, k, v = qkv(x, layer, cfg, positions)
    if kv is not None:
        kv.append((k, v))
    o = fa_ops.causal_attention(*(t.transpose(1, 2).contiguous() for t in (q, k, v)))
    return o.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.dh) @ layer["wo"].to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * (1 / (1 + exp(-x))), rounded to x's dtype after each operation,
    as ``jax.nn.silu`` computes it (``torch.sigmoid`` rounds once)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def swiglu(x, layer, prefix: str = "w") -> torch.Tensor:
    g = x @ layer[f"{prefix}_gate"].to(x.dtype)
    u = x @ layer[f"{prefix}_up"].to(x.dtype)
    return (silu(g) * u) @ layer[f"{prefix}_down"].to(x.dtype)


# --------------------------------------------------------------------------
# MoE: sort-based capacity dispatch (GShard-style, static shapes)
# --------------------------------------------------------------------------


def _moe_dispatch_group(xt, top_e, top_p, e: int, k: int, cap: int):
    """One sequence's dispatch.  xt: (S, d), top_e / top_p: (S, k).
    Returns (expert_in (E, C, d), st, slot, keep, sp): the (token, expert)
    pairs sorted by expert (a stable sort), the first ``cap`` of each expert
    kept in slot ``expert * cap + rank``; the rest go to a trash row that
    is dropped (their tokens pass the FFN by)."""
    s, d = xt.shape
    flat_e = top_e.reshape(-1).long()
    flat_t = torch.arange(s, device=xt.device).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)
    se, st, sp = flat_e[order], flat_t[order], top_p.reshape(-1)[order]
    counts = torch.bincount(se, minlength=e)
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(s * k, device=xt.device) - starts[se]
    keep = pos_in_e < cap
    slot = torch.where(keep, se * cap + pos_in_e, e * cap)
    buf = xt.new_zeros((e * cap + 1, d))
    buf[slot] = xt[st]
    return buf[: e * cap].reshape(e, cap, d), st, slot, keep, sp


def _route(x, layer, k: int):
    """(router logits f32, top_p renormalized, top_e) of x (B, S, d)."""
    router_logits = (x @ layer["router"].to(x.dtype)).float()
    top_p, top_e = stable_topk(torch.softmax(router_logits, dim=-1), k)
    return router_logits, top_p / top_p.sum(-1, keepdim=True), top_e


def moe_ffn(x: torch.Tensor, layer: Params, cfg: TransformerConfig,
            dropless: bool = False) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d).  Each sequence dispatches its own tokens
    (capacity = capacity_factor * S * k / E a sequence; S with
    ``dropless``, as decode runs it), a grouped SwiGLU over the stacked
    expert weights, and a weighted scatter-add back to token order."""
    m = cfg.moe
    b, s, d = x.shape
    e, k = m.num_experts, m.top_k
    cap = s if dropless else max(1, min(int(m.capacity_factor * s * k / e), s))
    _, top_p, top_e = _route(x, layer, k)
    groups = [_moe_dispatch_group(x[i], top_e[i], top_p[i], e, k, cap) for i in range(b)]
    expert_in = torch.stack([grp[0] for grp in groups])  # (B, E, C, d)
    g = torch.einsum("becd,edf->becf", expert_in, layer["moe_gate"].to(x.dtype))
    u = torch.einsum("becd,edf->becf", expert_in, layer["moe_up"].to(x.dtype))
    y = torch.einsum("becf,efd->becd", silu(g) * u, layer["moe_down"].to(x.dtype))
    y = y.reshape(b, e * cap, d)
    out = []
    for i, (_, st, slot, keep, sp) in enumerate(groups):
        contrib = torch.where(keep[:, None], y[i][slot.clamp_max(e * cap - 1)], 0.0)
        out.append(x.new_zeros((s, d)).index_add_(0, st, contrib * sp[:, None].to(x.dtype)))
    return torch.stack(out)


def moe_aux_loss(router_logits: torch.Tensor, top_e: torch.Tensor, e: int) -> torch.Tensor:
    """Load-balancing auxiliary loss (Switch / GShard): E * sum_e f_e * p_e."""
    p_mean = torch.softmax(router_logits.float(), dim=-1).mean(0)
    f = torch.nn.functional.one_hot(top_e[..., 0].long(), e).float().mean(0)
    return e * (f * p_mean).sum()


# --------------------------------------------------------------------------
# Forward / loss
# --------------------------------------------------------------------------


def _dense_layer(x, layer, cfg, positions, kv=None):
    x = x + attention(rms_norm(x, layer["ln1"], cfg.norm_eps), layer, cfg, positions, kv)
    return x + swiglu(rms_norm(x, layer["ln2"], cfg.norm_eps), layer)


def _moe_layer(x, layer, cfg, positions, dropless: bool = False, kv=None):
    """``dropless`` only on the decode path: the prefill keeps the
    training capacity, as the reference's does."""
    x = x + attention(rms_norm(x, layer["ln1"], cfg.norm_eps), layer, cfg, positions, kv)
    h = rms_norm(x, layer["ln2"], cfg.norm_eps)
    y = moe_ffn(h, layer, cfg, dropless=dropless)
    if cfg.moe.shared_expert:
        y = y + swiglu(h, layer)
    return x + y


def iter_layers(params: Params, cfg: TransformerConfig) -> Iterator[Tuple[bool, Params]]:
    """(is MoE, the layer's leaves) in layer order: per block its
    ``dense_per_block`` dense layers, then its MoE layer; the cache's
    layer index counts them in this order.  Each stacked leaf is split
    once (``unbind``; ``dense_layers`` on both of its stacked axes): the
    layers' leaves are views of it, and its gradient is one ``stack`` of
    theirs (indexing it a layer at a time would add a zero tensor of the
    whole stack's size into its gradient for every layer)."""
    if not cfg.moe:
        per = {k: v.unbind(0) for k, v in params["layers"].items()}
        for i in range(cfg.n_layers):
            yield False, {k: v[i] for k, v in per.items()}
        return
    dense = params.get("dense_layers")
    dense = None if dense is None else {k: [blk.unbind(0) for blk in v.unbind(0)]
                                        for k, v in dense.items()}
    moe = {k: v.unbind(0) for k, v in params["moe_layers"].items()}
    for bi in range(cfg.n_blocks):
        if dense is not None:
            for j in range(cfg.dense_per_block):
                yield False, {k: v[bi][j] for k, v in dense.items()}
        yield True, {k: v[bi] for k, v in moe.items()}


def _embed(params, tokens, cfg) -> torch.Tensor:
    """The tokens' rows of ``embed`` in the compute dtype.  A gather, as the
    reference's indexing; ``embedding``'s backward sums the rows' gradients
    in a fixed order (indexing's, ``index_put_`` with accumulation, does
    not on several CPU threads), so that a step's gradients repeat bit for
    bit and a resumed run follows the uninterrupted one."""
    return torch.nn.functional.embedding(tokens.long(), params["embed"]).to(cfg.dtype)


def _head(params, x, cfg) -> torch.Tensor:
    """f32 logits of the final-normed x."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return (rms_norm(x, params["final_ln"], cfg.norm_eps) @ head.to(x.dtype)).float()


def _run_layers(params, x, cfg, kv=None) -> torch.Tensor:
    """The layers in order; with gradients enabled each under activation
    checkpointing (its input kept, its inside recomputed in the backward)."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    remat = torch.is_grad_enabled()
    for is_moe, layer in iter_layers(params, cfg):
        fn = _moe_layer if is_moe else _dense_layer
        if remat:
            x = checkpoint(fn, x, layer, cfg, positions, use_reentrant=False)
        else:
            x = fn(x, layer, cfg, positions, kv=kv)
    return x


def forward(params: Params, tokens: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    """tokens: (B, S) int -> logits (B, S, vocab) in f32; differentiable
    in the parameters."""
    return _head(params, _run_layers(params, _embed(params, tokens, cfg), cfg), cfg)


def loss_fn(params: Params, tokens: torch.Tensor, labels: torch.Tensor,
            cfg: TransformerConfig) -> torch.Tensor:
    """Mean next-token cross-entropy, differentiable in the parameters."""
    logits = forward(params, tokens, cfg)
    label_logit = logits.gather(-1, labels.long()[..., None])[..., 0]
    return (torch.logsumexp(logits, dim=-1) - label_logit).mean()


# --------------------------------------------------------------------------
# Serving: prefill + single-token decode against a KV cache
# --------------------------------------------------------------------------


@torch.no_grad()
def prefill(params: Params, tokens: torch.Tensor, cfg: TransformerConfig
            ) -> Tuple[Params, torch.Tensor]:
    """The full-sequence forward that also returns the KV cache
    {"k", "v": (n_layers, B, S, Hkv, dh), "length": S} and the
    last-position logits (B, vocab) f32."""
    kv: List[Tuple[torch.Tensor, torch.Tensor]] = []
    x = _run_layers(params, _embed(params, tokens, cfg), cfg, kv)
    cache = {"k": torch.stack([k for k, _ in kv]), "v": torch.stack([v for _, v in kv]),
             "length": tokens.shape[1]}
    return cache, _head(params, x[:, -1], cfg)


def _grouped(q, cache_k):
    """q (B, 1, Hq, dh) as (B, Hkv, group, dh), and the f32 logits
    (B, Hkv, group, T) of q against cache_k (B, T, Hkv, dh), scaled by
    1 / sqrt(dh): exact products, f32 sums (``preferred_element_type``)."""
    b, _, hq, dh = q.shape
    hkv = cache_k.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, dh)
    return qg, f32_matmul(qg, cache_k.permute(0, 2, 3, 1)) / math.sqrt(dh)


def _decode_attention(q, cache_k, cache_v, length) -> torch.Tensor:
    """q: (B, 1, Hq, dh); cache: (B, T, Hkv, dh); positions >= length masked."""
    b, _, hq, dh = q.shape
    _, logits = _grouped(q, cache_k)
    mask = torch.arange(cache_k.shape[1], device=q.device) < length
    probs = torch.softmax(torch.where(mask, logits, _NEG), dim=-1)
    out = f32_matmul(probs.to(cache_v.dtype), cache_v.permute(0, 2, 1, 3)).to(cache_v.dtype)
    return out.reshape(b, 1, hq * dh)


def _decode_attention_incremental(q, cache_k, cache_v, k_new, v_new, length) -> torch.Tensor:
    """Decode attention over the cache before this token's write, plus an
    explicit term for the token itself (exact: the softmax over
    [cache[< length], new])."""
    b, _, hq, dh = q.shape
    qg, logits = _grouped(q, cache_k)
    mask = torch.arange(cache_k.shape[1], device=q.device) < length  # strictly past
    logits = torch.where(mask, logits, _NEG)
    logit_new = f32_matmul(qg, k_new[:, 0, :, :, None])[..., 0] / math.sqrt(dh)  # (B, Hkv, g)
    m = torch.maximum(logits.amax(-1), logit_new)
    p = torch.exp(logits - m[..., None])
    p_new = torch.exp(logit_new - m)
    denom = p.sum(-1) + p_new
    acc = (f32_matmul(p.to(cache_v.dtype), cache_v.permute(0, 2, 1, 3))
           + p_new[..., None] * v_new[:, 0, :, None, :].float())
    return (acc / denom[..., None]).to(cache_v.dtype).reshape(b, 1, hq * dh)


@torch.no_grad()
def decode_step(params: Params, cache: Params, token: torch.Tensor, cfg: TransformerConfig
                ) -> Tuple[Params, torch.Tensor]:
    """One decode step: attend from position ``length``, write the token's K
    and V there (into ``cache``'s tensors, in place), return the cache with
    ``length`` + 1 and the next-token logits (B, vocab) f32.  Cache layout
    (L, B, T_max, Hkv, dh).  MoE layers dispatch dropless."""
    b = token.shape[0]
    length = int(cache["length"])
    kf, vf = cache["k"], cache["v"]
    x = _embed(params, token, cfg)[:, None, :]  # (B, 1, d)
    positions = torch.full((b, 1), length, dtype=torch.int32, device=x.device)
    for i, (is_moe, layer) in enumerate(iter_layers(params, cfg)):
        q, k, v = qkv(rms_norm(x, layer["ln1"], cfg.norm_eps), layer, cfg, positions)
        attn = _decode_attention_incremental(q, kf[i], vf[i], k, v, length)
        kf[i, :, length] = k[:, 0]
        vf[i, :, length] = v[:, 0]
        x = x + attn @ layer["wo"].to(x.dtype)
        h = rms_norm(x, layer["ln2"], cfg.norm_eps)
        if not is_moe:
            x = x + swiglu(h, layer)
            continue
        y = moe_ffn(h, layer, cfg, dropless=True)
        if cfg.moe.shared_expert:
            y = y + swiglu(h, layer)
        x = x + y
    return {"k": kf, "v": vf, "length": length + 1}, _head(params, x[:, 0], cfg)


def make_cache(cfg: TransformerConfig, batch: int, max_len: int, dtype=None,
               device="cuda") -> Params:
    """An empty (n_layers, batch, max_len, Hkv, dh) cache on ``device``."""
    dev = _check_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.dh)
    dtype = dtype or cfg.dtype
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev), "length": 0}
