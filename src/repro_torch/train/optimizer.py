"""Optimizers: AdamW and Adafactor, plus schedules and clipping (port of
``repro/train/optimizer.py``).

Parameters, gradients and optimizer state are nested dicts of tensors
(the reference's pytrees; leaves in sorted-key order, JAX's flattening
order).  Updates run under ``torch.no_grad`` and write the parameters and
the state in place, leaf by leaf (a clipped gradient, a moment or an
update exists for one leaf at a time), and return them as the reference's
functions return their new trees.  The step arithmetic is f32 tensors, as
the reference's is: ``t``, the learning rate, ``b1 ** t`` / ``b2 ** t``
and Adafactor's ``beta2 = 1 - t ** -decay``.

Adafactor stores row / column second-moment factors for rank >= 2 leaves
(rank-general: a stacked (layers, ..., n, m) leaf keeps (layers, ..., n)
and (layers, ..., m)), O(n + m) instead of O(n m) state.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Tuple

import torch

Tree = Any


def tree_leaves(tree: Tree) -> List[torch.Tensor]:
    """The leaves of a nested dict, keys sorted at every level (JAX's
    flattening order)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    return fn(tree, *rest)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


# --------------------------------------------------------------------------
# Schedules
# --------------------------------------------------------------------------


def cosine_schedule(base_lr: float, warmup_steps: int, total_steps: int, min_ratio: float = 0.1
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Linear warm-up to ``base_lr`` over ``warmup_steps``, then a cosine
    decay to ``min_ratio * base_lr`` at ``total_steps``; f32 arithmetic on
    the step's device."""

    def lr(step) -> torch.Tensor:
        step = torch.as_tensor(step).to(torch.float32)
        warm = step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(_f32(math.pi).to(step.device)
                                                                  * prog))
        return base_lr * torch.where(step < warmup_steps, warm, cos)

    return lr


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in order) of each leaf's f32 sum of
    squares."""
    total = None
    for leaf in tree_leaves(tree):
        sq = torch.sum(torch.square(leaf.detach().float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)


def clip_by_global_norm(tree: Tree, max_norm: float) -> Tuple[Tree, torch.Tensor]:
    """(every leaf times min(1, max_norm / global norm), the global norm):
    new tensors, as the reference's."""
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    with torch.no_grad():
        return tree_map(lambda g: g * scale.to(g.dtype), tree), norm


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: Callable[[torch.Tensor], torch.Tensor] | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    max_grad_norm: float = 1.0

    def _lr(self, step: torch.Tensor) -> torch.Tensor:
        return self.lr(step) if callable(self.lr) else _f32(self.lr).to(step.device)


def adamw_init(params: Tree) -> Tree:
    """{"mu", "nu": f32 zeros like the parameters, "step": int32 0}, on the
    parameters' device."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    device = tree_leaves(params)[0].device
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Tree, state: Tree, params: Tree
                 ) -> Tuple[Tree, Tree, Dict[str, torch.Tensor]]:
    """One AdamW step with global-norm clipping (max_grad_norm); weight
    decay on leaves of rank >= 2 only.  Writes ``params`` and ``state`` in
    place; returns (params, state, {"grad_norm", "lr"})."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.max_grad_norm)
    step = state["step"] + 1
    t = step.to(torch.float32)
    lr = cfg._lr(step)
    bc1 = 1 - torch.pow(_f32(cfg.b1).to(t.device), t)
    bc2 = 1 - torch.pow(_f32(cfg.b2).to(t.device), t)

    def upd(g, mu, nu, p):
        g32 = (g * scale.to(g.dtype)).float()
        mu.mul_(cfg.b1).add_((1 - cfg.b1) * g32)
        nu.mul_(cfg.b2).add_((1 - cfg.b2) * g32 * g32)
        u = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
        if p.dim() >= 2:  # no decay on norms / biases
            u = u + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * u).to(p.dtype))

    tree_map(upd, grads, state["mu"], state["nu"], params)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}


# --------------------------------------------------------------------------
# Adafactor (factored second moments)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AdafactorConfig:
    lr: Callable[[torch.Tensor], torch.Tensor] | float = 1e-2
    decay: float = 0.8  # beta2 = 1 - t^-decay
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0

    def _lr(self, step: torch.Tensor) -> torch.Tensor:
        return self.lr(step) if callable(self.lr) else _f32(self.lr).to(step.device)


def _factored(shape) -> bool:
    return len(shape) >= 2


def adafactor_init(params: Tree) -> Tree:
    """{"v": per leaf {"vr", "vc"} (rank >= 2) or {"v"}, "step": int32 0}."""

    def leaf(p):
        z = lambda shape: torch.zeros(shape, dtype=torch.float32, device=p.device)  # noqa: E731
        if _factored(p.shape):
            return {"vr": z(p.shape[:-1]), "vc": z(p.shape[:-2] + p.shape[-1:])}
        return {"v": z(p.shape)}

    device = tree_leaves(params)[0].device
    return {"v": tree_map(leaf, params), "step": torch.zeros((), dtype=torch.int32,
                                                             device=device)}


def _map_with_state(fn, grads: Tree, v: Tree, params: Tree) -> None:
    """``fn(g, v_leaf, p)`` over the parameter tree's leaves; ``v_leaf`` is
    the parameter's state dict (the state tree is one level deeper)."""
    if isinstance(params, dict):
        for k in sorted(params):
            _map_with_state(fn, grads[k], v[k], params[k])
        return
    fn(grads, v, params)


@torch.no_grad()
def adafactor_update(cfg: AdafactorConfig, grads: Tree, state: Tree, params: Tree
                     ) -> Tuple[Tree, Tree, Dict[str, torch.Tensor]]:
    """One Adafactor step: factored second moments, update clipping (RMS(u)
    <= clip_threshold), optional decay on rank >= 2 leaves.  Writes
    ``params`` and ``state`` in place; returns (params, state, {"lr"})."""
    step = state["step"] + 1
    t = step.to(torch.float32)
    beta2 = 1.0 - torch.pow(t, -cfg.decay)
    lr = cfg._lr(step)

    def upd(g, v, p):
        g32 = g.float()
        g2 = g32 * g32 + cfg.eps
        if _factored(p.shape):
            v["vr"].copy_(beta2 * v["vr"] + (1 - beta2) * g2.mean(-1))
            v["vc"].copy_(beta2 * v["vc"] + (1 - beta2) * g2.mean(-2))
            denom = torch.clamp(v["vr"].mean(-1, keepdim=True), min=cfg.eps)
            u = g32 * torch.rsqrt(v["vr"] / denom)[..., None] * torch.rsqrt(v["vc"][..., None, :])
        else:
            v["v"].copy_(beta2 * v["v"] + (1 - beta2) * g2)
            u = g32 * torch.rsqrt(v["v"])
        rms = torch.sqrt(torch.mean(u * u) + 1e-30)
        u = u / torch.clamp(rms / cfg.clip_threshold, min=1.0)
        if cfg.weight_decay and p.dim() >= 2:
            u = u + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * u).to(p.dtype))

    _map_with_state(upd, grads, state["v"], params)
    state["step"] = step
    return params, state, {"lr": lr}


# --------------------------------------------------------------------------
# Uniform facade
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Optimizer:
    kind: str  # "adamw" | "adafactor"
    config: Any

    def init(self, params: Tree) -> Tree:
        return adamw_init(params) if self.kind == "adamw" else adafactor_init(params)

    def update(self, grads, state, params):
        if self.kind == "adamw":
            return adamw_update(self.config, grads, state, params)
        return adafactor_update(self.config, grads, state, params)


def adamw(**kw) -> Optimizer:
    return Optimizer("adamw", AdamWConfig(**kw))


def adafactor(**kw) -> Optimizer:
    return Optimizer("adafactor", AdafactorConfig(**kw))
