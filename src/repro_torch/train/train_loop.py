"""Train-step builder: grad accumulation, clipping, metrics, watchdog (port
of ``repro/train/train_loop.py``).

``build_train_step`` turns any ``loss_fn(params, batch) -> scalar`` into
``step(state, batch) -> (state, metrics)``:

  * microbatch accumulation in a Python loop (the reference's ``lax.scan``):
    the global batch stays constant while activation memory scales with
    1 / n_microbatches; f32 gradients summed in microbatch order, divided
    by ``n_microbatches`` at the end;
  * global-norm clipping and the optimizer update (``train/optimizer.py``),
    which write the parameters and the optimizer state in place;
  * loss / grad-norm / lr metrics.

``Watchdog`` is the host-side straggler monitor: per-step wall times feed
an EWMA; a step slower than ``threshold`` x EWMA is flagged.  Its clock is
a field, so a test can drive it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.train.optimizer import Optimizer, tree_leaves, tree_map

Tree = Any
LossFn = Callable[[Tree, Dict[str, torch.Tensor]], torch.Tensor]


@dataclasses.dataclass
class TrainState:
    """(params, opt_state, step): the reference's pytree children, in that
    order (the checkpoint's leaf order)."""

    params: Tree
    opt_state: Tree
    step: torch.Tensor


def make_train_state(params: Tree, opt: Optimizer) -> TrainState:
    device = tree_leaves(params)[0].device
    return TrainState(params=params, opt_state=opt.init(params),
                      step=torch.zeros((), dtype=torch.int32, device=device))


def build_train_step(loss_fn: LossFn, opt: Optimizer, n_microbatches: int = 1):
    """Returns ``step(state, batch)``.  ``batch`` is a dict of tensors with a
    leading global-batch axis divisible by ``n_microbatches``; microbatch i
    is rows [i b / n, (i + 1) b / n) (the reference's reshape)."""

    def grads_of(params, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        it = iter(grads)

        def grad_of(p):  # a leaf the loss does not use has a zero gradient, as in JAX
            g = next(it)
            return torch.zeros_like(p) if g is None else g

        return loss.detach(), tree_map(grad_of, params)

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        params = state.params
        if n_microbatches == 1:
            loss, grads = grads_of(params, batch)
        else:
            for x in batch.values():
                if x.shape[0] % n_microbatches:
                    raise ValueError(f"global batch {x.shape[0]} is not a multiple of "
                                     f"{n_microbatches} microbatches")
            loss = torch.zeros((), dtype=torch.float32, device=tree_leaves(params)[0].device)
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            for i in range(n_microbatches):
                mb = {k: x.reshape(n_microbatches, x.shape[0] // n_microbatches,
                                   *x.shape[1:])[i] for k, x in batch.items()}
                mb_loss, mb_grads = grads_of(params, mb)
                loss = loss + mb_loss
                tree_map(lambda acc, g: acc.add_(g), grads, mb_grads)
                del mb_grads
            loss = loss / n_microbatches
            tree_map(lambda g: g.div_(n_microbatches), grads)
        _, opt_state, info = opt.update(grads, state.opt_state, params)
        return TrainState(params, opt_state, state.step + 1), {"loss": loss, **info}

    return step


@dataclasses.dataclass
class Watchdog:
    """EWMA step-time straggler detector (host side); ``clock`` returns
    seconds (``time.monotonic`` unless a caller gives another)."""

    threshold: float = 2.0
    alpha: float = 0.1
    ewma: Optional[float] = None
    flagged: int = 0
    clock: Callable[[], float] = time.monotonic
    _t0: Optional[float] = None

    def start(self):
        self._t0 = self.clock()

    def stop(self, step: int, log=print) -> float:
        dt = self.clock() - self._t0
        if self.ewma is None:
            self.ewma = dt
        elif dt > self.threshold * self.ewma:
            self.flagged += 1
            log(f"[watchdog] step {step}: {dt * 1e3:.1f}ms > "
                f"{self.threshold:.1f}x EWMA {self.ewma * 1e3:.1f}ms — straggler")
        self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return dt
