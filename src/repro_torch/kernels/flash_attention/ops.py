"""Causal attention entry point (port of
``repro/kernels/flash_attention/ops.py``).  Routing is by device, as for
every wrapper of the port: the reference's ``use_kernel`` switch has no
counterpart.  With gradients asked for, the call goes through
:class:`CausalAttention`, whose backward is K9's backward kernel on the
card."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import (flash_attention, flash_attention_bwd,
                                                        flash_attention_fwd)


class CausalAttention(torch.autograd.Function):
    """Causal GQA attention with its gradient: the forward is
    :func:`flash_attention_fwd` (K9 with each row's log-sum-exp), saving q,
    k, v, the output and lse; the backward is :func:`flash_attention_bwd`
    (the three backward kernels on the card, the plain formulas on the
    CPU)."""

    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = flash_attention_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return flash_attention_bwd(q, k, v, out, lse, dout.contiguous())


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal GQA attention (B, Hq, S, D): the flash kernel on a CUDA
    device, its plain version on the CPU.  Where gradients are enabled and
    an input requires one, through :class:`CausalAttention` (the forward
    that keeps lse, then the backward kernel); otherwise the plain forward
    entry, as prefill and decode run it."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return CausalAttention.apply(q, k, v)
    return flash_attention(q, k, v)
