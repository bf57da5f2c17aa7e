"""Causal attention entry point (port of
``repro/kernels/flash_attention/ops.py``).  Routing is by device, as for
every wrapper of the port: the reference's ``use_kernel`` switch has no
counterpart."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal GQA attention (B, Hq, S, D): the flash kernel on a CUDA
    device, its plain version on the CPU."""
    return flash_attention(q, k, v)
