"""Causal GQA flash attention (forward): CUDA kernel, wrapper, plain
version, and ``causal_attention``."""
from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.kernels.flash_attention.ops import causal_attention

__all__ = ["flash_attention", "causal_attention"]
