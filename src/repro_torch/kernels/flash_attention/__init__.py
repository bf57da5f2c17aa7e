"""Causal GQA flash attention: CUDA kernels (forward, and the backward that
the TPU kernel lacks), wrappers, plain versions, and ``causal_attention``."""
from repro_torch.kernels.flash_attention.kernel import (flash_attention, flash_attention_bwd,
                                                        flash_attention_fwd)
from repro_torch.kernels.flash_attention.ops import CausalAttention, causal_attention

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_bwd", "causal_attention",
           "CausalAttention"]
