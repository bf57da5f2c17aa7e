"""Fused streaming score -> top-k: CUDA kernels, wrappers, plain versions."""
from repro_torch.kernels.fused_topk.kernel import (
    fused_topk,
    fused_topk_gathered,
    fused_topk_gathered_quantized,
    fused_topk_quantized,
)
from repro_torch.kernels.fused_topk import ops, ref

__all__ = ["fused_topk", "fused_topk_gathered", "fused_topk_quantized",
           "fused_topk_gathered_quantized", "ops", "ref"]
