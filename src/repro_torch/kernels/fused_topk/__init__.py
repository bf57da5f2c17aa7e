"""Fused streaming score -> top-k: CUDA kernels, wrappers, plain versions."""
from repro_torch.kernels.fused_topk.kernel import fused_topk, fused_topk_gathered
from repro_torch.kernels.fused_topk import ops, ref

__all__ = ["fused_topk", "fused_topk_gathered", "ops", "ref"]
