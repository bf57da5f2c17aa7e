"""Fused streaming score -> top-k: CUDA kernel, wrapper, plain version."""
from repro_torch.kernels.fused_topk.kernel import fused_topk
from repro_torch.kernels.fused_topk import ops, ref

__all__ = ["fused_topk", "ops", "ref"]
