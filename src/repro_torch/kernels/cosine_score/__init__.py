"""Dense cosine score matrix: CUDA kernel, wrapper, plain version, and the
kernel-backed exact ``cosine_topk``."""
from repro_torch.kernels.cosine_score.kernel import cosine_scores
from repro_torch.kernels.cosine_score.ops import cosine_topk

__all__ = ["cosine_scores", "cosine_topk"]
