"""Dense MinHash collision counts: CUDA kernel, wrapper, plain version, and
the kernel-backed ``lsh_topk``."""
from repro_torch.kernels.lsh_match.kernel import lsh_match_scores
from repro_torch.kernels.lsh_match.ops import lsh_topk

__all__ = ["lsh_match_scores", "lsh_topk"]
