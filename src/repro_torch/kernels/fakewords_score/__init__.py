"""Dense fake-words score matrix: CUDA kernel, wrapper, plain version, and
the kernel-backed ``classic_scores`` / ``dot_scores``."""
from repro_torch.kernels.fakewords_score.kernel import score_matmul
from repro_torch.kernels.fakewords_score.ops import classic_scores, dot_scores

__all__ = ["score_matmul", "classic_scores", "dot_scores"]
