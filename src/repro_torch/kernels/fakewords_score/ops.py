"""Kernel-backed fake-words score matrices (port of
``repro/kernels/fakewords_score/ops.py``): the query operand is built as
``core.fakewords`` builds it, then :func:`.kernel.score_matmul` scores every
document.  ``repro_torch.core`` is imported lazily to avoid an import cycle."""
from __future__ import annotations

import torch

from repro_torch.kernels.fakewords_score.kernel import score_matmul


def classic_scores(index, q_tf: torch.Tensor, df_max_ratio: float = 1.0) -> torch.Tensor:
    """Kernel-backed drop-in for ``core.fakewords.classic_scores``: (B, N)
    f32, the bf16 query against the bf16 ``scored`` matrix."""
    from repro_torch.core import fakewords

    return score_matmul(fakewords.classic_query(index, q_tf, df_max_ratio), index.scored)


def dot_scores(index, q_tf: torch.Tensor, df_max_ratio: float = 1.0) -> torch.Tensor:
    """Kernel-backed drop-in for ``core.fakewords.dot_scores``: (B, N) f32,
    the int8 [u; -u] query against the int8 ``tf``, summed in int32."""
    from repro_torch.core import fakewords

    return score_matmul(fakewords.dot_query(index, q_tf, df_max_ratio, dtype=torch.int8),
                        index.tf)
