"""Serving: the batched ANN query service (sync, async micro-batching, the
epoch-keyed result cache, NRT refresh)."""
from repro_torch.serve.ann_service import AnnService, AnnServiceConfig  # noqa: F401
