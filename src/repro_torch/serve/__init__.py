"""Serving: the batched ANN query service (sync, async micro-batching, the
epoch-keyed result cache, NRT refresh) and the LM's continuous-batching
decode engine (``engine``)."""
from repro_torch.serve.ann_service import AnnService, AnnServiceConfig  # noqa: F401
