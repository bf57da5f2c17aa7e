"""Core ANN library: configs, index containers, build and search stages."""
from repro_torch.core.types import (  # noqa: F401
    BruteForceConfig,
    FakeWordsConfig,
    FakeWordsIndex,
    FlatIndex,
    KdTreeConfig,
    KdTreeIndex,
    LexicalLshConfig,
    LshIndex,
    SearchParams,
)
from repro_torch.core.index import AnnIndex, index_from_numpy  # noqa: F401
