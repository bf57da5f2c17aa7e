"""Core ANN library: configs, index containers, build and search stages,
and the segmented mutable index."""
from repro_torch.core.types import (  # noqa: F401
    BruteForceConfig,
    FakeWordsConfig,
    FakeWordsIndex,
    FlatIndex,
    KdTreeConfig,
    KdTreeIndex,
    LexicalLshConfig,
    LshIndex,
    QuantizedStore,
    SearchParams,
)
from repro_torch.core.index import AnnIndex, index_from_numpy  # noqa: F401
from repro_torch.core.pipeline import SearchPipeline  # noqa: F401
from repro_torch.core.builder import BuildPipeline, make_build_pipeline  # noqa: F401
from repro_torch.core.segments import (  # noqa: F401
    IndexWriter,
    SegmentedAnnIndex,
    TieredMergePolicy,
)
