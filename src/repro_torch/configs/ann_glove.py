"""Paper-own config: fake-words ANN over a GloVe-Twitter-scale corpus
(1.2M x 300)."""
from repro_torch.configs.common import ArchSpec, Cell
from repro_torch.core.types import FakeWordsConfig

CELLS = (
    Cell("ann_search", "ann_search", batch=256, extra={
        "n_docs": 1_193_472,  # 1.2M rounded to a 512-divisible doc count
        "dim": 300, "depth": 100, "k": 10,
    }),
)


def make_model(cell=None) -> FakeWordsConfig:
    return FakeWordsConfig(quantization=50, scoring="classic", df_max_ratio=1.0)


ARCH = ArchSpec(
    id="ann-glove",
    family="ann",
    make_model=make_model,
    cells=CELLS,
    source="paper §3 (GloVe Twitter 1.2M x 300)",
)
