"""Paper-own config: fake-words ANN over a word2vec-scale corpus
(3M x 300, GoogleNews-sized)."""
from repro_torch.configs.common import ArchSpec, Cell
from repro_torch.core.types import FakeWordsConfig

CELLS = (
    Cell("ann_search", "ann_search", batch=256, extra={
        "n_docs": 2_999_808,  # 3M rounded to a 512-divisible doc count
        "dim": 300, "depth": 100, "k": 10,
    }),
)


def make_model(cell=None) -> FakeWordsConfig:
    return FakeWordsConfig(quantization=50, scoring="classic", df_max_ratio=1.0)


ARCH = ArchSpec(
    id="ann-word2vec",
    family="ann",
    make_model=make_model,
    cells=CELLS,
    source="paper §3 (word2vec GoogleNews 3M x 300)",
)
