"""xdeepfm [arXiv:1803.05170]: 39 sparse fields, embed_dim=10,
cin_layers=200-200-200, mlp=400-400, CIN interaction."""
from repro_torch.configs.common import RECSYS_CELLS, ArchSpec
from repro_torch.models.recsys import RecsysConfig, TableSpec, criteo_row_counts

TABLE = TableSpec(criteo_row_counts(39, 33_554_432), 10)


def make_model(cell=None) -> RecsysConfig:
    return RecsysConfig(
        name="xdeepfm",
        model="xdeepfm",
        table=TABLE,
        nnz=1,
        mlp=(400, 400),
        cin_layers=(200, 200, 200),
    )


ARCH = ArchSpec(
    id="xdeepfm",
    family="recsys",
    make_model=make_model,
    cells=RECSYS_CELLS,
    optimizer="adamw",
    source="arXiv:1803.05170",
)
