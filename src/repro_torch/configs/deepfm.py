"""deepfm [arXiv:1703.04247]: 39 sparse fields, embed_dim=10,
mlp=400-400-400, FM interaction (shared embeddings)."""
from repro_torch.configs.common import RECSYS_CELLS, ArchSpec
from repro_torch.models.recsys import RecsysConfig, TableSpec, criteo_row_counts

TABLE = TableSpec(criteo_row_counts(39, 33_554_432), 10)


def make_model(cell=None) -> RecsysConfig:
    return RecsysConfig(
        name="deepfm", model="deepfm", table=TABLE, nnz=1, mlp=(400, 400, 400)
    )


ARCH = ArchSpec(
    id="deepfm",
    family="recsys",
    make_model=make_model,
    cells=RECSYS_CELLS,
    optimizer="adamw",
    source="arXiv:1703.04247",
)
