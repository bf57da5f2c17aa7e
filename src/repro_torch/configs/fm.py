"""fm [Rendle, ICDM'10]: 39 sparse fields, embed_dim=10, 2-way FM
interaction via the O(nk) sum-square trick."""
from repro_torch.configs.common import RECSYS_CELLS, ArchSpec
from repro_torch.models.recsys import RecsysConfig, TableSpec, criteo_row_counts

# Criteo-scale id spaces: 39 fields, ~33.6M total rows (power-law split —
# a few multi-million-row fields plus a long tail).
TABLE = TableSpec(criteo_row_counts(39, 33_554_432), 10)


def make_model(cell=None) -> RecsysConfig:
    return RecsysConfig(name="fm", model="fm", table=TABLE, nnz=1)


ARCH = ArchSpec(
    id="fm",
    family="recsys",
    make_model=make_model,
    cells=RECSYS_CELLS,
    optimizer="adamw",
    source="ICDM'10 (Rendle)",
)
