"""dlrm-rm2 [arXiv:1906.00091]: 13 dense + 26 sparse fields, embed_dim=64,
bot_mlp=13-512-256-64, top_mlp=512-512-256-1, dot interaction."""
from repro_torch.configs.common import RECSYS_CELLS, ArchSpec
from repro_torch.models.recsys import RecsysConfig, TableSpec, criteo_row_counts

# RM-2 class tables: ~54M rows x 64 — the 13.8 GB table is the model.
TABLE = TableSpec(criteo_row_counts(26, 53_687_091), 64)


def make_model(cell=None) -> RecsysConfig:
    return RecsysConfig(
        name="dlrm-rm2",
        model="dlrm",
        table=TABLE,
        nnz=1,
        n_dense=13,
        bot_mlp=(512, 256, 64),
        top_mlp=(512, 512, 256, 1),
    )


ARCH = ArchSpec(
    id="dlrm-rm2",
    family="recsys",
    make_model=make_model,
    cells=RECSYS_CELLS,
    optimizer="adamw",
    source="arXiv:1906.00091",
)
