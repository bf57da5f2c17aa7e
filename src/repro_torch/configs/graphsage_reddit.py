"""graphsage-reddit [arXiv:1706.02216]: 2 layers, d_hidden=128, mean
aggregator, sample_sizes=25-10.

The GNN shape cells pin the GRAPH, so feature/class dims come from the
cell (Cora / Reddit / ogbn-products / synthetic molecules); the
architecture (2x128 mean-SAGE) is constant.
"""
from repro_torch.configs.common import ArchSpec, Cell
from repro_torch.models.gnn import SageConfig

CELLS = (
    # Cora: full-batch
    Cell("full_graph_sm", "full_graph", extra={
        "n_nodes": 2_708, "n_edges": 10_556, "d_feat": 1_433, "n_classes": 7,
    }),
    # Reddit: sampled training, fanout 15-10 per the assignment
    Cell("minibatch_lg", "minibatch", batch=1024, extra={
        "n_nodes": 232_965, "n_edges": 114_615_892, "d_feat": 602,
        "n_classes": 41, "fanouts": (15, 10),
    }),
    # ogbn-products: full-batch large
    Cell("ogb_products", "full_graph", extra={
        "n_nodes": 2_449_029, "n_edges": 61_859_140, "d_feat": 100,
        "n_classes": 47,
    }),
    # batched small graphs
    Cell("molecule", "molecule", batch=128, extra={
        "n_nodes": 30, "n_edges": 64, "d_feat": 32, "n_classes": 2,
    }),
)


def make_model(cell: Cell) -> SageConfig:
    assert cell is not None, "GNN model dims depend on the cell's graph"
    fanouts = tuple(cell.get("fanouts", (25, 10)))
    return SageConfig(
        name="graphsage-reddit",
        n_layers=2,
        d_in=cell.get("d_feat"),
        d_hidden=128,
        n_classes=cell.get("n_classes"),
        aggregator="mean",
        fanouts=fanouts,
    )


ARCH = ArchSpec(
    id="graphsage-reddit",
    family="gnn",
    make_model=make_model,
    cells=CELLS,
    optimizer="adamw",
    source="arXiv:1706.02216",
)
