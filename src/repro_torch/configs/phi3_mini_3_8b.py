"""phi3-mini-3.8b [arXiv:2404.14219]: 32L d=3072 32H (kv=32 -> MHA)
d_ff=8192 vocab=32064."""
from repro_torch.configs.common import LM_CELLS, ArchSpec
from repro_torch.models.transformer import TransformerConfig


def make_model(cell=None) -> TransformerConfig:
    return TransformerConfig(
        name="phi3-mini-3.8b",
        n_layers=32,
        d_model=3072,
        n_heads=32,
        n_kv_heads=32,  # GQA group 1 == MHA (spec: kv=32)
        head_dim=96,
        d_ff=8192,
        vocab=32064,
    )


ARCH = ArchSpec(
    id="phi3-mini-3.8b",
    family="lm",
    make_model=make_model,
    cells=LM_CELLS,
    optimizer="adamw",
    source="arXiv:2404.14219",
)
