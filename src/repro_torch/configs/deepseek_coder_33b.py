"""deepseek-coder-33b [arXiv:2401.14196]: 62L d=7168 56H (GQA kv=8)
d_ff=19200 vocab=32256 — llama arch."""
from repro_torch.configs.common import LM_CELLS, ArchSpec
from repro_torch.models.transformer import TransformerConfig


def make_model(cell=None) -> TransformerConfig:
    return TransformerConfig(
        name="deepseek-coder-33b",
        n_layers=62,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        head_dim=128,
        d_ff=19200,
        vocab=32256,
    )


ARCH = ArchSpec(
    id="deepseek-coder-33b",
    family="lm",
    make_model=make_model,
    cells=LM_CELLS,
    optimizer="adamw",
    source="arXiv:2401.14196",
)
