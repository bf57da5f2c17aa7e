"""phi3-medium-14b [arXiv:2404.14219]: 40L d=5120 40H (GQA kv=10)
d_ff=17920 vocab=100352 — RoPE SwiGLU GQA."""
from repro_torch.configs.common import LM_CELLS, ArchSpec
from repro_torch.models.transformer import TransformerConfig


def make_model(cell=None) -> TransformerConfig:
    return TransformerConfig(
        name="phi3-medium-14b",
        n_layers=40,
        d_model=5120,
        n_heads=40,
        n_kv_heads=10,
        head_dim=128,
        d_ff=17920,
        vocab=100352,
    )


ARCH = ArchSpec(
    id="phi3-medium-14b",
    family="lm",
    make_model=make_model,
    cells=LM_CELLS,
    optimizer="adamw",
    source="arXiv:2404.14219",
)
