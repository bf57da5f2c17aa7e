"""phi3.5-moe-42b-a6.6b [hf:microsoft/Phi-3.5-MoE-instruct]: 32L d=4096
32H (GQA kv=8) d_ff=6400 vocab=32064, MoE 16 experts top-2 (every layer)."""
from repro_torch.configs.common import LM_CELLS, ArchSpec
from repro_torch.models.transformer import MoEConfig, TransformerConfig


def make_model(cell=None) -> TransformerConfig:
    return TransformerConfig(
        name="phi3.5-moe-42b-a6.6b",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=6400,  # unused (all layers MoE); kept for the record
        vocab=32064,
        moe=MoEConfig(num_experts=16, top_k=2, d_ff=6400, period=1),
    )


ARCH = ArchSpec(
    id="phi3.5-moe-42b-a6.6b",
    family="lm",
    make_model=make_model,
    cells=LM_CELLS,
    optimizer="adafactor",  # factored second moments
    source="hf:microsoft/Phi-3.5-MoE-instruct",
)
