"""llama4-maverick-400b-a17b [hf:meta-llama/Llama-4 family]: 48L d=5120
40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128 experts top-1.

Interpretation: all-layer MoE would give ~780B total, contradicting the
400B name; Llama-4 interleaves MoE every other layer (moe period=2), giving
~394B total / ~17B active — matching 400b-a17b.  bf16 parameters.
"""
import torch

from repro_torch.configs.common import LM_CELLS, ArchSpec
from repro_torch.models.transformer import MoEConfig, TransformerConfig


def make_model(cell=None) -> TransformerConfig:
    return TransformerConfig(
        name="llama4-maverick-400b-a17b",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        head_dim=128,
        d_ff=16384,  # dense (non-MoE) layers are 2x wider (Maverick)
        vocab=202048,
        moe=MoEConfig(num_experts=128, top_k=1, d_ff=8192, period=2,
                      shared_expert=True),
        param_dtype=torch.bfloat16,  # 394B parameters
    )


ARCH = ArchSpec(
    id="llama4-maverick-400b-a17b",
    family="lm",
    make_model=make_model,
    cells=LM_CELLS,
    optimizer="adafactor",
    source="hf:meta-llama/Llama-4-Scout-17B-16E (family)",
    notes="moe_layer_period=2 + shared-expert + 16384-wide dense FFN "
    "interpretation: yields 400.6B total / 17.2B active, matching the "
    "nameplate; early-fusion frontend stubbed (input_specs provide token "
    "ids; vision patches would enter as embeddings)",
)
