"""The LM training driver's model configs (port of the first part of
``repro/launch/train.py``): ``tiny_lm_config``, ``micro_lm_config`` and
``get_model``.  The driver itself (``main``: the optimizer, checkpoints,
restarts, the watchdog) is not ported yet; it comes with training.
"""
from __future__ import annotations

from repro_torch import configs
from repro_torch.models import transformer as tfm


def tiny_lm_config() -> tfm.TransformerConfig:
    """~100M params: 12L x 768d x 12H, vocab 32064 (phi-mini tokenizer
    scale) — the end-to-end example model."""
    return tfm.TransformerConfig(
        name="tiny-lm", n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
        d_ff=2048, vocab=32064,
    )


def micro_lm_config() -> tfm.TransformerConfig:
    """~3M params: the CI-scale model."""
    return tfm.TransformerConfig(
        name="micro-lm", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
        d_ff=256, vocab=2048,
    )


def get_model(arch: str) -> tfm.TransformerConfig:
    if arch == "tiny-lm":
        return tiny_lm_config()
    if arch == "micro-lm":
        return micro_lm_config()
    spec = configs.get(arch)
    if spec.family != "lm":
        raise ValueError(f"{arch} is a {spec.family} architecture; the driver covers LM archs")
    return spec.make_model(None)
