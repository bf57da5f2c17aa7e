"""Architecture registry: ``get(arch_id)`` / ``all_ids()`` (port of
``repro/configs/__init__.py``).

The five LM architectures and the paper's own ANN deployments (word2vec
GoogleNews, GloVe Twitter).  The reference's GNN and recsys configs and its
dry-run-only ``ann_web1b`` are not ported yet.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.common import ArchSpec

_MODULES = [
    "phi3_medium_14b",
    "phi3_mini_3_8b",
    "deepseek_coder_33b",
    "phi3_5_moe_42b",
    "llama4_maverick_400b",
    "ann_word2vec",
    "ann_glove",
]


def _load() -> Dict[str, ArchSpec]:
    out = {}
    for m in _MODULES:
        arch = importlib.import_module(f"repro_torch.configs.{m}").ARCH
        out[arch.id] = arch
    return out


ARCHES: Dict[str, ArchSpec] = _load()

# The assigned (non-ANN) architectures.
ASSIGNED: List[str] = [a for a in ARCHES if not a.startswith("ann-")]


def get(arch_id: str) -> ArchSpec:
    if arch_id not in ARCHES:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(ARCHES)}")
    return ARCHES[arch_id]


def all_ids(include_ann: bool = True) -> List[str]:
    return list(ARCHES) if include_ann else list(ASSIGNED)
