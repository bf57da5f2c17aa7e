"""Config schema: an architecture = method config + its shape cells."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Cell:
    """One input-shape cell."""

    name: str
    kind: str
    batch: int = 0
    seq: int = 0
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def get(self, key: str, default=None):
        return self.extra.get(key, default)


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    id: str
    family: str
    make_model: Callable[[Optional[Cell]], Any]
    cells: Tuple[Cell, ...]
    optimizer: str = "adamw"  # "adamw" | "adafactor"
    source: str = ""
    notes: str = ""

    def cell(self, name: str) -> Cell:
        for c in self.cells:
            if c.name == name:
                return c
        raise KeyError(f"{self.id} has no cell {name!r}; have {[c.name for c in self.cells]}")


# The four LM shapes shared by all five LM architectures.
LM_CELLS = (
    Cell("train_4k", "train", batch=256, seq=4096),
    Cell("prefill_32k", "prefill", batch=32, seq=32768),
    Cell("decode_32k", "decode", batch=128, seq=32768),
    # long_500k: O(L) decode against a length-sharded KV cache.
    Cell("long_500k", "decode", batch=1, seq=524288, extra={"long": True}),
)
