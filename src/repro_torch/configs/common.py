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
    source: str = ""

    def cell(self, name: str) -> Cell:
        for c in self.cells:
            if c.name == name:
                return c
        raise KeyError(f"{self.id} has no cell {name!r}; have {[c.name for c in self.cells]}")
