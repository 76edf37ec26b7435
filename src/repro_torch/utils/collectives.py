"""Collective wire bytes: the counterpart of ``repro/utils/hlo.py``.

The JAX package reads its collectives out of a compiled module's HLO text;
the port issues each one itself (``utils/shard_hints.py``), so there is no
text to parse and what remains is the accounting: :func:`wire_bytes` turns
a collective's result size and group into the bytes one rank puts on the
wire (``hlo.py``'s ``_wire_bytes``, the same formula for each kind), and
:class:`CollectiveStats` sums them by kind (``hlo.py``'s, with the same
``total_bytes``, ``total_count`` and ``summary``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional


def wire_bytes(kind: str, result: int, g: Optional[int]) -> float:
    """Per-rank wire bytes of one collective whose result holds ``result``
    bytes over a group of ``g`` ranks (ring algorithms): an all-reduce
    sends ``2 (g - 1) / g`` of its result, an all-gather, all-to-all or
    broadcast ``(g - 1) / g``, a reduce-scatter ``g - 1`` times its
    (scattered) result, a permute its result.  A group that is unknown or
    of one rank is charged as a group of 2, the JAX package's conservative
    default."""
    g = g if g and g > 1 else 2
    if kind == "all-reduce":
        return 2.0 * result * (g - 1) / g
    if kind in ("all-gather", "all-to-all", "ragged-all-to-all",
                "collective-broadcast"):
        return result * (g - 1) / g
    if kind == "reduce-scatter":
        return float(result * (g - 1))
    return float(result)  # collective-permute


@dataclass
class CollectiveStats:
    """Per-kind wire-byte totals and counts of one rank's collectives."""

    bytes_by_kind: Dict[str, float] = field(default_factory=dict)
    count_by_kind: Dict[str, int] = field(default_factory=dict)

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_kind.values())

    @property
    def total_count(self) -> int:
        return sum(self.count_by_kind.values())

    def add(self, kind: str, nbytes: float, count: int = 1) -> None:
        self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0.0) + nbytes
        self.count_by_kind[kind] = self.count_by_kind.get(kind, 0) + count

    def summary(self) -> str:
        parts = [
            f"{k}: n={self.count_by_kind[k]} bytes={self.bytes_by_kind[k]:,.0f}"
            for k in sorted(self.bytes_by_kind)
        ]
        return "; ".join(parts) if parts else "no collectives"
