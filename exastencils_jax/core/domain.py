"""Axis-aligned domains and the block/fragment decomposition model.

Reference: domain/ir/IR_DomainFromAABB.scala:26 (AABB domains) and
domain/ir/IR_InitGeneratedDomain.scala:37-71 (rank -> fragment positions).

Here the decomposition is realized as a device mesh, not MPI ranks: one
fragment per device along each sharded mesh axis; see
exastencils_jax.parallel.mesh.  This module only
holds the geometric description.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class AABB:
    lower: Tuple[float, ...]
    upper: Tuple[float, ...]

    @property
    def ndim(self) -> int:
        return len(self.lower)

    def width(self, dim: int) -> float:
        return self.upper[dim] - self.lower[dim]


@dataclass(frozen=True)
class Domain:
    """A named axis-aligned domain (reference: `Domain global< [..] to [..] >`,
    parsers/l4/L4_Parser.scala:394)."""

    name: str
    aabb: AABB

    @property
    def ndim(self) -> int:
        return self.aabb.ndim


def unit_domain(ndim: int, name: str = "global") -> Domain:
    return Domain(name, AABB((0.0,) * ndim, (1.0,) * ndim))
