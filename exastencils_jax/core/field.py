"""Field declarations and boundary conditions.

Reference: field/ir/IR_Field.scala:37 (field = domain + layout + numSlots +
boundary condition), boundary/ir/ (Dirichlet / Neumann / function BCs).

A `Field` here is a *declaration*; the data lives in a plain pytree
`state[name][level] -> jnp.ndarray` (single-chip: the global DOF grid;
sharded: a fragment-stacked array, see exastencils_jax.parallel).  Slots
(multi-buffered fields, reference field/ir/IR_Slot.scala) add a leading
axis handled by exastencils_jax.core.slots.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Callable, Dict, Optional, Union

from exastencils_jax.core.domain import Domain
from exastencils_jax.core.grid import NODE


class BC:
    """Base boundary condition."""


@dataclass(frozen=True)
class NoBC(BC):
    """`None` boundary treatment (reference: Field<..., None>)."""


@dataclass(frozen=True)
class DirichletBC(BC):
    """Dirichlet value: scalar or callable of the boundary position
    (reference boundary/ir/IR_DirichletBC.scala; function values use
    vf_boundaryPosition_* as in the L4 Poisson example)."""

    value: Union[float, Callable]


@dataclass(frozen=True)
class NeumannBC(BC):
    """Zero-flux Neumann of given extrapolation order (reference
    boundary/ir/IR_NeumannBC.scala, order 1 or 2)."""

    order: int = 2


BCLike = Union[BC, float, Callable, None]


def as_bc(bc: BCLike) -> BC:
    if bc is None:
        return NoBC()
    if isinstance(bc, BC):
        return bc
    return DirichletBC(bc)


@dataclass
class Field:
    """Field declaration over a range of levels."""

    name: str
    domain: Domain
    localization: str = NODE
    bc: Union[BCLike, Dict[int, BCLike]] = None  # single or per-level
    num_slots: int = 1
    ghost: int = 1  # halo width for the sharded representation
    matrix_shape: Optional[tuple] = None  # per-DOF vector/matrix datatype

    def bc_at(self, level: int) -> BC:
        if isinstance(self.bc, dict):
            return as_bc(self.bc.get(level))
        return as_bc(self.bc)


@dataclass
class FieldCollection:
    """Named field registry (reference field/ir/IR_FieldCollection via the
    knowledge-collection protocol, knowledge/ir/)."""

    fields: Dict[str, Field] = dc_field(default_factory=dict)

    def add(self, f: Field) -> Field:
        self.fields[f.name] = f
        return f

    def __getitem__(self, name: str) -> Field:
        return self.fields[name]

    def __contains__(self, name: str) -> bool:
        return name in self.fields

    def __iter__(self):
        return iter(self.fields.values())
