from exastencils_jax.core.domain import AABB, Domain, unit_domain
from exastencils_jax.core.field import (
    BC,
    DirichletBC,
    Field,
    FieldCollection,
    NeumannBC,
    NoBC,
    as_bc,
)
from exastencils_jax.core.grid import CELL, FACE_X, FACE_Y, FACE_Z, NODE, LevelGrid, level_grids
from exastencils_jax.core.layout import FieldLayout, LayoutPerDim, fragment_layout
from exastencils_jax.core.stencil import (
    BoundStencil,
    IntergridStencil,
    Stencil,
    cell_prolongation,
    cell_restriction,
    node_prolongation,
    node_restriction,
)

__all__ = [
    "AABB", "Domain", "unit_domain",
    "BC", "DirichletBC", "NeumannBC", "NoBC", "Field", "FieldCollection", "as_bc",
    "NODE", "CELL", "FACE_X", "FACE_Y", "FACE_Z", "LevelGrid", "level_grids",
    "FieldLayout", "LayoutPerDim", "fragment_layout",
    "Stencil", "BoundStencil", "IntergridStencil",
    "node_restriction", "node_prolongation", "cell_restriction", "cell_prolongation",
]
