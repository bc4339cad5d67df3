"""Grid geometry: per-level sizes, spacings and "virtual fields" (vf_*).

Reference: grid/ir/IR_VirtualField.scala and friends — lazily materialized
geometric quantities (vf_nodePos_*, vf_cellCenter_*, vf_gridWidth_*,
vf_cellVolume, vf_boundaryPos_*) for uniform / non-uniform axis-aligned
(optionally staggered) grids.  Here they are plain (cached) jnp arrays per
level; expressions built by the DSL layers close over them at trace time,
so XLA constant-folds uniform-grid geometry into the kernels, which is the
JAX analog of the reference inlining `vf_gridWidth` as a literal.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field as dc_field
from functools import cached_property
from typing import Optional, Tuple

import numpy as np
import jax.numpy as jnp

from exastencils_jax.core.domain import Domain


def linearfct_node_positions(lo: float, width: float, n_cells: int) -> np.ndarray:
    """Node positions of the reference's `grid_spacingModel = "linearFct"`
    (grid/ir/IR_SetupNodePositions.scala:128-231, for_AA_LinearFct):
    three zones — spacing grows linearly over the first quarter of the
    cells, stays constant over the middle half, and shrinks linearly
    over the last quarter — with the largest:smallest cell-width ratio
    fixed to 8 (the "better approach" branch, :153-156)."""
    N = int(n_cells)
    if N % 4 != 0:
        raise ValueError(f"linearFct spacing needs 4 | numCells (got {N})")
    xf = N // 4 - 1
    xs = (N // 4) * 3
    alpha_coeff = (-0.5 * xf * xf - 0.5 * xf + xf * N - 0.5 * N * N
                   + 0.5 * N + N * xs - 0.5 * xs * xs - 0.5 * xs)
    factor = (N // 4) / 8.0
    alpha = width / (alpha_coeff + N * factor)
    beta = factor * alpha
    i = np.arange(N + 1, dtype=np.float64)
    zone1 = lo + 0.5 * alpha * i * i + (beta - 0.5 * alpha) * i
    zone2 = lo - 0.5 * alpha * (xf * xf + xf) + (beta + alpha * xf) * i
    zone3 = (lo - 0.5 * alpha * i * i
             + (alpha * xf + alpha * xs + 0.5 * alpha + beta) * i
             - 0.5 * alpha * (xf * xf + xf + xs * xs + xs))
    return np.where(i <= xf + 1, zone1, np.where(i <= xs + 1, zone2, zone3))

# localizations (reference: parsers/l4/L4_Parser.scala:629 Node/Cell/Face_x/y/z)
NODE = "Node"
CELL = "Cell"
FACE_X = "Face_x"
FACE_Y = "Face_y"
FACE_Z = "Face_z"

FACES = (FACE_X, FACE_Y, FACE_Z)


@dataclass(frozen=True)
class LevelGrid:
    """Geometry of one multigrid level over the global domain."""

    domain: Domain
    level: int
    cells: Tuple[int, ...]  # global cell count per dim
    dtype: object = jnp.float64
    # non-uniform axis-aligned grids (grid_spacingModel != "uniform"):
    # explicit per-dim node-position arrays (numpy, host-side)
    node_positions: Optional[Tuple] = dc_field(
        default=None, compare=False, repr=False)

    @property
    def ndim(self) -> int:
        return len(self.cells)

    @property
    def is_uniform(self) -> bool:
        return self.node_positions is None

    # --- spacings (reference vf_gridWidth_*) ---
    def grid_width(self, dim: int) -> float:
        """Scalar spacing; on non-uniform grids this is the MEAN width —
        position-dependent consumers must use cell_widths_1d/width_b."""
        return self.domain.aabb.width(dim) / self.cells[dim]

    def cell_widths_1d(self, dim: int):
        """Per-cell widths along `dim` (length cells[dim])."""
        if self.is_uniform:
            return jnp.full((self.cells[dim],), self.grid_width(dim), self.dtype)
        p = self.node_positions[dim]
        return jnp.asarray(np.diff(p), self.dtype)

    def width_b(self, dim: int):
        """vf_gridWidth as an expression operand: scalar on uniform
        grids (constant-folds into kernels), broadcastable per-cell
        array on non-uniform grids."""
        if self.is_uniform:
            return self.grid_width(dim)
        w = self.cell_widths_1d(dim)
        shape = [1] * self.ndim
        shape[dim] = w.shape[0]
        return w.reshape(shape)

    @cached_property
    def widths(self) -> Tuple[float, ...]:
        return tuple(self.grid_width(d) for d in range(self.ndim))

    @property
    def cell_volume(self):
        if self.is_uniform:
            return math.prod(self.widths)
        vol = 1.0
        for d in range(self.ndim):
            vol = vol * self.width_b(d)
        return vol

    # --- node / cell-center positions (reference vf_nodePos_*, vf_cellCenter_*) ---
    def node_pos_1d(self, dim: int) -> jnp.ndarray:
        if not self.is_uniform:
            return jnp.asarray(self.node_positions[dim], self.dtype)
        lo = self.domain.aabb.lower[dim]
        n = self.cells[dim]
        return lo + self.grid_width(dim) * jnp.arange(n + 1, dtype=self.dtype)

    def cell_center_1d(self, dim: int) -> jnp.ndarray:
        if not self.is_uniform:
            p = self.node_positions[dim]
            return jnp.asarray(0.5 * (p[1:] + p[:-1]), self.dtype)
        lo = self.domain.aabb.lower[dim]
        n = self.cells[dim]
        return lo + self.grid_width(dim) * (jnp.arange(n, dtype=self.dtype) + 0.5)

    def face_pos_1d(self, dim: int, face_dim: int) -> jnp.ndarray:
        """Position along `dim` of DOF centers of a Face_{face_dim} field."""
        return self.node_pos_1d(dim) if dim == face_dim else self.cell_center_1d(dim)

    def coords_1d(self, localization: str, dim: int) -> jnp.ndarray:
        if localization == NODE:
            return self.node_pos_1d(dim)
        if localization == CELL:
            return self.cell_center_1d(dim)
        if localization in FACES:
            return self.face_pos_1d(dim, FACES.index(localization))
        raise ValueError(f"unknown localization {localization!r}")

    def coord_mesh(self, localization: str):
        """ndim broadcastable coordinate arrays for the DOFs of a field with
        the given localization (the vf_* access path of DSL expressions)."""
        axes = []
        for d in range(self.ndim):
            c = self.coords_1d(localization, d)
            shape = [1] * self.ndim
            shape[d] = c.shape[0]
            axes.append(c.reshape(shape))
        return tuple(axes)

    def shape_of(self, localization: str) -> Tuple[int, ...]:
        if localization == NODE:
            return tuple(c + 1 for c in self.cells)
        if localization == CELL:
            return tuple(self.cells)
        if localization in FACES:
            fd = FACES.index(localization)
            return tuple(c + 1 if d == fd else c for d, c in enumerate(self.cells))
        raise ValueError(f"unknown localization {localization!r}")


def level_grids(domain: Domain, knowledge, dtype=None) -> dict:
    """LevelGrid per level in [minLevel, maxLevel].

    grid_spacingModel = "linearFct" builds the reference's stretched
    axis-aligned grid at the finest level and restricts node positions
    to coarser levels by taking every second node (for_AA_LinearFct at
    maxLevel + for_AA_restrictFromFiner below it,
    grid/ir/IR_VF_NodePosition.scala:130-133)."""
    nd = domain.ndim
    dtype = dtype if dtype is not None else knowledge.real_dtype
    model = getattr(knowledge, "grid_spacingModel", "uniform")
    positions = {}
    if model == "linearFct":
        finest = knowledge.maxLevel
        pos = tuple(
            linearfct_node_positions(
                domain.aabb.lower[d], domain.aabb.width(d),
                knowledge.cells_per_dim(finest, d),
            )
            for d in range(nd)
        )
        positions[finest] = pos
        for lvl in range(finest - 1, knowledge.minLevel - 1, -1):
            pos = tuple(p[::2] for p in pos)
            positions[lvl] = pos
    elif model != "uniform":
        raise NotImplementedError(
            f"grid_spacingModel {model!r} (supported: uniform, linearFct)"
        )
    return {
        lvl: LevelGrid(
            domain,
            lvl,
            tuple(knowledge.cells_per_dim(lvl, d) for d in range(nd)),
            dtype=dtype,
            node_positions=positions.get(lvl),
        )
        for lvl in range(knowledge.minLevel, knowledge.maxLevel + 1)
    }
