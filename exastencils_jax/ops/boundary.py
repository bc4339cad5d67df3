"""Boundary-condition application on dense level arrays.

Reference: boundary/ir/IR_HandleBoundaries.scala (`apply bc to field`
generates per-neighbor-direction boundary loops); IR_DirichletBC.scala,
IR_NeumannBC.scala.

On the dense global representation the boundary DOFs of a node field are
the outermost planes; `apply bc` becomes a handful of plane writes that
XLA fuses with the producing kernel.  The returned applier is a pure
function arr -> arr; Dirichlet values are precomputed per level so they
compile to constants.

Plane writes are expressed as iota-mask selects (ops.shardsafe), never
as chained .at[].set: chains of >=3 dynamic-update-slices on a sharded
array miscompile under XLA SPMD (see shardsafe module docstring).
"""

from __future__ import annotations

from typing import Callable

import jax.numpy as jnp

from exastencils_jax.core.field import BC, DirichletBC, Field, NeumannBC, NoBC
from exastencils_jax.core.grid import NODE, LevelGrid
from exastencils_jax.ops.shardsafe import plane_set


def _plane(nd: int, dim: int, index) -> tuple:
    return tuple(index if d == dim else slice(None) for d in range(nd))


def make_bc_applier(field: Field, grid: LevelGrid, level: int = None) -> Callable:
    """Build `apply_bc(arr) -> arr` for `field` on `grid`.

    Only node-localized fields carry boundary DOFs in the dense
    representation; cell/face fields handle Dirichlet through ghost
    layers in the sharded/FV path (see parallel.halo / models.fv)."""
    bc = field.bc_at(grid.level if level is None else level)
    nd = grid.ndim

    if isinstance(bc, NoBC):
        return lambda arr: arr

    if field.localization != NODE:
        # cell dims are handled by virtual-ghost folding at stencil-apply
        # time; Face_d fields additionally have on-boundary DOF planes
        # along d that Dirichlet must set (staggered Stokes velocities)
        from exastencils_jax.core.grid import FACES

        if field.localization in FACES and isinstance(bc, DirichletBC):
            fd = FACES.index(field.localization)
            if callable(bc.value):
                coords = grid.coord_mesh(field.localization)
                shape = grid.shape_of(field.localization)

                def apply_face_dirichlet(arr):
                    for idx in (0, -1):
                        pl = _plane(nd, fd, idx)
                        pc = tuple(c[pl] for c in coords)
                        vals = bc.value(*pc) + jnp.zeros(
                            tuple(s for i, s in enumerate(shape) if i != fd),
                            grid.dtype,
                        )
                        arr = plane_set(arr, fd, idx, vals.astype(arr.dtype))
                    return arr

                return apply_face_dirichlet

            def apply_face_dirichlet_const(arr):
                for idx in (0, -1):
                    arr = plane_set(arr, fd, idx, bc.value)
                return arr

            return apply_face_dirichlet_const
        return lambda arr: arr

    if isinstance(bc, DirichletBC):
        # precompute values only on the 2*nd boundary *planes* — tiny
        # constants, unlike a full-grid array which would be baked into
        # every executable (537 MB at 513^3)
        plane_values = None
        if callable(bc.value):
            plane_values = {}
            coords = grid.coord_mesh(NODE)
            shape = grid.shape_of(NODE)
            for d in range(nd):
                for idx in (0, -1):
                    pl = _plane(nd, d, idx)
                    pc = tuple(c[pl] for c in coords)
                    vals = bc.value(*pc)
                    plane_values[(d, idx)] = vals + jnp.zeros(
                        tuple(s for i, s in enumerate(shape) if i != d), grid.dtype
                    )

        def apply_dirichlet(arr):
            for d in range(nd):
                for idx in (0, -1):
                    if plane_values is None:
                        arr = plane_set(arr, d, idx, bc.value)
                    else:
                        arr = plane_set(
                            arr, d, idx, plane_values[(d, idx)].astype(arr.dtype)
                        )
            return arr

        return apply_dirichlet

    if isinstance(bc, NeumannBC):
        order = bc.order

        def apply_neumann(arr):
            # zero-flux: extrapolate boundary plane from interior
            # (reference IR_NeumannBC: order-1 copy / order-2 quadratic)
            for d in range(nd):
                if order == 1:
                    arr = plane_set(arr, d, 0, arr[_plane(nd, d, 1)])
                    arr = plane_set(arr, d, -1, arr[_plane(nd, d, -2)])
                elif order == 2:
                    arr = plane_set(
                        arr, d, 0,
                        (4.0 * arr[_plane(nd, d, 1)] - arr[_plane(nd, d, 2)]) / 3.0,
                    )
                    arr = plane_set(
                        arr, d, -1,
                        (4.0 * arr[_plane(nd, d, -2)] - arr[_plane(nd, d, -3)]) / 3.0,
                    )
                else:
                    raise ValueError(f"Neumann order {order} not supported")
            return arr

        return apply_neumann

    raise TypeError(f"unsupported bc {bc!r}")


def boundary_mask(grid: LevelGrid, dtype=bool) -> jnp.ndarray:
    """True on boundary DOFs of a node field (reference IR_IsOnBoundary)."""
    shape = grid.shape_of(NODE)
    m = jnp.zeros(shape, dtype)
    for d in range(grid.ndim):
        m = plane_set(m, d, 0, True)
        m = plane_set(m, d, -1, True)
    return m
