"""Execution backends: dense single-chip vs fragment-sharded multi-chip.

A backend provides per-level "handles" with a uniform interface (shape,
exchange, bc application, color masks, ownership-aware reductions,
inter-grid transfers, field initialization), so model/solver code is
written once and runs either:

  * DenseBackend   — global dense arrays, one device, exchange = no-op
                     (the reference's serial / single-rank codepath);
  * ShardedBackend — fragment-stacked arrays over a jax.sharding.Mesh,
                     whole solver steps wrapped in one shard_map with
                     ppermute halo exchange (the MPI-block codepath,
                     communication/ir/*, re-expressed as device collectives).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from exastencils_jax.core.field import DirichletBC, Field, NeumannBC, NoBC
from exastencils_jax.core.grid import NODE, LevelGrid
from exastencils_jax.core.stencil import IntergridStencil
from exastencils_jax.ops.boundary import make_bc_applier
from exastencils_jax.ops.reductions import dot as _dot, norm_l2 as _norm_l2, norm_max as _norm_max
from exastencils_jax.ops.smoothers import color_mask
from exastencils_jax.ops.stencil_apply import prolong as dense_prolong, restrict as dense_restrict
from exastencils_jax.ops.transfer import (
    apply_separable,
    build_prolong_mats,
    build_restrict_mats,
)
from exastencils_jax.parallel.topology import ShardTopology

try:  # jax >= 0.4.35 exposes shard_map at top level
    _shard_map = jax.shard_map
except AttributeError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map as _shard_map


# ======================================================================
# dense (single-chip) backend
# ======================================================================


@dataclass
class DenseLevelHandle:
    grid: LevelGrid
    shape: Tuple[int, ...]

    @property
    def work_shape(self):
        """Shape solver code sees (== global shape on the dense path)."""
        return self.shape

    def exchange(self, x):
        return x

    def bc_applier(self, field: Field, level: int) -> Callable:
        return make_bc_applier(field, self.grid, level)

    def color_masks(self, num_colors: int = 2, color_fn=None):
        return [
            (lambda c=c: color_mask(self.shape, c, num_colors, color_fn=color_fn))
            for c in range(num_colors)
        ]

    def coords(self):
        return self.grid.coord_mesh(NODE)

    # reductions --------------------------------------------------------
    def dot(self, a, b):
        return _dot(a, b)

    def norm_l2(self, a):
        return _norm_l2(a)

    def norm_max(self, a):
        return _norm_max(a)

    # init --------------------------------------------------------------
    def zeros(self, dtype):
        return jnp.zeros(self.shape, dtype)

    def init_field_local(self, fn, dtype):
        if fn is None:
            return self.zeros(dtype)
        return fn(*self.coords()) + jnp.zeros(self.shape, dtype)

    def to_global(self, arr):
        return np.asarray(arr)


class DenseBackend:
    """Single-device backend over global dense node arrays."""

    is_sharded = False

    def __init__(self, grids: Dict[int, LevelGrid]):
        self.grids = grids
        self.handles = {
            lvl: DenseLevelHandle(g, g.shape_of(NODE)) for lvl, g in grids.items()
        }

    def handle(self, level: int) -> DenseLevelHandle:
        return self.handles[level]

    def transfer_fns(self, fine_level: int, restrict_op: IntergridStencil, prolong_op: IntergridStencil):
        # strided-slice sums (ops/stencil_apply.py): on the H100 they beat
        # the banded-matrix contractions of ops/transfer.py at 513^3 f32
        # (restrict 0.55 vs 4.04 ms, prolong 2.61 vs 4.29 ms at HIGHEST
        # precision) and take any window, separable or not
        fine = self.handles[fine_level]
        coarse = self.handles[fine_level - 1]
        return (
            lambda res: dense_restrict(restrict_op, res, coarse.shape),
            lambda sol_c: dense_prolong(prolong_op, sol_c, fine.shape),
        )

    def wrap(self, fn, in_kinds=None, out_kinds=None, donate_argnums=()):
        return jax.jit(fn, donate_argnums=donate_argnums)

    def init_field(self, level: int, fn, dtype):
        return jax.jit(lambda: self.handles[level].init_field_local(fn, dtype))()


# ======================================================================
# sharded (multi-chip) backend
# ======================================================================


@dataclass
class ShardedLevelHandle:
    grid: LevelGrid
    topo: ShardTopology
    local_cells: Tuple[int, ...]

    def __post_init__(self):
        self.local_shape = self.topo.local_shape(self.local_cells)
        self.shape = tuple(
            p * t for p, t in zip(self.topo.P, self.local_shape)
        )  # global stacked shape

    @property
    def work_shape(self):
        """Shape solver code sees inside shard_map (the fragment view)."""
        return self.local_shape

    # inside-shard_map ops ---------------------------------------------
    def exchange(self, x):
        return self.topo.exchange(x, self.local_cells)

    def bc_applier(self, field: Field, level: int) -> Callable:
        bc = field.bc_at(level)
        topo, gs = self.topo, self.topo.ghosts
        nd = topo.ndim
        shape = self.local_shape

        if isinstance(bc, NoBC) or field.localization != NODE:
            return lambda arr: arr

        if isinstance(bc, DirichletBC):
            value = bc.value

            def apply_dirichlet(arr):
                if callable(value):
                    coords = topo.local_coords(self.grid, self.local_cells, shape)
                    vals = (value(*coords) + jnp.zeros(shape, arr.dtype)).astype(arr.dtype)
                else:
                    vals = jnp.asarray(value, arr.dtype)
                for d in range(nd):
                    i = lax.broadcasted_iota(jnp.int32, shape, d)
                    lo_plane = jnp.logical_and(
                        i == gs[d], topo.is_lo_boundary(d))
                    hi_plane = jnp.logical_and(
                        i == gs[d] + self.local_cells[d],
                        topo.is_hi_boundary(d)
                    )
                    arr = jnp.where(jnp.logical_or(lo_plane, hi_plane), vals, arr)
                return arr

            return apply_dirichlet

        if isinstance(bc, NeumannBC):
            order = bc.order

            def apply_neumann(arr):
                # boundary plane from interior neighbors along the normal
                for d in range(nd):
                    i = lax.broadcasted_iota(jnp.int32, shape, d)
                    lo = gs[d]
                    hi = gs[d] + self.local_cells[d]
                    if order == 1:
                        lo_val = jnp.roll(arr, -1, axis=d)
                        hi_val = jnp.roll(arr, 1, axis=d)
                    else:
                        lo_val = (4.0 * jnp.roll(arr, -1, axis=d) - jnp.roll(arr, -2, axis=d)) / 3.0
                        hi_val = (4.0 * jnp.roll(arr, 1, axis=d) - jnp.roll(arr, 2, axis=d)) / 3.0
                    arr = jnp.where(
                        jnp.logical_and(i == lo, self.topo.is_lo_boundary(d)), lo_val, arr
                    )
                    arr = jnp.where(
                        jnp.logical_and(i == hi, self.topo.is_hi_boundary(d)), hi_val, arr
                    )
                return arr

            return apply_neumann

        raise TypeError(f"unsupported bc {bc!r}")

    def color_masks(self, num_colors: int = 2, color_fn=None):
        def make(c):
            def build():
                offs = self.topo.index_offsets(self.local_cells)
                return color_mask(
                    self.local_shape, c, num_colors, index_offset=offs, color_fn=color_fn
                )

            return build

        return [make(c) for c in range(num_colors)]

    def coords(self):
        return self.topo.local_coords(self.grid, self.local_cells, self.local_shape)

    # ownership-aware reductions ---------------------------------------
    def _owned(self):
        return self.topo.owned_mask(self.local_shape, self.local_cells)

    def dot(self, a, b):
        local = jnp.sum(jnp.where(self._owned(), a * b, 0))
        return self.topo.psum(local)

    def norm_l2(self, a):
        return jnp.sqrt(self.dot(a, a))

    def norm_max(self, a):
        local = jnp.max(jnp.where(self._owned(), jnp.abs(a), 0))
        return self.topo.pmax(local)

    # init (inside shard_map) ------------------------------------------
    def zeros(self, dtype):
        return jnp.zeros(self.local_shape, dtype)

    def init_field_local(self, fn, dtype):
        if fn is None:
            return self.zeros(dtype)
        return fn(*self.coords()) + jnp.zeros(self.local_shape, dtype)


class ShardedBackend:
    """Fragment-stacked arrays over a device mesh; solver steps run in a
    single shard_map."""

    is_sharded = True

    def __init__(self, grids: Dict[int, LevelGrid], mesh: Mesh, shard_dims: Tuple[int, ...], ghost: int = 1,
                 replicate_below: int = 0):
        """shard_dims[d] = shards along spatial dim d (product = mesh size;
        dims with 1 are unsharded).

        Levels whose cells are not divisible by the shard grid, or whose
        extent drops below `replicate_below` cells per dim
        (Knowledge.coarse_replicate_threshold), are REPLICATED: every
        device holds and smooths the full level redundantly inside the
        same shard_map — the JAX form of the reference's coarse-grid
        agglomeration (latency-bound tiny grids stop paying per-sweep
        neighbor comm; domain/ir partitioning + SURVEY §2.4)."""
        self.mesh = mesh
        shard_dims = tuple(int(p) for p in shard_dims)
        if tuple(mesh.devices.shape) != shard_dims:
            raise ValueError(
                f"mesh shape {mesh.devices.shape} != shard_dims {shard_dims}; "
                "build the mesh with one axis per spatial dim (size 1 allowed)"
            )
        names = tuple(
            n if p > 1 else None for n, p in zip(mesh.axis_names, shard_dims)
        )
        self.topo = ShardTopology(mesh, shard_dims, names, ghost)
        self.grids = grids
        self.handles = {}
        self.replicated: set = set()
        finest = max(grids)
        for lvl, g in grids.items():
            cells = g.cells
            per_shard = [c // p for c, p in zip(cells, shard_dims) if p > 1]
            divisible = all(
                c % p == 0 and c // p >= 1 for c, p in zip(cells, shard_dims)
            )
            # the finest level is always sharded when divisible (that is
            # the point of the backend); the replicate threshold governs
            # the coarse end of the hierarchy only
            shardable = divisible and (
                lvl == finest
                or not per_shard
                or min(per_shard) >= max(1, replicate_below)
            )
            if not shardable:
                if lvl == finest:
                    raise ValueError(
                        f"finest level {lvl}: cells {cells} not divisible by "
                        f"the {shard_dims} shard grid"
                    )
                self.replicated.add(lvl)
                self.handles[lvl] = DenseLevelHandle(g, g.shape_of(NODE))
                continue
            local = [c // p for c, p in zip(cells, shard_dims)]
            self.handles[lvl] = ShardedLevelHandle(g, self.topo, tuple(local))

    def handle(self, level: int) -> ShardedLevelHandle:
        return self.handles[level]

    # ------------------------------------------------------------------
    # replicated-coarse support: assemble/distribute global arrays inside
    # shard_map at the sharded->replicated crossover level
    def gather_global(self, level: int, x):
        """Fragment view -> full global node array on EVERY device:
        owned-masked block embed + psum over the mesh axes (one
        all-reduce; the crossover level is tiny by construction)."""
        h = self.handles[level]
        topo = self.topo
        nd = topo.ndim
        S = h.grid.shape_of(NODE)
        owned = topo.owned_mask(h.local_shape, h.local_cells)
        xo = jnp.where(owned, x, 0)
        lay = topo.layout(tuple(h.local_cells))
        block = xo[tuple(
            slice(lay.idx("DLB", d), lay.idx("DRE", d)) for d in range(nd)
        )]
        starts = tuple(
            topo.axis_index(d) * h.local_cells[d] for d in range(nd)
        )
        embedded = lax.dynamic_update_slice(
            jnp.zeros(S, x.dtype), block, starts
        )
        return topo.psum(embedded)

    def scatter_local(self, level: int, x_global):
        """Full global node array -> this fragment's local view (ghosts
        filled from the global data; physical-boundary ghosts zero)."""
        h = self.handles[level]
        topo = self.topo
        gs, nd = topo.ghosts, topo.ndim
        xp = jnp.pad(x_global, tuple((g, g) for g in gs))
        starts = tuple(
            topo.axis_index(d) * h.local_cells[d] for d in range(nd)
        )
        return lax.dynamic_slice(xp, starts, h.local_shape)

    def transfer_fns(self, fine_level: int, restrict_op: IntergridStencil, prolong_op: IntergridStencil):
        """Fragment-local transfers as banded-matrix contractions over the
        padded local arrays: coarse node j reads fine local 2j - g + lo + k
        (fine ghosts supply fragment-interface values via the preceding
        halo exchange); ghost output rows are zero.

        Replicated coarse levels: below the crossover both levels are
        global dense arrays (DenseBackend's strided-slice transfers); AT
        the crossover the fine fragments are gathered once, transferred
        densely, and scattered back (reference coarse-grid
        agglomeration)."""
        fh = self.handles[fine_level]
        ch = self.handles[fine_level - 1]
        fine_rep = fine_level in self.replicated
        coarse_rep = (fine_level - 1) in self.replicated
        if fine_rep and coarse_rep:
            return (
                lambda res: dense_restrict(restrict_op, res, ch.shape),
                lambda sol_c: dense_prolong(prolong_op, sol_c, fh.shape),
            )
        if coarse_rep:
            fS = fh.grid.shape_of(NODE)
            return (
                lambda res: dense_restrict(
                    restrict_op, self.gather_global(fine_level, res), ch.shape),
                lambda sol_c: self.scatter_local(
                    fine_level, dense_prolong(prolong_op, sol_c, fS)),
            )
        # shardability is monotone toward coarse levels: a replicated
        # fine level above a sharded coarse one would fall through to
        # the fragment-local path with a dense handle and crash — fail
        # loudly if the invariant is ever broken (advisor r3 #5)
        if fine_rep and not coarse_rep:
            raise AssertionError(
                "replicated fine level above sharded coarse level: the "
                "replication threshold must be monotone toward coarse levels"
            )
        gs = self.topo.ghosts
        r_mats = build_restrict_mats(
            restrict_op, tuple(c + 1 for c in ch.local_cells),
            fh.local_shape, ch.local_shape, ghosts=gs)
        p_mats = build_prolong_mats(
            prolong_op, tuple(c + 1 for c in fh.local_cells),
            ch.local_shape, fh.local_shape, ghosts=gs)
        return (
            lambda res: apply_separable(r_mats, res),
            lambda sol_c: apply_separable(p_mats, sol_c),
        )

    # ------------------------------------------------------------------
    def spec(self):
        return P(*(n for n in self.topo.names))

    def sharding(self):
        return NamedSharding(self.mesh, self.spec())

    def wrap(self, fn, in_kinds, out_kinds, donate_argnums=()):
        """shard_map + jit.  kinds: 'field' (fragment-stacked array) or
        'scalar' (replicated)."""
        fspec = self.spec()

        def spec_of(kind):
            return fspec if kind == "field" else P()

        mapped = _shard_map(
            fn,
            mesh=self.mesh,
            in_specs=tuple(spec_of(k) for k in in_kinds),
            out_specs=tuple(spec_of(k) for k in out_kinds)
            if isinstance(out_kinds, (list, tuple))
            else spec_of(out_kinds),
        )
        return jax.jit(mapped, donate_argnums=donate_argnums)

    # host-side init: build a global stacked array from a local init fn
    def init_field(self, level: int, fn, dtype):
        h = self.handles[level]

        def local_init():
            return h.init_field_local(fn, dtype)

        build = jax.jit(
            _shard_map(local_init, mesh=self.mesh, in_specs=(), out_specs=self.spec())
        )
        return build()
