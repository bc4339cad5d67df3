"""Poisson model family (FD, node-based) — the reference's flagship problem.

Reference inputs reproduced:
  * Examples/Poisson/2D_FD_Poisson_fromL4.exa4 (+ Testing/Poisson goldens)
  * Benchmark/Poisson3D/3D_FD_Poisson_fromL4.exa4 (perf problem)

`PoissonMGSolver` assembles the same algorithm the reference *generates*:
damped red-black Gauss-Seidel V(3,3)-cycles with bilinear transfers and a
CG coarse-grid solve, as one jitted XLA program per cycle.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from typing import Callable, Optional

import jax.numpy as jnp

from exastencils_jax.config import Knowledge
from exastencils_jax.core.domain import Domain, unit_domain
from exastencils_jax.core.field import DirichletBC, Field
from exastencils_jax.core.grid import NODE, level_grids
from exastencils_jax.core.stencil import Stencil, node_prolongation, node_restriction
from exastencils_jax.solver.synthesis import Equation, generate_solver


def laplace_stencil(ndim: int) -> Stencil:
    """Standard (2*ndim+1)-point FD Laplacian with grid-width-dependent
    coefficients (reference: `Stencil Laplace@all` in
    2D_FD_Poisson_fromL4.exa4; sign convention -Delta)."""
    st = Stencil("Laplace")
    st.add_entry(
        (0,) * ndim,
        lambda g: sum(2.0 / g.grid_width(d) ** 2 for d in range(g.ndim)),
    )
    for d in range(ndim):
        for s in (-1, 1):
            off = tuple(s if i == d else 0 for i in range(ndim))
            st.add_entry(off, lambda g, d=d: -1.0 / g.grid_width(d) ** 2)
    return st


# --- the reference example's manufactured solution (2D) ---
def default_solution_2d(x, y):
    return jnp.cos(math.pi * x) - jnp.sin(2.0 * math.pi * y)


def default_rhs_2d(x, y):
    return (math.pi ** 2) * jnp.cos(math.pi * x) - 4.0 * (math.pi ** 2) * jnp.sin(
        2.0 * math.pi * y
    )


# --- 3D variants (Benchmark/Poisson3D) ---
def default_solution_3d(x, y, z):
    return jnp.cos(math.pi * x) - jnp.sin(2.0 * math.pi * y) + jnp.cos(3.0 * math.pi * z)


def default_rhs_3d(x, y, z):
    pi2 = math.pi ** 2
    return (
        pi2 * jnp.cos(math.pi * x)
        - 4.0 * pi2 * jnp.sin(2.0 * math.pi * y)
        + 9.0 * pi2 * jnp.cos(3.0 * math.pi * z)
    )


@dataclass
class PoissonMGSolver:
    """FD Poisson with geometric multigrid on [0,1]^d.

    Runs on either execution backend: the dense single-chip path, or the
    fragment-sharded multi-chip path (pass `backend` or set
    knowledge.mesh_shape)."""

    knowledge: Knowledge
    bc_fn: Callable = None  # Dirichlet boundary value g(x, y[, z])
    rhs_fn: Callable = None
    exact_fn: Callable = None  # for error reporting (PrintError@finest)
    omega: float = 0.8
    smoother: str = "RBGS"  # reference benchmark algorithm default
    n_pre: int = 3
    n_post: int = 3
    cgs: str = "CG"
    cgs_max_its: int = 128
    cgs_res_reduction: float = 1e-3
    domain: Optional[Domain] = None
    backend: object = None
    mesh: object = None  # jax.sharding.Mesh -> use the sharded backend
    shard_dims: Optional[tuple] = None  # shards per spatial dim

    def __post_init__(self):
        k = self.knowledge
        nd = k.dimensionality
        if self.bc_fn is None:
            self.bc_fn = default_solution_2d if nd == 2 else default_solution_3d
        if self.rhs_fn is None:
            self.rhs_fn = default_rhs_2d if nd == 2 else default_rhs_3d
        if self.exact_fn is None:
            self.exact_fn = self.bc_fn
        if self.domain is None:
            self.domain = unit_domain(nd)
        self.dtype = k.real_dtype
        self.grids = level_grids(self.domain, k, dtype=self.dtype)
        self.stencil = laplace_stencil(nd)
        self.restrict_op = node_restriction(nd)
        self.prolong_op = node_prolongation(nd)

        if self.backend is None:
            if self.mesh is not None:
                from exastencils_jax.parallel.backend import ShardedBackend

                dims = self.shard_dims or tuple(self.mesh.devices.shape)
                ghost = max(1, k.comm_ghostWidth, k.comm_haloAggregationFactor)
                self.backend = ShardedBackend(
                    self.grids, self.mesh, dims,
                    ghost=ghost,
                    replicate_below=k.coarse_replicate_threshold)
            else:
                from exastencils_jax.parallel.backend import DenseBackend

                self.backend = DenseBackend(self.grids)

        # field declarations (reference field block of the L4 example)
        self.solution = Field(
            "Solution",
            self.domain,
            NODE,
            bc={k.maxLevel: DirichletBC(self.bc_fn)}
            | {lvl: DirichletBC(0.0) for lvl in range(k.minLevel, k.maxLevel)},
        )
        self.rhs_f = Field("RHS", self.domain, NODE, bc=None)

        # expand `generate solver` (the L3 path the reference used to
        # produce the very mgCycle functions of the L4 example)
        self.equation = Equation(self.solution, self.stencil, rhs_fn=self.rhs_fn)
        self.gen = generate_solver(
            self.equation,
            k,
            self.backend,
            self.grids,
            options={
                "smoother": self.smoother,
                "smoother_damping": self.omega,
                "smoother_numPre": self.n_pre,
                "smoother_numPost": self.n_post,
                "cgs": self.cgs,
                "cgs_maxNumIts": self.cgs_max_its,
                "cgs_targetResReduction": self.cgs_res_reduction,
            },
            error_fn=self.exact_fn,
            restrict_op=self.restrict_op,
            prolong_op=self.prolong_op,
        )
        self.mg = self.gen.mg
        self.levels = self.mg.levels
        self._cycle = self.gen._cycle
        self._res_norm = self.gen._res_norm
        self._err = self.gen._err

    # ------------------------------------------------------------------
    def init_state(self):
        """initFieldsWithZero + InitRHS@finest + apply bc to Solution@finest
        (reference Function Application of the L4 example)."""
        return self.gen.init_state()

    def max_error(self, sol):
        return self._err(sol)

    # ------------------------------------------------------------------
    def solve(
        self,
        max_its: int = 100,
        target_res_reduction: float = 1e-10,
        out=None,
        print_error: bool = True,
    ):
        """Host-driven solve with the exact print sequence of Solve@finest
        (initial residual, then per cycle: max error, residual) in
        reduced precision — diffable against Testing/Poisson/*.results."""
        return self.gen.solve(
            out=out,
            max_its=max_its,
            target_res_reduction=target_res_reduction,
            print_error=print_error,
        )

    # ------------------------------------------------------------------
    def solve_fused(self, max_its: int = 100, target_res_reduction: float = 1e-10):
        """Fully device-resident solve (lax.while_loop, no host sync) —
        the production/benchmark path."""
        return self.gen.solve_fused(
            max_its=max_its, target_res_reduction=target_res_reduction
        )
