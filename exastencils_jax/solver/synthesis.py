"""Solver synthesis — the L3 `generate solver for u in uEq` expansion.

Reference: solver/l3/L3_SolverForEquation.scala:52 (options are applied
onto Knowledge via UniversalSetter :84-99, fields gen_rhs/gen_residual
are declared per level :164-177, restriction/prolongation generated per
localization :132-162, smoother selected/colored/damped, the cycle is
assembled with the chosen coarse-grid solver) and
L3_IterativeSolverForEquation / L3_SolverForEqEntry for the outer
`repeat until` driver; user modifications per stage follow
L3_SolverModification.scala (prepend/append/replace).

JAX form: instead of emitting L4 functions, synthesis assembles a
`Multigrid` over backend handles; the result is a jit-compiled XLA
program per cycle.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Callable, Dict, Optional, Union

import jax.numpy as jnp

from exastencils_jax.config import Knowledge
from exastencils_jax.core.field import Field
from exastencils_jax.core.grid import CELL, FACES, NODE
from exastencils_jax.core.stencil import (
    IntergridStencil,
    Stencil,
    cell_prolongation,
    cell_restriction,
    node_prolongation,
    node_restriction,
)
from exastencils_jax.ops.smoothers import make_smoother
from exastencils_jax.ops.stencil_apply import apply_stencil
from exastencils_jax.solver.krylov import SOLVERS
from exastencils_jax.solver.mg import Multigrid, MGLevelOps
from exastencils_jax.utils.printing import reduced_prec_str


@dataclass
class Equation:
    """A (for now linear, scalar) discrete equation  A u = f  per level.

    `operator` is a Stencil (grid-dependent coefficients allowed) or a
    mapping level -> Stencil (reference: leveled stencil declarations)."""

    unknown: Field
    operator: Union[Stencil, Dict[int, Stencil]]
    rhs_fn: Optional[Callable] = None  # f(x, y[, z]) at finest

    def stencil_at(self, level: int) -> Stencil:
        if isinstance(self.operator, dict):
            return self.operator[level]
        return self.operator


def default_transfer_ops(localization: str, ndim: int,
                         interpolation: str = "linear"):
    """Reference L3_DefaultRestriction/Prolongation.generate per field
    localization (node/cell) and interpolation kind: restriction uses
    'integral_linear' (summing) for FV/FE integral residuals and
    'linear' (averaging) for FD (L3_SolverForEquation.scala:133-139)."""
    from exastencils_jax.core.stencil import (
        cell_restriction_integral,
        face_prolongation,
        face_restriction,
        node_restriction_integral,
    )

    integral = interpolation == "integral_linear"
    if localization == NODE:
        r = node_restriction_integral(ndim) if integral else node_restriction(ndim)
        return r, node_prolongation(ndim)
    if localization == CELL:
        r = cell_restriction_integral(ndim) if integral else cell_restriction(ndim)
        return r, cell_prolongation(ndim)
    if localization in FACES:
        d = FACES.index(localization)
        return (face_restriction(d, ndim, integral),
                face_prolongation(d, ndim, integral))
    raise ValueError(f"no default transfer ops for localization {localization!r}")


@dataclass
class GeneratedSolver:
    """Output of generate_solver: a ready multigrid solver plus the
    solve driver with reference-compatible printing."""

    knowledge: Knowledge
    equation: Equation
    backend: object
    mg: Multigrid
    residual_field: Field
    error_fn: Optional[Callable] = None  # exact solution for PrintError

    def __post_init__(self):
        b = self.backend
        # donate the iterate: the cycle's output replaces it, so XLA
        # reuses its buffer instead of copying the non-donated input
        self._cycle = b.wrap(self.mg.cycle, ("field", "field"), "field",
                             donate_argnums=(0,))
        self._res_norm = b.wrap(self.mg.res_norm, ("field", "field"), "scalar")
        if self.knowledge.solver_useFMG:
            self._fmg = b.wrap(
                lambda r: self.mg.fmg(r, start_level=self.knowledge.solver_fmg_startLevel),
                ("field",),
                "field",
            )
        if self.error_fn is not None:
            self._err = b.wrap(self._max_error_local, ("field",), "scalar")

    # ------------------------------------------------------------------
    def _max_error_local(self, sol):
        h = self.backend.handle(self.knowledge.maxLevel)
        exact = self.error_fn(*h.coords())
        return h.norm_max(sol - exact)

    def init_state(self):
        k = self.knowledge
        lv = self.mg.levels[k.maxLevel]
        b = self.backend
        dtype = k.real_dtype

        def build():
            h = b.handle(k.maxLevel)
            sol = lv.bc_sol(h.zeros(dtype))
            rhs = h.init_field_local(self.equation.rhs_fn, dtype)
            return sol, rhs

        return b.wrap(build, (), ("field", "field"))()

    def solve(self, out=None, max_its=None, target_res_reduction=None, print_error=None):
        """`repeat until curRes <= eps * initRes` driver with reduced-
        precision printing under testing_enabled (reference
        L3_IterativeSolverForEquation + Solve@finest shape)."""
        k = self.knowledge
        max_its = k.solver_maxNumIts if max_its is None else max_its
        eps = k.solver_targetResReduction if target_res_reduction is None else target_res_reduction
        if print_error is None:
            print_error = self.error_fn is not None and (
                not k.testing_enabled or k.testing_printErr
            )

        lines = []
        emit = out if out is not None else lines.append
        sol, rhs = self.init_state()

        if k.solver_useFMG:
            sol = self._fmg(rhs)

        def callback(it, s, cur_res):
            if not k.solver_printAllResiduals:
                return  # reference: per-iteration prints are optional
            if print_error:
                emit(reduced_prec_str(float(self._err(s)), k.testing_maxPrecision, k.testing_zeroThreshold))
            emit(reduced_prec_str(float(cur_res), k.testing_maxPrecision, k.testing_zeroThreshold))

        res0 = self._res_norm(sol, rhs)
        emit(reduced_prec_str(float(res0), k.testing_maxPrecision, k.testing_zeroThreshold))
        sol, init_res, cur_res, it = self.mg.solve(
            sol, rhs, eps, max_its, callback,
            cycle_fn=self._cycle, res_norm_fn=self._res_norm,
        )
        return sol, lines, float(init_res), float(cur_res), it

    def export(self) -> "ExportedSolver":
        """Embedding interface — the JAX analog of the
        reference's external-field/Fortran interfacing
        (interfacing/ir/IR_ExternalField.scala,
        IR_CopyToExternalField.scala, IR_Fortranify.scala): a host
        application that owns its own arrays drives the solver without
        touching framework internals.  See ExportedSolver for the
        copy-in/copy-out and donation contract."""
        return ExportedSolver(self)

    def solve_fused(self, max_its=None, target_res_reduction=None):
        k = self.knowledge
        max_its = k.solver_maxNumIts if max_its is None else max_its
        eps = k.solver_targetResReduction if target_res_reduction is None else target_res_reduction
        sol, rhs = self.init_state()
        fused = self.backend.wrap(
            lambda s, r: self.mg.solve_jit(s, r, eps, max_its),
            ("field", "field"),
            ("field", "scalar", "scalar", "scalar"),
        )
        return fused(sol, rhs)


class ExportedSolver:
    """Embeddable view of a generated solver for host applications that
    own their field data as plain (numpy) arrays — the reference's
    `external Field` + copy-to/from functions re-expressed for JAX
    (interfacing/ir/IR_ExternalField.scala:…, IR_CopyToExternalField).

    Contract:
      * `solve(rhs, u0=None, ...) -> numpy`: copy-in / copy-out — the
        caller's arrays are never aliased or mutated; shapes are the
        solver's finest-level node shape (`self.shape`).  On a sharded
        backend the global array is scattered across the mesh on entry
        and gathered on exit.
      * `step` is the raw jitted cycle `(sol, rhs) -> sol` on DEVICE
        arrays with the iterate DONATED: after `s1 = step(s0, rhs)` the
        buffer `s0` is consumed; callers keeping `s0` must copy
        it first.  This is the zero-copy fast path for hosts that live
        in jax.
    """

    def __init__(self, gen: GeneratedSolver):
        self._g = gen
        self.knowledge = gen.knowledge
        h = gen.backend.handle(gen.knowledge.maxLevel)
        if getattr(gen.backend, "is_sharded", False):
            from exastencils_jax.core.grid import NODE

            self.shape = tuple(h.grid.shape_of(NODE))  # global node array
        else:
            self.shape = tuple(h.work_shape)
        self.dtype = gen.knowledge.real_dtype
        self.step = gen._cycle  # donation: see class docstring
        self.residual_norm = gen._res_norm

    # ---- numpy bridge (copy-in / copy-out) ----
    def _to_device(self, arr):
        import numpy as _np

        b = self._g.backend
        a = jnp.asarray(_np.asarray(arr), dtype=self.dtype)
        if getattr(b, "is_sharded", False):
            lvl = self.knowledge.maxLevel
            scatter = b.wrap(
                lambda x: b.scatter_local(lvl, x), ("replicated",), "field"
            ) if hasattr(b, "scatter_local") else None
            if scatter is not None:
                return scatter(a)
        return a

    def _to_numpy(self, arr):
        import numpy as _np

        b = self._g.backend
        if getattr(b, "is_sharded", False):
            lvl = self.knowledge.maxLevel
            gather = b.wrap(
                lambda x: b.gather_global(lvl, x), ("field",), "replicated"
            )
            arr = gather(arr)
        return _np.asarray(arr)

    def solve(self, rhs, u0=None, target_res_reduction=None, max_its=None):
        """Run the generated solve loop on caller-owned arrays; returns
        (solution numpy array, iterations, final relative residual)."""
        import numpy as _np

        k = self.knowledge
        eps = (k.solver_targetResReduction
               if target_res_reduction is None else target_res_reduction)
        max_its = k.solver_maxNumIts if max_its is None else max_its
        rhs_d = self._to_device(rhs)
        lv = self._g.mg.levels[k.maxLevel]
        if u0 is None:
            sol0, _ = self._g.init_state()
        else:
            sol0 = self._g.backend.wrap(
                lambda x: lv.bc_sol(x), ("field",), "field"
            )(self._to_device(u0))
        sol, init_res, cur_res, it = self._g.mg.solve(
            sol0, rhs_d, eps, max_its,
            cycle_fn=self.step, res_norm_fn=self.residual_norm,
        )
        rel = float(cur_res) / max(float(init_res), 1e-300)
        return self._to_numpy(sol), it, rel


def generate_solver(
    equation: Equation,
    knowledge: Knowledge,
    backend,
    grids,
    options: Dict = None,
    modifications: Dict[str, Callable] = None,
    residual_bc=0.0,
    error_fn: Callable = None,
    restrict_op: IntergridStencil = None,
    prolong_op: IntergridStencil = None,
) -> GeneratedSolver:
    """Expand `generate solver for u in eq with {options} modifiers {...}`.

    `options` are Knowledge keys without the `solver_` prefix or full
    keys, applied UniversalSetter-style (reference
    L3_SolverForEquation.scala:84-99)."""
    k = knowledge
    for key, val in (options or {}).items():
        full = key if hasattr(k, key) else f"solver_{key}"
        k.set(full, val)
    k.update()

    u = equation.unknown
    nd = u.domain.ndim
    if restrict_op is None or prolong_op is None:
        r_d, p_d = default_transfer_ops(u.localization, nd)
        restrict_op = restrict_op or r_d
        prolong_op = prolong_op or p_d

    residual_field = Field("gen_residual", u.domain, u.localization, bc=residual_bc)

    smoother_kind = k.solver_smoother
    omega = k.solver_smoother_damping
    coloring_kind = k.solver_smoother_coloring
    if smoother_kind in ("RBGS", "GaussSeidel", "GS") and not coloring_kind:
        # lexicographic GS has no data-parallel order; red-black is the
        # canonical equivalent (documented deviation from the reference's
        # sequential in-fragment GS)
        coloring_kind = "red-black"

    num_colors = {"": 0, "red-black": 2, "4-way": 4, "9-way": 9, "27-way": 27}.get(
        coloring_kind, 2
    )

    levels: Dict[int, MGLevelOps] = {}
    for lvl in range(k.minLevel, k.maxLevel + 1):
        g = grids[lvl]
        h = backend.handle(lvl)
        A = equation.stencil_at(lvl).bind(g)
        bc_sol = h.bc_applier(u, lvl)
        bc_res = h.bc_applier(residual_field, lvl)
        coloring = None
        if num_colors == 2:
            coloring = h.color_masks(2)
        elif num_colors in (4, 9, 27):
            base = round(num_colors ** (1.0 / nd))

            def color_fn_nd(*idx, base=base):
                expr = 0
                for d, i in enumerate(idx):
                    expr = expr * base + (i % base)
                return expr

            coloring = h.color_masks(num_colors, color_fn=color_fn_nd)
        smooth = make_smoother(
            A, bc_sol, exchange=h.exchange, omega=omega, coloring=coloring
        )
        smooth_n = None
        # sharded-path communication structure (reference IR_SplitLoops /
        # halo aggregation): overlap interior compute with the halo
        # ppermutes, and/or widen the halo to k layers exchanged once
        # per k half-sweeps
        if backend.is_sharded and hasattr(h, "topo"):
            from exastencils_jax.ops.smoothers import (
                is_star_radius1,
                make_aggregated_smoother,
                make_overlap_smoother,
            )

            if k.overlap_halo and is_star_radius1(A):
                smooth = make_overlap_smoother(
                    A, bc_sol, h.topo, h.local_cells, omega, coloring
                )
            if k.comm_haloAggregationFactor > 1 and is_star_radius1(A):
                smooth_n = make_aggregated_smoother(
                    A, bc_sol, h.topo, h.local_cells, omega, coloring,
                    k.comm_haloAggregationFactor,
                )
        restrict_fn = prolong_fn = None
        if lvl > k.minLevel:
            restrict_fn, prolong_fn = backend.transfer_fns(lvl, restrict_op, prolong_op)
        levels[lvl] = MGLevelOps(
            grid=g,
            shape=h.work_shape,
            A_apply=(lambda x, A=A: apply_stencil(A, x)),
            smooth=smooth,
            bc_sol=bc_sol,
            bc_res=bc_res,
            exchange=h.exchange,
            restrict_fn=restrict_fn,
            prolong_fn=prolong_fn,
            dot_fn=h.dot,
            norm_fn=h.norm_l2,
            smooth_n=smooth_n,
        )

    if k.performance_printEstimation:
        # reference IR_EvaluatePerformanceEstimates (performance/ir): a
        # bandwidth-bound time estimate per level's smoother sweep,
        # printed at solver-construction time
        import logging
        import math as _math

        from exastencils_jax.runtime.performance import device_spec

        log = logging.getLogger("exastencils_jax")
        try:
            bw = device_spec().hbm_bytes_per_s
        except KeyError as e:  # no data-sheet rate for this device
            log.info("perf estimate: none (%s)", e)
        else:
            itemsize = jnp.dtype(k.real_dtype).itemsize
            for lvl in sorted(levels, reverse=True):
                pts = _math.prod(levels[lvl].shape)
                passes = 2 if levels[lvl].smooth_n is not None else 3
                t_ms = passes * pts * itemsize / bw * 1e3
                log.info(
                    "perf estimate L%d: %d points, smoother sweep ~%.4f ms "
                    "(%d array passes @ %.0f GB/s HBM, data sheet)",
                    lvl, pts, t_ms, passes, bw / 1e9,
                )

    lv0 = levels[k.minLevel]
    if k.solver_cgs == "Smoother":
        def coarse_solve(sol, rhs, lv0=lv0):
            for _ in range(k.solver_cgs_maxNumIts):
                sol = lv0.smooth(sol, rhs)
            return sol
    else:
        krylov = SOLVERS[k.solver_cgs]
        extra = {}
        if k.solver_cgs_restart and k.solver_cgs in ("BiCGStab",):
            extra["restart_after"] = k.solver_cgs_restartAfter

        def coarse_solve(sol, rhs, lv0=lv0):
            return krylov(
                lambda p: lv0.A_apply(lv0.exchange(p)),
                sol,
                rhs,
                bc_sol=lv0.bc_sol,
                bc_res=lv0.bc_res,
                max_its=k.solver_cgs_maxNumIts,
                res_reduction=k.solver_cgs_targetResReduction,
                dot_fn=lv0.dot_fn,
                norm_fn=lv0.norm_fn,
                **extra,
            ).sol

    mg = Multigrid(
        levels=levels,
        min_level=k.minLevel,
        max_level=k.maxLevel,
        coarse_solve=coarse_solve,
        n_pre=k.solver_smoother_numPre,
        n_post=k.solver_smoother_numPost,
        cycle_type=k.mg_cycle,
        fas=k.solver_useFAS,
        modifications=modifications or {},
    )
    return GeneratedSolver(
        knowledge=k,
        equation=equation,
        backend=backend,
        mg=mg,
        residual_field=residual_field,
        error_fn=error_fn,
    )
