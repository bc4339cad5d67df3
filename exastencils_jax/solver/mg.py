"""Geometric multigrid cycles.

Reference: the cycle assembled by the L3 solver generator
(solver/l3/L3_SolverForEquation.scala, cycle assembly in
L3_SolverForEqEntry; its expanded L4 form = mgCycle@* in
Examples/Poisson/2D_FD_Poisson_fromL4.exa4): pre-smooth, residual,
restrict, recurse (V/W/F), prolongate-correct, post-smooth, with a
Krylov solver on the coarsest level.

JAX shape: the level hierarchy is unrolled at trace time (levels
are static), so one `mg_cycle` call compiles to a single XLA program;
the only dynamic control flow is inside the coarse-grid Krylov
while_loop.  The solve driver offers both a host loop (prints per-cycle
residuals for golden-test parity) and a fully fused `lax.while_loop`
version for benchmarking.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Callable, Dict, Optional

import jax
import jax.numpy as jnp
from jax import lax

from exastencils_jax.core.grid import LevelGrid
from exastencils_jax.core.stencil import BoundStencil, IntergridStencil
from exastencils_jax.ops.reductions import dot, norm_l2
from exastencils_jax.ops.stencil_apply import apply_stencil, prolong, restrict


def _ident(x):
    return x


def _smooth_n(lv, n: int, sol, rhs):
    """n smoother iterations as a fori_loop — keeps the unrolled V-cycle
    HLO small (compile time matters on large grids; iterations are
    sequentially dependent, so nothing is lost to the loop barrier)."""
    if n <= 0:
        return sol
    if lv.smooth_n is not None:
        return lv.smooth_n(n, sol, rhs)
    if n == 1:
        return lv.smooth(sol, rhs)
    return lax.fori_loop(0, n, lambda _, s: lv.smooth(s, rhs), sol)


@dataclass
class MGLevelOps:
    """Everything the cycle needs on one level."""

    grid: LevelGrid
    shape: tuple
    A_apply: Callable  # sol -> A sol (exchange included where sharded)
    smooth: Callable  # sol, rhs -> sol (one full smoother iteration)
    bc_sol: Callable = _ident
    bc_res: Callable = _ident
    exchange: Callable = _ident  # halo exchange (identity on single chip)
    restrict_op: Optional[IntergridStencil] = None  # to next-coarser level
    prolong_op: Optional[IntergridStencil] = None  # from next-coarser level
    restrict_fn: Optional[Callable] = None  # overrides (sharded backend)
    prolong_fn: Optional[Callable] = None
    dot_fn: Callable = dot
    norm_fn: Callable = norm_l2
    # n-iteration smoother with k-wide halos exchanged once per k sweeps
    # (halo aggregation, the analog of the reference's
    # IR_ContractingLoop); overrides `smooth`
    smooth_n: Optional[Callable] = None  # (n, sol, rhs) -> sol


@dataclass
class Multigrid:
    """V/W/F-cycle over a static level hierarchy."""

    levels: Dict[int, MGLevelOps]
    min_level: int
    max_level: int
    coarse_solve: Callable  # (sol, rhs) -> sol
    n_pre: int = 3
    n_post: int = 3
    cycle_type: str = "V"  # V | W | F
    fas: bool = False
    # user hooks per stage (reference L3_SolverModification.scala:
    # prepend/append/replace statements per solver stage)
    modifications: Dict[str, Callable] = dc_field(default_factory=dict)

    # ------------------------------------------------------------------
    def residual(self, level: int, sol, rhs):
        lv = self.levels[level]
        return lv.bc_res(rhs - lv.A_apply(lv.exchange(sol)))

    def _hook(self, stage: str, level: int, sol, rhs):
        fn = self.modifications.get(stage)
        return fn(level, sol, rhs) if fn is not None else (sol, rhs)

    def cycle(self, sol, rhs, level: Optional[int] = None, kind: Optional[str] = None):
        """One multigrid cycle on `level` (default finest).

        kind: V = one recursion; W = two recursions (same kind);
        F = F-recursion followed by a V-recursion (Trottenberg F-cycle,
        the `mg_cycle = "F"` Knowledge option)."""
        level = self.max_level if level is None else level
        kind = self.cycle_type if kind is None else kind
        if kind not in ("V", "W", "F"):
            raise ValueError(f"unknown cycle type {kind!r} (V | W | F)")
        lv = self.levels[level]

        if level == self.min_level:
            return self.coarse_solve(sol, rhs)

        sol, rhs = self._hook("pre", level, sol, rhs)
        sol = _smooth_n(lv, self.n_pre, sol, rhs)

        coarse = self.levels[level - 1]

        def do_restrict(arr):
            if lv.restrict_fn is not None:
                return lv.restrict_fn(lv.exchange(arr))
            return restrict(lv.restrict_op, lv.exchange(arr), coarse.shape)

        def do_prolong(arr):
            if lv.prolong_fn is not None:
                return lv.prolong_fn(coarse.exchange(arr))
            return prolong(lv.prolong_op, coarse.exchange(arr), lv.shape)

        rhs_c = do_restrict(self.residual(level, sol, rhs))
        if self.fas:
            # FAS: tau-corrected coarse problem A_c(u_c) = R r + A_c(R u),
            # initial guess u_c = R u, correction P(u_c - R u)
            # (reference solver/l3/L3_SolverForEquation.scala:401-452)
            sol_c0 = coarse.bc_sol(do_restrict(sol))
            rhs_c = rhs_c + coarse.A_apply(coarse.exchange(sol_c0))
            sol_c = sol_c0
        else:
            sol_c = coarse.bc_sol(jnp.zeros(coarse.shape, rhs_c.dtype))

        if level - 1 > self.min_level and kind in ("W", "F"):
            recurse_kinds = ("W", "W") if kind == "W" else ("F", "V")
        else:
            recurse_kinds = (kind,)
        for rk in recurse_kinds:
            sol_c = self.cycle(sol_c, rhs_c, level - 1, kind=rk)

        corr = do_prolong(sol_c - sol_c0) if self.fas else do_prolong(sol_c)
        sol = lv.bc_sol(sol + corr)
        sol = _smooth_n(lv, self.n_post, sol, rhs)
        sol, rhs = self._hook("post", level, sol, rhs)
        return sol

    # ------------------------------------------------------------------
    def fmg(self, rhs_fine, restrict_rhs: Callable = None, start_level: int = None):
        """Full multigrid: restrict the rhs down, solve coarsest, then
        prolongate + cycle per level upward (reference FMG branch of the
        L3 cycle assembly; Testing/FMG goldens)."""
        start = self.min_level if start_level is None else start_level
        # restrict rhs down the hierarchy
        rhs_per_level = {self.max_level: rhs_fine}
        for lvl in range(self.max_level, start, -1):
            lv = self.levels[lvl]
            coarse = self.levels[lvl - 1]
            r = lv.exchange(rhs_per_level[lvl])
            if lv.restrict_fn is not None:
                rhs_per_level[lvl - 1] = lv.restrict_fn(r)
            else:
                rhs_per_level[lvl - 1] = restrict(lv.restrict_op, r, coarse.shape)

        lv0 = self.levels[start]
        sol = lv0.bc_sol(jnp.zeros(lv0.shape, rhs_fine.dtype))
        sol = (
            self.coarse_solve(sol, rhs_per_level[start])
            if start == self.min_level
            else self.cycle(sol, rhs_per_level[start], start)
        )
        for lvl in range(start + 1, self.max_level + 1):
            lv = self.levels[lvl]
            coarse = self.levels[lvl - 1]
            if lv.prolong_fn is not None:
                sol = lv.prolong_fn(coarse.exchange(sol))
            else:
                sol = prolong(lv.prolong_op, coarse.exchange(sol), lv.shape)
            sol = lv.bc_sol(sol)
            sol = self.cycle(sol, rhs_per_level[lvl])
        return sol

    # ------------------------------------------------------------------
    def res_norm(self, sol, rhs, level: Optional[int] = None):
        level = self.max_level if level is None else level
        return self.levels[level].norm_fn(self.residual(level, sol, rhs))

    def solve(
        self,
        sol,
        rhs,
        target_res_reduction: float = 1e-5,
        max_its: int = 128,
        callback: Callable = None,
        jit: bool = True,
        cycle_fn: Callable = None,
        res_norm_fn: Callable = None,
    ):
        """Host-driven solve loop matching Solve@finest of the L4 Poisson
        example: compute initial residual, cycle until
        `curRes <= eps * initRes` or `max_its`, with `callback(it, sol,
        cur_res)` after every cycle (used for residual/error printing).

        Sharded backends pass pre-wrapped (shard_mapped) `cycle_fn` /
        `res_norm_fn`; tracing `self.cycle` directly is only valid on the
        dense single-chip representation."""
        cycle = cycle_fn or (jax.jit(lambda s, r: self.cycle(s, r)) if jit else self.cycle)
        res_norm = res_norm_fn or (
            jax.jit(lambda s, r: self.res_norm(s, r)) if jit else self.res_norm
        )

        init_res = res_norm(sol, rhs)
        cur_res = init_res
        it = 0
        while it < max_its and not bool(cur_res <= target_res_reduction * init_res):
            it += 1
            sol = cycle(sol, rhs)
            cur_res = res_norm(sol, rhs)
            if callback is not None:
                callback(it, sol, cur_res)
        return sol, init_res, cur_res, it

    def solve_jit(self, sol, rhs, target_res_reduction: float = 1e-5, max_its: int = 128):
        """Fully device-resident solve (`repeat until` as lax.while_loop
        with donated carries — no host sync per cycle).  This is the
        benchmarking / production path."""
        init_res = self.res_norm(sol, rhs)

        def cond(c):
            it, _, cur = c
            return jnp.logical_and(it < max_its, cur > target_res_reduction * init_res)

        def body(c):
            it, sol, _ = c
            sol = self.cycle(sol, rhs)
            return (it + 1, sol, self.res_norm(sol, rhs))

        it, sol, cur = lax.while_loop(cond, body, (jnp.int32(0), sol, init_res))
        return sol, init_res, cur, it
