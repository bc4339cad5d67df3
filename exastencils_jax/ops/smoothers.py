"""Smoother sweeps on dense level arrays.

Reference: the L3 solver generator's smoother synthesis
(solver/l3/L3_SolverForEquation.scala smoother generation; coloring via
the L4 `color with { (i0+i1) % 2, ... }` construct) — damped Jacobi,
red-black Gauss-Seidel (as colored Jacobi half-sweeps), and multi-color
variants.

Global parity: color masks are computed from *global* indices so shard
boundaries keep red/black phase consistency (SURVEY.md §7 hard parts);
`index_offset` lets the sharded backend pass each shard's global origin.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import jax.numpy as jnp
from jax import lax

from exastencils_jax.core.stencil import BoundStencil
from exastencils_jax.ops.stencil_apply import apply_stencil


def color_mask(
    shape: Tuple[int, ...],
    color: int,
    num_colors: int = 2,
    index_offset: Tuple[int, ...] = None,
    color_fn: Callable = None,
) -> jnp.ndarray:
    """Mask of DOFs with `(sum_d i_d) % num_colors == color` (default), or a
    custom `color_fn(*index_grids) % num_colors == color`."""
    nd = len(shape)
    if index_offset is None:
        index_offset = (0,) * nd
    grids = [
        lax.broadcasted_iota(jnp.int32, shape, d) + index_offset[d] for d in range(nd)
    ]
    expr = color_fn(*grids) if color_fn is not None else sum(grids)
    return (expr % num_colors) == color


def jacobi_update(
    sol: jnp.ndarray,
    rhs: jnp.ndarray,
    A: BoundStencil,
    omega: float,
    mask: jnp.ndarray = None,
) -> jnp.ndarray:
    """sol += omega / diag(A) * (rhs - A sol), optionally only where `mask`.

    Matches the generated smoother loop body
    `Solution += omega / diag(L) * (RHS - L * Solution)` (SURVEY.md §3.3
    hot loop); the caller re-applies bc afterwards, mirroring the
    `loop ...; apply bc` statement pair."""
    corr = (omega / A.diag()) * (rhs - apply_stencil(A, sol))
    if mask is None:
        return sol + corr
    return jnp.where(mask, sol + corr, sol)


def make_smoother(
    A: BoundStencil,
    bc_apply: Callable,
    exchange: Callable = None,
    omega: float = 1.0,
    coloring: Sequence[jnp.ndarray] = None,
):
    """One smoother iteration sol, rhs -> sol.

    coloring = None      : damped Jacobi (single masked-free update)
    coloring = [m0, m1]  : colored Gauss-Seidel — one masked Jacobi
                           half-sweep per color with halo exchange + bc
                           between colors, exactly the expansion of the
                           reference's `color with` loop."""
    exchange = exchange or (lambda x: x)

    if coloring is None:

        def smooth(sol, rhs):
            sol = exchange(sol)
            sol = jacobi_update(sol, rhs, A, omega)
            return bc_apply(sol)

        return smooth

    def smooth_colored(sol, rhs):
        for mask in coloring:
            if callable(mask):
                mask = mask()  # trace-time mask construction (iota-based)
            sol = exchange(sol)
            sol = jacobi_update(sol, rhs, A, omega, mask)
            sol = bc_apply(sol)
        return sol

    return smooth_colored


def is_star_radius1(A: BoundStencil) -> bool:
    """Axis-only offsets of magnitude <= 1 with scalar coefficients —
    the contract for the split-exchange overlap path (no corner reads)."""
    for off, c in zip(A.offsets, A.coefs):
        if hasattr(c, "shape") and getattr(c, "shape", ()) != ():
            return False
        nz = [o for o in off if o != 0]
        if len(nz) > 1 or (nz and abs(nz[0]) != 1):
            return False
    return True


def make_overlap_smoother(
    A: BoundStencil,
    bc_apply: Callable,
    topo,
    local_cells: Tuple[int, ...],
    omega: float = 1.0,
    coloring: Sequence = None,
):
    """Smoother with communication/compute overlap (`overlap_halo`).

    The reference splits `communicate` into begin/finish and each loop
    into an interior part (overlapped with the async exchange) and a
    boundary part (communication/ir/IR_Communicate.scala:31,
    IR_SplitLoops.scala, flags config/Knowledge.scala:800-804).  Here:
    all neighbor ppermutes are issued from the pre-update array
    (exchange_start), the interior update — data-independent of them —
    runs concurrently, then the received slabs land and only the dup
    planes (the sole points whose radius-1 star stencil reads ghosts)
    recompute via 3-plane slabs: O(surface) extra work, bitwise-equal
    values to the fused-exchange smoother."""
    assert is_star_radius1(A), "overlap smoother needs a radius-1 star stencil"
    nd = topo.ndim
    masks = list(coloring) if coloring is not None else [None]
    g = topo.ghost

    def one_color(sol, rhs, mask):
        shell = topo.dup_plane_mask(sol.shape, local_cells)
        if shell is None:  # no sharded dim: plain update
            sol = jacobi_update(sol, rhs, A, omega, mask)
            return bc_apply(sol)
        slabs = topo.exchange_start(sol, local_cells)
        interior_m = jnp.logical_not(shell)
        if mask is not None:
            interior_m = jnp.logical_and(mask, interior_m)
        corr = (omega / A.diag()) * (rhs - apply_stencil(A, sol))
        sol_read = topo.exchange_finish(sol, slabs, local_cells)
        out = topo.exchange_finish(
            jnp.where(interior_m, sol + corr, sol), slabs, local_cells
        )
        # boundary shell: dup planes recomputed from 3-plane slabs of the
        # pre-update values + fresh ghosts; points on an earlier dim's
        # dup plane are excluded so every point updates exactly once
        for d in range(nd):
            if topo.P[d] == 1:
                continue
            for plane in (g, g + local_cells[d]):
                sl3 = tuple(
                    slice(plane - 1, plane + 2) if i == d else slice(None)
                    for i in range(nd)
                )
                slc = tuple(
                    slice(1, 2) if i == d else slice(None) for i in range(nd)
                )
                pl = tuple(
                    slice(plane, plane + 1) if i == d else slice(None)
                    for i in range(nd)
                )
                corr_c = (
                    (omega / A.diag())
                    * (rhs[pl] - apply_stencil(A, sol_read[sl3])[slc])
                )
                cur = out[pl]
                sel = jnp.ones(cur.shape, bool) if mask is None else mask[pl]
                for dp in range(d):
                    if topo.P[dp] == 1:
                        continue
                    i2 = lax.broadcasted_iota(jnp.int32, cur.shape, dp)
                    on_dp = jnp.logical_or(
                        i2 == g, i2 == g + local_cells[dp]
                    )
                    sel = jnp.logical_and(sel, jnp.logical_not(on_dp))
                out = out.at[pl].set(
                    jnp.where(sel, sol_read[pl] + corr_c, cur)
                )
        return bc_apply(out)

    def smooth(sol, rhs):
        for mask in masks:
            if callable(mask):
                mask = mask()
            sol = one_color(sol, rhs, mask)
        return sol

    return smooth


def make_aggregated_smoother(
    A: BoundStencil,
    bc_apply: Callable,
    topo,
    local_cells: Tuple[int, ...],
    omega: float,
    coloring: Sequence,
    factor: int,
):
    """k-wide-halo smoother (`comm_haloAggregationFactor = k`): ghost
    width k, ONE halo exchange per k half-sweeps.  Between exchanges the
    valid zone shrinks one ghost layer per half-sweep — by construction
    it never reaches the dup planes, so interior+dup values stay
    bitwise-equal to the exchange-every-color smoother (reference:
    wider halos traded against exchange frequency, the aggregation knob
    of config/Knowledge.scala; temporal analog of IR_ContractingLoop).

    The rhs is exchanged once per n-sweep block: ghost-zone updates need
    the neighbor's rhs values to reproduce its interior results."""
    assert topo.ghost >= max(1, factor), (
        f"ghost width {topo.ghost} < aggregation factor {factor}"
    )
    masks = list(coloring) if coloring is not None else [None]
    ncol = len(masks)
    per_ex = max(1, factor // ncol)

    def smooth_n(n, sol, rhs):
        rhsx = topo.exchange(rhs, local_cells)
        done = 0
        while done < n:
            k = min(per_ex, n - done)
            sol = topo.exchange(sol, local_cells)
            for _ in range(k):
                for mask in masks:
                    if callable(mask):
                        mask = mask()
                    sol = jacobi_update(sol, rhsx, A, omega, mask)
                    sol = bc_apply(sol)
            done += k
        return sol

    return smooth_n
