"""Non-uniform grids: `grid_spacingModel = "linearFct"` (reference
grid/ir/IR_SetupNodePositions.scala:128-231 for_AA_LinearFct + coarse
restriction for_AA_restrictFromFiner) — the stretched axis-aligned grid
with an 8:1 largest:smallest cell-width ratio — must feed vf_* and
position-dependent stencil coefficients, and a stretched-grid Poisson
solve must converge at second order."""

import numpy as np
import pytest

import jax.numpy as jnp

from exastencils_jax.config import Knowledge
from exastencils_jax.core.domain import unit_domain
from exastencils_jax.core.field import DirichletBC, Field
from exastencils_jax.core.grid import (
    NODE,
    level_grids,
    linearfct_node_positions,
)
from exastencils_jax.core.stencil import (
    Stencil,
    node_prolongation,
    node_restriction,
)
from exastencils_jax.parallel.backend import DenseBackend
from exastencils_jax.solver.synthesis import Equation, generate_solver


def test_linearfct_positions_properties():
    p = linearfct_node_positions(0.0, 1.0, 64)
    assert p[0] == pytest.approx(0.0, abs=1e-14)
    assert p[-1] == pytest.approx(1.0, rel=1e-12)
    w = np.diff(p)
    assert np.all(w > 0)
    # the reference fixes the largest:smallest cell-width ratio to 8
    assert w.max() / w.min() == pytest.approx(8.0, rel=0.15)
    # middle-zone spacing is constant
    assert np.allclose(w[20:44], w[32], rtol=1e-12)


def test_level_grids_restrict_positions():
    k = Knowledge(dimensionality=2, minLevel=3, maxLevel=5,
                  grid_spacingModel="linearFct", grid_isUniform=False).update()
    grids = level_grids(unit_domain(2), k)
    fine = np.asarray(grids[5].node_pos_1d(0))
    coarse = np.asarray(grids[4].node_pos_1d(0))
    np.testing.assert_allclose(coarse, fine[::2])
    assert not grids[5].is_uniform and not grids[3].is_uniform


def _stretched_laplacian(nd):
    """-Laplace with the exact 3-point non-uniform FD formula per dim:
    position-dependent coefficients read the grid's node positions."""

    def hl_hr(grid, d):
        p = np.asarray(grid.node_pos_1d(d))
        hl = np.empty_like(p)
        hr = np.empty_like(p)
        hl[1:] = np.diff(p)
        hr[:-1] = np.diff(p)
        hl[0] = hl[1]
        hr[-1] = hr[-2]  # boundary rows are bc-masked, value irrelevant
        return hl, hr

    def bshape(grid, d, arr):
        shape = [1] * grid.ndim
        shape[d] = arr.shape[0]
        return jnp.asarray(arr.reshape(shape))

    st = Stencil("StretchedLaplace")

    def center(grid):
        c = 0.0
        for d in range(grid.ndim):
            hl, hr = hl_hr(grid, d)
            c = c + bshape(grid, d, 2.0 / (hl * hr))
        return c

    st.add_entry((0,) * nd, center)
    for d in range(nd):
        for s, side in ((-1, "l"), (+1, "r")):
            off = tuple(s if i == d else 0 for i in range(nd))

            def coef(grid, d=d, side=side):
                hl, hr = hl_hr(grid, d)
                h = hl if side == "l" else hr
                return bshape(grid, d, -2.0 / (h * (hl + hr)))

            st.add_entry(off, coef)
    return st


def _solve_error(max_level):
    k = Knowledge(dimensionality=2, minLevel=2, maxLevel=max_level,
                  grid_spacingModel="linearFct", grid_isUniform=False).update()
    dom = unit_domain(2)
    grids = level_grids(dom, k)
    backend = DenseBackend(grids)
    u = Field("U", dom, NODE, bc=DirichletBC(0.0))

    def exact(x, y):
        return jnp.sin(jnp.pi * x) * jnp.sin(jnp.pi * y)

    def rhs(x, y):
        return 2.0 * jnp.pi ** 2 * exact(x, y)

    eq = Equation(u, _stretched_laplacian(2), rhs_fn=rhs)
    gen = generate_solver(
        eq, k, backend, grids,
        options={"smoother": "RBGS", "smoother_damping": 0.8,
                 "targetResReduction": 1e-10, "maxNumIts": 30},
        restrict_op=node_restriction(2), prolong_op=node_prolongation(2),
    )
    sol, _, res0, resN, it = gen.solve()
    assert resN < 1e-9 * res0, f"stretched-grid MG failed: {res0} -> {resN}"
    g = grids[max_level]
    xx, yy = g.coord_mesh(NODE)
    err = jnp.max(jnp.abs(sol - exact(xx, yy)))
    return float(err)


def test_stretched_poisson_second_order():
    e_coarse = _solve_error(5)  # 32^2 cells
    e_fine = _solve_error(6)  # 64^2 cells
    ratio = e_coarse / e_fine
    # 2nd-order discretization: error drops ~4x per refinement
    assert ratio > 3.2, f"convergence order too low: ratio {ratio}"


def test_dsl_vf_gridwidth_guard():
    """DSL stencils whose coefficients read vf_gridWidth must refuse to
    silently use the mean width on a stretched grid."""
    from exastencils_jax.dsl.interpreter import L4Executable
    from exastencils_jax.dsl.parser import parse_l4

    src = """
Domain dom< [0.0, 0.0] to [1.0, 1.0] >
Layout L< Real, Node >@all { duplicateLayers = [1, 1] ghostLayers = [0, 0] }
Field U< dom, L, 0.0 >@all
Stencil A@all {
\t[0, 0] => 2.0 / ( vf_gridWidth_x * vf_gridWidth_x )
\t[-1, 0] => -1.0 / ( vf_gridWidth_x * vf_gridWidth_x )
\t[1, 0] => -1.0 / ( vf_gridWidth_x * vf_gridWidth_x )
}
Function Application {
\tloop over U@finest {
\t\tU@finest = A@finest * U@finest
\t}
}
"""
    k = Knowledge(dimensionality=2, minLevel=2, maxLevel=4,
                  grid_spacingModel="linearFct", grid_isUniform=False, shard_dsl=False).update()
    ex = L4Executable(parse_l4(src), k, out=lambda s: None)
    with pytest.raises(NotImplementedError):
        ex.run("Application")
