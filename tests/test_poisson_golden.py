"""Golden end-to-end test: 2D FD Poisson V(3,3)-cycle residual/error
sequence vs the reference's committed .results files.

Reference test mechanism: Testing/run_test.py (line-by-line compare,
numeric lines with EPS=1e-6); golden data
Testing/Poisson/2D_FD_Poisson_fromL4.results.
"""

import os

import pytest

pytestmark = pytest.mark.slow  # full-tier only (ci.sh quick gate skips)

from exastencils_jax.config import Knowledge
from exastencils_jax.models.poisson import PoissonMGSolver


def check_results(lines, expected_path, eps=1e-6):
    """Port of Testing/run_test.py:12-42 check_results."""
    with open(expected_path) as f:
        expected = [x.strip() for x in f.readlines()]
    assert len(lines) == len(expected), (
        f"line count mismatch: got {len(lines)} want {len(expected)}\n"
        + "\n".join(f"{g}\t{e}" for g, e in zip(lines, expected))
    )
    for got, want in zip(lines, expected):
        got, want = got.strip(), want.strip()
        if got != want:
            assert abs(float(got) - float(want)) <= eps, f"got {got!r} want {want!r}"


@pytest.fixture(scope="module")
def poisson_2d_solution():
    k = Knowledge(
        dimensionality=2,
        minLevel=0,
        maxLevel=8,
        domain_rect_numBlocks_x=2,
        domain_rect_numBlocks_y=2,
        domain_rect_numFragsPerBlock_x=2,
        domain_rect_numFragsPerBlock_y=2,
        testing_enabled=True,
    ).update()
    solver = PoissonMGSolver(k)
    sol, lines, init_res, cur_res, it = solver.solve(
        max_its=100, target_res_reduction=1e-10
    )
    return solver, sol, lines, init_res, cur_res, it


def test_golden_residual_sequence(poisson_2d_solution, reference_root):
    _, _, lines, *_ = poisson_2d_solution
    golden = os.path.join(
        reference_root, "Testing", "Poisson", "2D_FD_Poisson_fromL4.results"
    )
    check_results(lines, golden)


def test_converged(poisson_2d_solution):
    _, _, _, init_res, cur_res, it = poisson_2d_solution
    assert cur_res <= 1e-10 * init_res
    assert it <= 100


def test_discretization_error_floor(poisson_2d_solution):
    solver, sol, *_ = poisson_2d_solution
    err = float(solver.max_error(sol))
    # reference golden error floor ~2.887e-06 on the 1024^2 grid
    assert err < 5e-6
