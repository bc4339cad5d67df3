"""ExaSlang-4 frontend: parse + execute the reference's own example
files and match the Python-API solver output (which itself matches the
reference goldens digit-for-digit)."""

import os

import pytest

from exastencils_jax.config import Knowledge
from exastencils_jax.dsl.parser import parse_l4
from exastencils_jax.dsl.interpreter import L4Executable
from exastencils_jax.dsl import nodes as N
from exastencils_jax.models.poisson import PoissonMGSolver

EXA4 = "/root/reference/Examples/Poisson/2D_FD_Poisson_fromL4.exa4"


@pytest.fixture(scope="module")
def poisson_ast(reference_root):
    return parse_l4(EXA4)


def test_parse_reference_poisson(poisson_ast):
    p = poisson_ast
    assert [d.name for d in p.domains] == ["global"]
    assert {f.name for f in p.fields} == {"Solution", "RHS", "Residual", "cgTmp0", "cgTmp1"}
    st = {s.name for s in p.stencils}
    assert st == {"Laplace", "NodeRestriction", "NodeProlongation"}
    fn = {f.name for f in p.functions}
    assert {"ResNorm", "PrintError", "Solve", "mgCycle", "InitRHS", "Application"} <= fn


def test_level_specs():
    assert N.LvlAll().resolve(0, 4) == [0, 1, 2, 3, 4]
    assert N.LvlAllBut(N.LvlAll(), N.LvlFinest()).resolve(0, 4) == [0, 1, 2, 3]
    assert N.LvlList([N.LvlCoarsest(), N.LvlFinest()]).resolve(0, 4) == [0, 4]
    assert N.LvlRange(N.LvlSingle(1), N.LvlSingle(3)).resolve(0, 4) == [1, 2, 3]
    assert N.LvlRelative(-1).resolve(0, 4, current=3) == [2]


def test_mapping_stencils_recognized(poisson_ast):
    k = Knowledge(dimensionality=2, minLevel=2, maxLevel=4).update()
    ex = L4Executable(poisson_ast, k, out=lambda s: None)
    import numpy as np

    r = ex.stencils["NodeRestriction"][3]
    p = ex.stencils["NodeProlongation"][3]
    assert r.kind == "restriction" and p.kind == "prolongation"
    w1 = np.outer([0.25, 0.5, 0.25], [0.25, 0.5, 0.25])
    np.testing.assert_allclose(r.weights, w1)
    np.testing.assert_allclose(p.weights, np.outer([0.5, 1, 0.5], [0.5, 1, 0.5]))
    assert r.lo == (-1, -1) and p.lo == (-1, -1)


def test_execute_reference_exa4_matches_api(poisson_ast):
    """Running the reference's own L4 file must reproduce the Python-API
    residual/error sequence exactly (transitively: the reference golden)."""
    k = Knowledge(dimensionality=2, minLevel=0, maxLevel=5, testing_enabled=True).update()
    lines = []
    L4Executable(poisson_ast, k, out=lines.append).run()

    k2 = Knowledge(dimensionality=2, minLevel=0, maxLevel=5, testing_enabled=True).update()
    _, api_lines, *_ = PoissonMGSolver(k2).solve(max_its=100, target_res_reduction=1e-10)
    assert lines == api_lines
    assert len(lines) >= 5
