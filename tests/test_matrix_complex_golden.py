"""Golden parity for the reference's MatrixClassTests and ComplexNumbers
suites (Matrix/Vector datatypes, component/slice accesses, matrix
builtins, structure classification, complex arithmetic).

Comparison uses the reference harness's own semantics
(Testing/run_test.py:12-42: zip over the common prefix, numeric lines at
EPS=1e-6, trailing blank golden lines ignored) plus a minimum-line-count
guard the reference lacks.  `smallMatrices` carries a stale golden in
the reference (two stage lines for a one-print program) — the reference
harness masks that via zip truncation; we pin the real count.
"""

import os

import pytest

pytestmark = pytest.mark.slow  # full-tier only (ci.sh quick gate skips)

from exastencils_jax.config import Knowledge
from exastencils_jax.config.parser import parse_config_file
from exastencils_jax.dsl.interpreter import L4Executable
from exastencils_jax.dsl.parser import parse_l4

CASES = [
    "MatrixClassTests/SolveMatSys/SolveMatSysCompileTime/SolveMatSysCompileTime",
    "MatrixClassTests/SolveMatSys/SolveMatSysRunTime/SolveMatSysRunTime",
    "MatrixClassTests/determineMatrixStructures/determineMatrixStructures",
    "MatrixClassTests/evalMOpRuntimeExe/evalMOpRuntimeExe",
    "MatrixClassTests/invert/CompileTime/BlockDiagonal/BlockDiagonal",
    "MatrixClassTests/invert/CompileTime/Diagonal/Diagonal",
    "MatrixClassTests/invert/CompileTime/LU/LU",
    "MatrixClassTests/invert/CompileTime/Schur/Schur",
    "MatrixClassTests/invert/CompileTime/SchurWithHelpers/SchurWithHelpers",
    "MatrixClassTests/invert/CompileTime/smallMatrices/smallMatrices",
    "MatrixClassTests/invert/RunTime/BlockDiagonal/BlockDiagonal",
    "MatrixClassTests/invert/RunTime/Diagonal/Diagonal",
    "MatrixClassTests/invert/RunTime/LU/LU",
    "MatrixClassTests/invert/RunTime/Schur/Schur",
    "MatrixClassTests/invert/RunTime/SchurLargeMatrix/SchurLargeMatrix",
    "MatrixClassTests/invert/RunTime/SmallMatrix/SmallMatrix",
    "MatrixClassTests/matrixFields/matrixFields",
    "MatrixClassTests/resolvingMatrixAccesses/resolvingMatrixAccesses",
    "MatrixClassTests/resolvingMatrixFunctions/chaines/chaines",
    "MatrixClassTests/resolvingMatrixFunctions/cross/cross",
    "MatrixClassTests/resolvingMatrixFunctions/determinant/determinant",
    "MatrixClassTests/resolvingMatrixFunctions/dot/dot",
    "MatrixClassTests/resolvingMatrixFunctions/frobeniusNorm/frobeniusNorm",
    "MatrixClassTests/resolvingMatrixFunctions/slicing/slicing",
    "MatrixClassTests/resolvingMatrixFunctions/toMatrix/toMatrix",
    "MatrixClassTests/resolvingMatrixFunctions/trace/trace",
    "MatrixClassTests/resolvingMatrixFunctions/transpose/transpose",
    "MatrixClassTests/resolvingMatrixOperators/resolvingMatrixOperators",
    "ComplexNumbers/BasicFunc/BasicFunc",
]

# goldens with more lines than the current reference source prints
# (stale in the reference; its zip-compare masks the overhang)
STALE_MIN_LINES = {
    "MatrixClassTests/invert/CompileTime/smallMatrices/smallMatrices": 1,
}


def zip_prefix_check(lines, golden_path, min_lines=None):
    with open(golden_path) as f:
        exp = [l.strip() for l in f]
    while exp and exp[-1] == "":
        exp.pop()
    got = [l.strip() for l in lines]
    need = len(exp) if min_lines is None else min_lines
    assert len(got) >= need, f"output too short: {len(got)} < {need}"
    for i, (s1, s2) in enumerate(zip(got, exp)):
        if s1 == s2:
            continue
        try:
            if abs(float(s1) - float(s2)) <= 1e-6:
                continue
        except ValueError:
            pass
        raise AssertionError(f"line {i + 1}: got {s1!r} want {s2!r}")


@pytest.mark.parametrize("case", CASES, ids=[c.split("/", 1)[1] for c in CASES])
def test_matrix_complex_golden(case, reference_root):
    base = os.path.join(reference_root, "Testing", case)
    src = base + ".exa4"
    if not os.path.exists(src):
        src = base + ".exa3"
    res = base + ".RESULTS"
    if not os.path.exists(res):
        res = base + ".results"
    k = Knowledge()
    if os.path.exists(base + ".knowledge"):
        parse_config_file(base + ".knowledge", k)
    k.update()
    lines = []
    L4Executable(parse_l4(src), k, out=lines.append).run()
    zip_prefix_check(lines, res, STALE_MIN_LINES.get(case))
