import pytest

pytestmark = pytest.mark.slow  # full-tier only
"""ComplexNumbers suite remainder (BasicFunc is covered by
test_matrix_complex_golden):

- 2D_FD_Helmholtz_fromL3: complex Helmholtz solved by a multigrid-
  preconditioned BiCGStab over complex fields with radiation BCs
  applied by a user bc-function (`Field Solution< ..., applyBC_Solution
  @7() >`), complex per-point solve-locally smoothing, and same-level
  stencils in mapping notation.  The committed golden reads "483
  iterations ... 0.00111329"; after ~500 f64 Krylov iterations the
  iteration count depends on the arithmetic/reduction ORDER (the
  reference itself needs omp_fixArithmeticReductionOrder=true for its
  own determinism, 2D_FD_Helmholtz_fromL3.knowledge:21), so the test
  asserts the achieved tolerance and an iteration count within 5% of
  the golden instead of digit equality (documented deviation).

- sumAlgos: dot(f, f, "kahan"|"neumaier") compensated-summation
  variants.  The program fills f from std::random_device natives —
  inherently irreproducible — and its committed .results ("stage 0
  done") does not even match its own current print statements; the
  test self-checks against math.fsum ground truth instead.
"""

import math
import os
import re

from exastencils_jax.config import Knowledge
from exastencils_jax.config.parser import parse_config_file
from exastencils_jax.dsl.driver import run_config
from exastencils_jax.dsl.interpreter import L4Executable
from exastencils_jax.dsl.parser import parse_l4

_LINE = re.compile(
    r"Residual after (\d+) iterations is ([\d.e+-]+) --- "
    r"convergence factor is ([\d.e+-]+)"
)


def test_helmholtz_from_l3(reference_root):
    base = os.path.join(
        reference_root, "Testing", "ComplexNumbers",
        "2D_FD_Helmholtz_fromL3", "2D_FD_Helmholtz_fromL3",
    )
    k = Knowledge()
    parse_config_file(base + ".knowledge", k)
    k.update()
    prog = parse_l4(base + ".exa4")
    lines = []
    L4Executable(prog, k, out=lines.append).run()
    assert len(lines) == 1
    m = _LINE.match(lines[0])
    assert m, f"unexpected output: {lines}"
    its, res, factor = int(m.group(1)), float(m.group(2)), float(m.group(3))
    # golden: 483 its, res 0.00111329, factor 6.79499e-08
    assert abs(its - 483) <= 25, f"iteration count {its} far from golden 483"
    assert res < 2.5e-3
    assert factor < 2e-7


def test_sumalgos_compensated_dot(reference_root):
    base = os.path.join(reference_root, "Testing", "ComplexNumbers", "sumAlgos")
    lines = []
    ex = run_config(
        os.path.join(base, "sumAlgos.settings"),
        os.path.join(base, "sumAlgos.knowledge"),
        out=lines.append,
    )
    assert len(lines) == 3
    default, kahan, neumaier = (float(x) for x in lines)
    # ground truth: exact sum of the squared inputs
    import numpy as np

    f = np.asarray(ex.state[("f", ex.hi)]).real.ravel()
    exact = math.fsum(float(x) * float(x) for x in f)
    # compensated sums must be at least as accurate as the default sum
    # and essentially exact in f64
    assert abs(kahan - exact) <= abs(default - exact) + 1e-9
    assert abs(neumaier - exact) <= abs(default - exact) + 1e-9
    assert abs(neumaier - exact) < 1e-7 * abs(exact)
