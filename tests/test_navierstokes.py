"""Lid-driven-cavity NavierStokes through the full exa2+exa3+exa4 layer
pipeline (reference Examples/NavierStokes/2D_FV_NavierStokes_{Newton,
Picard}): StencilTemplate operators assembled per nonlinear iterate,
staggered FV integrals (gridops), 5-DOF Vanka smoother with stencil-field
coefficients, and the time-stepping/adaptive-dt driver from the .exa4.

The reference ships no golden .results for these (they are interactive
CImg applications), so the assertions check nonlinear multigrid
convergence quality per time step, as printed by Solve@finest:
  `Residual at <t> after <n> iterations is <r> , was initially <r0>`
"""

import re

import pytest

pytestmark = pytest.mark.slow  # full-tier only (ci.sh quick gate skips)

from exastencils_jax.config import Knowledge, parse_config_file
from exastencils_jax.dsl import nodes as N
from exastencils_jax.dsl.driver import build_program
from exastencils_jax.dsl.interpreter import L4Executable

_RES_RE = re.compile(
    r"Residual at \S+ after (\d+) iterations is (\S+) , was initially (\S+)"
)


def run_ns(reference_root, variant, max_level=4, max_time=2.0):
    base = f"{reference_root}/Examples/NavierStokes/2D_FV_NavierStokes_{variant}"
    k = Knowledge()
    parse_config_file(f"{base}.knowledge", k)
    k.maxLevel = max_level
    k.minLevel = 2
    k.testing_enabled = True  # skip the CImg visualization branches
    k.update()
    prog = build_program(f"{base}.settings", k)
    for g in prog.globals_:
        if g.name == "maxTime":  # shorten the simulated horizon
            g.init = N.Num(max_time)
    lines = []
    L4Executable(prog, k, out=lines.append).run("Application")
    return lines


@pytest.mark.parametrize("variant", ["Picard", "Newton"])
def test_navierstokes_2d_converges(reference_root, variant):
    lines = run_ns(reference_root, variant)
    steps = [m for ln in lines if (m := _RES_RE.search(ln))]
    assert len(steps) == 2, f"expected 2 time steps, got {lines}"
    assert not any("Error detected" in ln for ln in lines)
    for m in steps:
        n_it, res, res0 = int(m.group(1)), float(m.group(2)), float(m.group(3))
        # nonlinear multigrid quality: a handful of V(3,3)+assemble
        # cycles drive the coupled residual below the 1e-10 target
        assert n_it <= 6
        assert res <= 1.0e-10
        assert res < 1e-4 * res0
