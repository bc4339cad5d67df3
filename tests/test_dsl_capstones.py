"""Capstone workloads through the L4 frontend: optical flow (coupled
cell-based system, collocated 2x2 local solve) and staggered Stokes
(5-DOF Vanka smoother, BiCGStab coarse solve) — the reference's own
Examples/ inputs executed at reduced size.

The reference ships no golden .results for these (Testing/Examples has
knowledge/settings only), so the assertions check convergence rates and
discretization-error floors."""

import pytest

pytestmark = pytest.mark.slow  # full-tier only (ci.sh quick gate skips)

from exastencils_jax.config import Knowledge, parse_config_file
from exastencils_jax.dsl.interpreter import L4Executable
from exastencils_jax.dsl.parser import parse_l4


def run_example(reference_root, rel, exa, max_level, min_level=2):
    k = Knowledge()
    parse_config_file(f"{reference_root}/Examples/{rel}", k)
    k.maxLevel = max_level
    k.minLevel = min_level
    k.update()
    prog = parse_l4(f"{reference_root}/Examples/{exa}")
    lines = []
    L4Executable(prog, k, out=lines.append).run()
    return lines


def parse_residuals(lines):
    out = []
    for ln in lines:
        if ln.startswith("Residual after"):
            out.append(float(ln.split("iterations is")[1].split("---")[0]))
        elif ln.startswith("Starting residual"):
            out.append(float(ln.split(":")[1]))
    return out


def test_optical_flow_converges(reference_root):
    lines = run_example(
        reference_root,
        "OpticalFlow/2D_FD_OptFlow_fromL4.knowledge",
        "OpticalFlow/2D_FD_OptFlow_fromL4.exa4",
        max_level=6,
    )
    res = parse_residuals(lines)
    assert len(res) >= 3
    assert res[-1] <= 1e-5 * res[0]
    # multigrid-quality convergence factor
    assert res[1] / res[0] < 0.2


def test_stokes_vanka_converges(reference_root):
    lines = run_example(
        reference_root,
        "Stokes/2D_FD_Stokes_fromL4.knowledge",
        "Stokes/2D_FD_Stokes_fromL4.exa4",
        max_level=4,
    )
    res = parse_residuals(lines)
    assert len(res) >= 3
    assert res[1] / res[0] < 0.2
    assert res[-1] <= 1e-10 * res[0]
    # velocity errors reach the discretization floor
    err_lines = [ln for ln in lines if ln.startswith("The maximum error")]
    last = err_lines[-1].split("is")[1].split()
    err_u, err_v = float(last[0]), float(last[1])
    assert err_u < 5e-3 and err_v < 5e-3
