"""Cross-platform residual pins.

Two small f64 solves whose printed residual lines are kept as goldens in
tests/goldens/: the 3D FD Poisson `PoissonMGSolver` API (RBGS V(3,3),
CG coarse solve) and the ExaSlang benchmark program
examples/poisson_3d_bench.exa4 run by `L4Executable`.  The goldens come
from the plain path on the CPU; the GPU must print the same lines.
Lines are compared as the reference's Testing/run_test.py does: reduced-
precision printing, then equal text or a numeric difference <= 1e-6.

    python tests/pins.py            # check the goldens
    python tests/pins.py --write    # regenerate them
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(REPO, "tests", "goldens")
DSL_PROGRAM = os.path.join(REPO, "examples", "poisson_3d_bench.exa4")
LEVEL = 5
EPS = 1e-6


def _require_x64():
    import jax

    if not jax.config.jax_enable_x64:
        raise RuntimeError("residual pins run in f64: enable jax_enable_x64")


def api_lines(level: int = LEVEL) -> List[str]:
    """Printed lines (max error, residual per cycle) of the API solve."""
    from exastencils_jax.config import Knowledge
    from exastencils_jax.models.poisson import PoissonMGSolver

    _require_x64()
    k = Knowledge(dimensionality=3, minLevel=0, maxLevel=level,
                  useDblPrecision=True).update()
    _, lines, *_ = PoissonMGSolver(k).solve(max_its=20,
                                            target_res_reduction=1e-10)
    return lines


def dsl_lines(level: int = LEVEL) -> List[str]:
    """Printed lines (residual per cycle, cycle count) of `Application`."""
    from exastencils_jax.config import Knowledge
    from exastencils_jax.dsl.interpreter import L4Executable
    from exastencils_jax.dsl.parser import parse_l4

    _require_x64()
    k = Knowledge(dimensionality=3, minLevel=1, maxLevel=level,
                  useDblPrecision=True).update()
    lines = []
    L4Executable(parse_l4(DSL_PROGRAM), k, out=lambda s: lines.append(str(s))).run()
    return lines


PINS = {
    f"api_poisson3d_l{LEVEL}": api_lines,
    f"dsl_poisson3d_bench_l{LEVEL}": dsl_lines,
}


def golden_path(name: str) -> str:
    return os.path.join(GOLDEN_DIR, f"pin_{name}.txt")


def first_mismatch(got: List[str], want: List[str]) -> Optional[int]:
    """None when the lines match, else the 0-based index of the first
    differing line (len of the shorter list on a length mismatch)."""
    for i, (g, w) in enumerate(zip(got, want)):
        if g.strip() == w.strip():
            continue
        try:
            if abs(float(g) - float(w)) <= EPS:
                continue
        except ValueError:
            pass
        return i
    if len(got) != len(want):
        return min(len(got), len(want))
    return None


def read_golden(name: str) -> List[str]:
    with open(golden_path(name)) as f:
        return [l.rstrip("\n") for l in f if l.strip()]


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_enable_x64", True)
    write = "--write" in sys.argv[1:]
    rc = 0
    for name, fn in PINS.items():
        lines = fn()
        if write:
            with open(golden_path(name), "w") as f:
                f.write("\n".join(lines) + "\n")
            print(f"wrote {golden_path(name)} ({len(lines)} lines)")
            continue
        bad = first_mismatch(lines, read_golden(name))
        print(f"{name}: {'ok' if bad is None else f'mismatch at line {bad}'}")
        rc |= bad is not None
    sys.exit(rc)
