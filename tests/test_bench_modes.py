"""Benchmark-harness modes (reference Benchmark/run_benchmark.py +
ConfigRunner sweeps): the sweep driver and the reference-program bench
runners must produce well-formed one-line-JSON results.  bench.py runs
on the GPU only, so these run on the card, in a child process that takes
a tenth of its memory (the test process may hold the rest)."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


pytestmark = [pytest.mark.slow, pytest.mark.gpu]


@pytest.fixture
def gpu_platform():
    """Decided from the environment, without starting JAX here."""
    if os.environ.get("JAX_PLATFORMS") not in ("cuda", "gpu"):
        pytest.skip("bench.py runs on the GPU only (JAX_PLATFORMS=cuda)")


def _run_bench(args, timeout=900):
    env = dict(os.environ)
    env["BENCH_ITERS"] = "2"
    env["XLA_PYTHON_CLIENT_MEM_FRACTION"] = "0.1"
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py"), *args],
        capture_output=True, text=True, timeout=timeout, env=env,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [l for l in out.stdout.splitlines() if l.startswith("{")]
    return [json.loads(l) for l in lines]


def test_sweep_matrix(gpu_platform):
    """ConfigRunner-lite: one JSON line per configuration, with the
    config echoed and the smoother axis actually reaching the solver."""
    rows = _run_bench(["--sweep", "level=5", "smoother=Jac,RBGS"])
    assert len(rows) == 2
    by_smoother = {r["config"]["smoother"]: r for r in rows}
    assert set(by_smoother) == {"Jac", "RBGS"}
    # different smoothers -> different convergence per cycle
    dj = by_smoother["Jac"]["detail"]["residual_drop_1cycle"]
    dr = by_smoother["RBGS"]["detail"]["residual_drop_1cycle"]
    assert dr < dj < 0.4
    for r in rows:
        assert r["unit"] == "GLUP/s" and r["value"] > 0
        assert r["device"]["platform"] == "gpu"


def test_fivepoint_problem(gpu_platform, reference_root):
    """The FivePointStencil reference benchmark runs end to end from its
    unmodified inputs (reduced level)."""
    rows = _run_bench(["--problem", "fivepoint", "--max-level", "7",
                       "--iters", "3"])
    assert len(rows) == 1
    r = rows[0]
    assert r["metric"] == "fivepoint_smoother_glups"
    assert r["value"] > 0
    assert r["detail"]["step_fn"] == "Smoother"
