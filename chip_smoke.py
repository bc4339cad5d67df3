#!/usr/bin/env python3
"""Smoke run of the multigrid solver on the GPU.

    python chip_smoke.py              # one card: phases 0-4
    python chip_smoke.py --cards 4    # four cards: the distributed phase only

Phases on one card:
  0. card tests: `pytest -m gpu` in a child process, before this process
     starts JAX (one process holds the card at a time);
  1. device: JAX must report a GPU; card name and power limit;
  2. API solve: 3D FD Poisson `PoissonMGSolver`, maxLevel 9 (513^3), f32,
     RBGS V(3,3) with a CG coarse solve, against an f64 run on the card;
  3. DSL solve: examples/poisson_3d_bench.exa4 `Application` through
     `L4Executable` at maxLevel 9, f32 against f64;
  4. residual pins: the small f64 API and DSL solves print the lines kept
     in tests/goldens/pin_*.txt (tests/pins.py).

With --cards 4 one process drives four cards: the API's shard_map backend
on a (4,1,1) mesh and the DSL's GSPMD placement, each against a dense run
of the same problem on device 0.

Findings go to earlier lines; the last line is one JSON object,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
Any failed phase, a missing GPU or a missing repository exits non-zero
without that line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
LEVEL = 9
DSL_PROGRAM = os.path.join(REPO, "examples", "poisson_3d_bench.exa4")

# f32 vs f64 on the card.  Compared quantity (floor_departure): the
# largest gap between the two relative residual histories r_k/r_0, in
# units of the f32 run's own floor (its smallest r_k/r_0).  f32 rounding
# alone keeps it near 1 at every level, since the floor grows with the
# grid as the rounding does; a contraction run in TF32 (10-bit mantissa)
# moves the early cycles by hundreds of floors.  Each tolerance is 10x
# the value measured on the CPU (no TF32 there) at level 6, in f32 vs
# f64 through this file's api_solver / dsl_run (API 0.3629 over 6 cycles,
# DSL 0.8542 over 6).  For scale: the DSL at 513^3 with its transfers in
# TF32 departed by 322 floors on an H100.
API_F32_TOL = 10 * 0.3629
DSL_F32_TOL = 10 * 0.8542


class PhaseError(RuntimeError):
    pass


def say(*args):
    print(*args, flush=True)


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


# ----------------------------------------------------------------------
# phase 0: card tests in a child process
# ----------------------------------------------------------------------


# The one skip allowed on the card: tests that read the reference
# ExaStencils tree (bench.py's FivePointStencil run) where it is not mounted.
ALLOWED_SKIP = "reference tree not mounted"


def phase_card_tests():
    env = dict(os.environ, JAX_PLATFORMS="cuda")
    cmd = [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
           "-m", "gpu", "-rs", "tests"]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=600)
    lines = out.stdout.strip().splitlines()
    skips = [l for l in lines if l.startswith("SKIPPED")]
    for line in skips + lines[-1:]:
        say("  pytest:", line)
    say(f"  pytest -m gpu: rc={out.returncode} "
        f"({time.perf_counter() - t0:.1f} s)")
    check(out.returncode == 0, "card tests failed:\n"
          + "\n".join(lines[-40:]) + out.stderr[-2000:])
    bad = [l for l in skips if not l.endswith(ALLOWED_SKIP)]
    check(not bad, f"card tests skipped on the card: {bad}")


# ----------------------------------------------------------------------
# phase 1: device
# ----------------------------------------------------------------------


def card_name_and_power():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip()


def phase_device(cards):
    import jax

    from exastencils_jax.runtime.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    n_cached = sum(len(f) for _, _, f in os.walk(cache))
    devs = jax.devices()
    check(devs[0].platform == "gpu",
          f"JAX finds no GPU: {devs[0].platform} {devs[0].device_kind}")
    check(len(devs) >= cards, f"need {cards} GPUs, JAX finds {len(devs)}")
    card = card_name_and_power()
    for line in card.splitlines():
        say("  nvidia-smi:", line)
    say(f"  jax {jax.__version__}, devices {len(devs)} x "
        f"{devs[0].device_kind}, XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}, "
        f"compile cache {cache} ({n_cached} files at start)")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": cards}, card.splitlines()[0]


# ----------------------------------------------------------------------
# helpers
# ----------------------------------------------------------------------


def peak_bytes(device=None):
    import jax

    stats = (device or jax.devices()[0]).memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def api_solver(level, f64, mesh=None, shard_dims=None):
    from exastencils_jax.config import Knowledge
    from exastencils_jax.models.poisson import PoissonMGSolver

    k = Knowledge(dimensionality=3, minLevel=0, maxLevel=level,
                  useDblPrecision=f64).update()
    return PoissonMGSolver(k, mesh=mesh, shard_dims=shard_dims)


def residual_history(solver, sol, rhs, n_cycles, cycle=None):
    """[r0, r1, ..., rn] of the host-driven `_cycle` step (donates sol)."""
    cycle = cycle or solver._cycle
    rs = [float(solver._res_norm(sol, rhs))]
    for _ in range(n_cycles):
        sol = cycle(sol, rhs)
        rs.append(float(solver._res_norm(sol, rhs)))
    return rs, sol


def rel_diff(a, b):
    return abs(a - b) / abs(b)


def floor_departure(rs32, rs64):
    """max_k |r32_k/r32_0 - r64_k/r64_0| / min_k(r32_k/r32_0) over the
    cycles both histories have."""
    rel32 = [r / rs32[0] for r in rs32]
    rel64 = [r / rs64[0] for r in rs64]
    gap = max(abs(a - b) for a, b in zip(rel32[1:], rel64[1:]))
    return gap / min(rel32[1:])


def dsl_run(level, f64, mesh=None):
    from exastencils_jax.config import Knowledge
    from exastencils_jax.dsl.interpreter import L4Executable
    from exastencils_jax.dsl.parser import parse_l4

    k = Knowledge(dimensionality=3, minLevel=1, maxLevel=level,
                  useDblPrecision=f64).update()
    lines = []
    ex = L4Executable(parse_l4(DSL_PROGRAM), k,
                      out=lambda s: lines.append(str(s)), mesh=mesh)
    ex.run()
    return lines, ex


# ----------------------------------------------------------------------
# phase 2: API solve
# ----------------------------------------------------------------------

API_CYCLES = 6  # cycles run; the f32 residual floor comes after 4
CONTRACTING = 4  # cycles that must each contract >= 10x


def phase_api(level, card, tol):
    import jax
    import jax.numpy as jnp

    t0 = time.perf_counter()
    s = api_solver(level, f64=False)
    sol, rhs = s.init_state()
    jax.block_until_ready((sol, rhs))
    setup_s = time.perf_counter() - t0
    check(sol.dtype == jnp.float32, f"f32 run has dtype {sol.dtype}")
    t0 = time.perf_counter()
    compiled = s._cycle.lower(sol, rhs).compile()
    compile_s = time.perf_counter() - t0
    say(f"  set-up {setup_s:.2f} s, V-cycle compile {compile_s:.2f} s")
    say(f"  V-cycle memory_analysis: {compiled.memory_analysis()}")

    rs32, sol = residual_history(s, jnp.copy(sol), rhs, API_CYCLES, compiled)
    drops = [b / a for a, b in zip(rs32, rs32[1:])]
    say(f"  f32 residuals {rs32}")
    say(f"  per-cycle contraction {[f'{d:.4f}' for d in drops]} (bound 0.1 "
        f"on the first {CONTRACTING}; then the f32 floor)")
    check(all(d <= 0.1 for d in drops[:CONTRACTING]),
          f"a V-cycle contracted the residual less than 10x: {drops}")

    n = 10
    x = jnp.copy(sol)
    jax.block_until_ready(x)
    t0 = time.perf_counter()
    for _ in range(n):
        x = compiled(x, rhs)
    jax.block_until_ready(x)
    cycle_ms = (time.perf_counter() - t0) / n * 1e3
    pts = ((1 << level) + 1) ** 3
    say(f"  unofficial reading: one V(3,3) cycle at {(1 << level) + 1}^3 f32 "
        f"= {cycle_ms:.3f} ms ({pts / cycle_ms / 1e6:.3f} GLUP/s) on {card}")
    del x, sol

    t0 = time.perf_counter()
    _, r0f, rf, it = s.solve_fused(max_its=20, target_res_reduction=1e-5)
    jax.block_until_ready(rf)
    say(f"  solve_fused: {int(it)} cycles to {float(rf) / float(r0f):.3e} x r0 "
        f"({time.perf_counter() - t0:.2f} s incl. compile)")
    check(float(rf) <= 1e-5 * float(r0f), "solve_fused missed 1e-5 x r0")
    say(f"  peak_bytes_in_use after f32: {peak_bytes()}")
    del s, rhs

    with jax.default_matmul_precision("highest"):
        s64 = api_solver(level, f64=True)
        sol64, rhs64 = s64.init_state()
        rs64, _ = residual_history(s64, sol64, rhs64, API_CYCLES)
    del s64, rhs64
    say(f"  f64 residuals {rs64}")
    d = floor_departure(rs32, rs64)
    say(f"  f32 vs f64: departure {d:.3f} f32 floors over {API_CYCLES} "
        f"cycles (tolerance {tol:.3f})")
    check(d <= tol, "f32 API run departs from f64")
    say(f"  peak_bytes_in_use: {peak_bytes()}")


# ----------------------------------------------------------------------
# phase 3: DSL solve
# ----------------------------------------------------------------------

def _dsl_residuals(lines):
    return [float(v) for v in lines[:-1]], int(lines[-1])


def phase_dsl(level, tol):
    import jax

    t0 = time.perf_counter()
    with jax.default_matmul_precision("highest"):
        l64, _ = dsl_run(level, f64=True)
    r64, it64 = _dsl_residuals(l64)
    say(f"  f64: {l64} ({time.perf_counter() - t0:.1f} s incl. compile)")
    check(r64[-1] < 1e-5 * r64[0] and it64 <= 20,
          "f64 DSL solve missed 1e-5 x r0 in 20 cycles")

    t0 = time.perf_counter()
    l32, ex = dsl_run(level, f64=False)
    r32, it32 = _dsl_residuals(l32)
    say(f"  f32: {l32} ({time.perf_counter() - t0:.1f} s incl. compile)")
    check(str(ex.state[("U", level)].dtype) == "float32", "f32 DSL dtype")
    del ex
    say(f"  f32: smallest residual {min(r32) / r32[0]:.3e} x r0 in {it32} "
        "cycles (its rounding floor; the 1e-5 x r0 check is on f64)")
    d = floor_departure(r32, r64)
    say(f"  f32 vs f64: departure {d:.3f} f32 floors over "
        f"{min(len(r32), len(r64)) - 1} cycles (tolerance {tol:.3f})")
    check(d <= tol, "f32 DSL run departs from f64")
    say(f"  peak_bytes_in_use: {peak_bytes()}")


# ----------------------------------------------------------------------
# phase 4: residual pins
# ----------------------------------------------------------------------


def _pins():
    """tests/pins.py, imported by path (a `tests` package elsewhere on
    sys.path would shadow tests/ as a namespace package)."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import pins

    return pins


def phase_pins():
    pins = _pins()

    for name, fn in pins.PINS.items():
        got = fn()
        want = pins.read_golden(name)
        bad = pins.first_mismatch(got, want)
        say(f"  {name}: {len(got)} lines, "
            + ("match" if bad is None else
               f"line {bad}: {got[bad:bad + 1]} != {want[bad:bad + 1]}"))
        check(bad is None, f"{name} departs from its golden")


# ----------------------------------------------------------------------
# four cards
# ----------------------------------------------------------------------

SHARD_CYCLES = 2  # far above the f32 floor, where rounding order is mute


def phase_four_cards(level):
    import jax
    from jax.sharding import Mesh
    import numpy as np

    from exastencils_jax.parallel.mesh import make_domain_mesh

    pins = _pins()

    devs = jax.devices()[:4]
    dims = (4, 1, 1)

    # API: shard_map + ppermute backend vs the dense backend on device 0
    mesh = make_domain_mesh(dims, devices=devs)
    t0 = time.perf_counter()
    ss = api_solver(level, f64=False, mesh=mesh, shard_dims=dims)
    sol, rhs = ss.init_state()
    placed = len(sol.sharding.device_set)
    rs_sh, _ = residual_history(ss, sol, rhs, SHARD_CYCLES)
    say(f"  sharded API {dims}: fields on {placed} devices, residuals "
        f"{rs_sh} ({time.perf_counter() - t0:.1f} s incl. compile)")
    del ss, sol, rhs
    with jax.default_device(devs[0]):
        ds = api_solver(level, f64=False)
        dsol, drhs = ds.init_state()
        rs_d, _ = residual_history(ds, dsol, drhs, SHARD_CYCLES)
    del ds, dsol, drhs
    say(f"  dense API on {devs[0]}: residuals {rs_d}")
    d = max(rel_diff(a, b) for a, b in zip(rs_sh, rs_d))
    say(f"  sharded vs dense: max relative residual difference {d:.3e} "
        f"(bound 1e-5)")
    check(placed == 4, f"API fields span {placed} devices, not 4")
    check(d <= 1e-5, "sharded API departs from dense")

    # DSL: GSPMD placement vs the dense run, digit-equal lines in f64
    dmesh = Mesh(np.array(devs).reshape(dims), ("bx", "by", "bz"))
    t0 = time.perf_counter()
    with jax.default_matmul_precision("highest"):
        lsh, ex = dsl_run(level, f64=True, mesh=dmesh)
    placed = len(ex.state[("U", level)].sharding.device_set)
    del ex
    say(f"  GSPMD DSL {dims}: U@{level} on {placed} devices, lines {lsh} "
        f"({time.perf_counter() - t0:.1f} s incl. compile)")
    with jax.default_device(devs[0]), jax.default_matmul_precision("highest"):
        ld, _ = dsl_run(level, f64=True)
    say(f"  dense DSL on {devs[0]}: lines {ld}")
    bad = pins.first_mismatch(lsh, ld)
    check(placed == 4, f"DSL field spans {placed} devices, not 4")
    check(bad is None, f"GSPMD DSL line {bad} differs from dense")
    say(f"  peak_bytes_in_use per device: {[peak_bytes(d) for d in devs]}")


# ----------------------------------------------------------------------


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1,
                    help="4: run only the four-card distributed phase")
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(REPO, "exastencils_jax")):
        say(f"FAIL: the repository is not beside {__file__}")
        return 2
    sys.path.insert(0, REPO)

    t_all = time.perf_counter()
    failed = []

    def run(name, fn, *a):
        say(f"== phase {name}")
        t0 = time.perf_counter()
        try:
            out = fn(*a)
        except Exception as e:  # report the phase, run the others
            failed.append(name)
            say(f"FAIL phase {name}: {type(e).__name__}: {e}")
            return None
        say(f"   phase {name} ok ({time.perf_counter() - t0:.1f} s)")
        return out

    if args.cards == 1:
        run("0 card tests", phase_card_tests)

    import jax

    jax.config.update("jax_enable_x64", True)
    dev = run("1 device", phase_device, args.cards)
    if dev is None:
        return 1
    device, card = dev
    if args.cards == 1:
        run("2 API solve", phase_api, LEVEL, card, API_F32_TOL)
        run("3 DSL solve", phase_dsl, LEVEL, DSL_F32_TOL)
        run("4 residual pins", phase_pins)
    else:
        run("four cards", phase_four_cards, LEVEL)
    say(f"card: {card}; total {time.perf_counter() - t_all:.1f} s")
    if failed:
        say(f"FAILED phases: {failed}")
        return 1
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
