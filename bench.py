"""Benchmark harness: the reference's three benchmark problems plus a
ConfigRunner-style sweep driver (Benchmark/run_benchmark.py:21-44,
ConfigRunner/src/ConfigRunner.scala:33).

    python bench.py                          # Poisson3D V(3,3), full detail
    python bench.py --problem fivepoint      # 2D 5-pt Jacobi, cell-based
    python bench.py --problem optflow        # 2D optical flow (coupled)
    python bench.py --sweep level=8,9 smoother=Jac,RBGS dtype=f32,bf16

Default mode prints ONE JSON line:
  metric      : poisson3d_vcycle_glups (fine-grid DOFs per second of
                V-cycle, in 1e9 lattice-updates/s)
  vs_baseline : fraction of the per-pass memory speed-of-light roofline
                at the device's data-sheet bandwidth (BASELINE.md target)
  detail      : fused-roofline fractions against both the data-sheet
                bandwidth and the copy bandwidth measured in the same run
                (stream_triad_gbps), the sharded formulation, and the DSL
                product path.
--problem / --sweep print one JSON line per run/config.  Every line names
the device it ran on (platform, device_kind, count).  The benchmark runs
on a GPU only: on any other platform it exits with an error.

Env knobs: BENCH_LEVEL (grid 2^L), BENCH_ITERS, BENCH_DSL=0,
BENCH_SHARDED=0.
"""

import argparse
import itertools
import json
import os
import sys
import time


def _timeit_calls(fn, n, repeats=2):
    """Best-of-`repeats` wall time of n chained fn() calls; fn returns
    the array to wait for, and the clock stops after the last one is
    ready on the device."""
    import jax

    best = None
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(n):
            out = fn()
        jax.block_until_ready(out)
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return best


def device_info():
    """The device every result line names."""
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def require_gpu():
    """Timings are only meaningful on the card: refuse anything else."""
    info = device_info()
    if info["platform"] != "gpu":
        raise SystemExit(
            f"bench.py measures GPU runs only; JAX reports {info}")
    return info


def measure_stream_bw(shape=(513, 513, 513), iters=20):
    """Measured copy bandwidth (GB/s): a chained triad x = 0.5*x + b (3
    arrays of traffic per iteration) run device-side in one fori_loop —
    the achievable roofline denominator for this device and shape."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax import lax

    a = jnp.asarray(np.zeros(shape), jnp.float32) + 1.0
    b = a * 0.5
    f = jax.jit(lambda x, b: lax.fori_loop(
        0, iters, lambda i, x: x * 0.5 + b, x))
    r = f(a, b)
    jax.block_until_ready(r)
    best = None
    for _ in range(3):
        t0 = time.perf_counter()
        r = f(a, b)
        jax.block_until_ready(r)
        dt = (time.perf_counter() - t0) / iters
        best = dt if best is None else min(best, dt)
    return 3 * a.size * 4 / best / 1e9


# ======================================================================
# Poisson3D (Benchmark/Poisson3D/3D_FD_Poisson_fromL4.*)
# ======================================================================


def _build_solver(size_level, smoother="RBGS", dtype="float32", mesh=None,
                  shard_dims=None):
    from exastencils_jax.config import Knowledge
    from exastencils_jax.models.poisson import PoissonMGSolver

    k = Knowledge(
        dimensionality=3,
        minLevel=0,
        maxLevel=size_level,
        useDblPrecision=False,
        compute_dtype=dtype,
    ).update()
    return PoissonMGSolver(k, smoother=smoother or "RBGS",
                           mesh=mesh, shard_dims=shard_dims)


def _time_cycle(solver, n_timed):
    import jax
    import jax.numpy as jnp

    sol, rhs = solver.init_state()
    cycle = solver._cycle  # donates the iterate — copy before reuse
    t0 = time.perf_counter()
    s1 = cycle(jnp.copy(sol), rhs)
    jax.block_until_ready(s1)
    compile_s = time.perf_counter() - t0

    state = {}

    def run():
        state["s"] = cycle(state["s"], rhs)
        return state["s"]

    best = None
    for _ in range(2):
        state["s"] = jnp.copy(sol)
        jax.block_until_ready(state["s"])
        best_i = _timeit_calls(run, n_timed, repeats=1)
        best = best_i if best is None else min(best, best_i)
    return best / n_timed, compile_s, sol, rhs, s1


def bench_poisson3d(size_level, n_timed, full_detail=True, smoother="RBGS",
                    dtype="float32"):
    import jax
    import jax.numpy as jnp

    from exastencils_jax.runtime.performance import (
        VCycleTrafficModel,
        device_spec,
    )

    device = require_gpu()
    solver = _build_solver(size_level, smoother=smoother, dtype=dtype)
    r0 = None
    cycle_s, compile_s, sol, rhs, s1 = _time_cycle(solver, n_timed)
    r0 = float(solver._res_norm(jnp.copy(sol), rhs))
    r1 = float(solver._res_norm(s1, rhs))
    if dtype == "float32":
        # RBGS V(3,3) contracts ~12x/cycle; damped Jacobi ~7x
        bound = 0.1 if smoother in ("RBGS", "GS", "GaussSeidel") else 0.4
        assert r1 < bound * r0, f"V-cycle not converging: {r0} -> {r1}"

    n = (1 << size_level) + 1
    fine_dofs = float(n) ** 3
    glups = fine_dofs / cycle_s / 1e9

    itemsize = 2 if dtype == "bfloat16" else 4
    model = VCycleTrafficModel(ndim=3, dtype_bytes=itemsize,
                               check_residual=False)
    bw = device_spec().hbm_bytes_per_s
    roofline = model.roofline_glups(bw)
    fused_model = VCycleTrafficModel(
        ndim=3, dtype_bytes=itemsize, check_residual=False, fused=True)
    roofline_fused = fused_model.roofline_glups(bw)

    detail = {
        "grid": f"{1 << size_level}^3",
        "device": device,
        "smoother": smoother,
        "dtype": dtype,
        "cycle_ms": round(cycle_s * 1e3, 3),
        "compile_s": round(compile_s, 1),
        "roofline_glups": round(roofline, 3),
        "roofline_fused_glups": round(roofline_fused, 3),
        "vs_fused_roofline": round(glups / roofline_fused, 4),
        "residual_drop_1cycle": r1 / max(r0, 1e-300),
    }

    if full_detail:
        # measured-bandwidth roofline: copy rate at the bench shape,
        # taken in the same run
        stream = measure_stream_bw((n, n, n))
        fused_meas = stream * 1e9 / fused_model.bytes_per_fine_dof() / 1e9
        detail["stream_triad_gbps"] = round(stream, 1)
        detail["roofline_fused_measured_glups"] = round(fused_meas, 3)
        detail["vs_fused_roofline_measured"] = round(glups / fused_meas, 4)

    return glups, roofline, detail, solver


def bench_sharded(size_level, n_timed, detail):
    import jax
    import jax.numpy as jnp

    from exastencils_jax.parallel.mesh import make_domain_mesh

    nd = len(jax.devices())
    if nd >= 2:
        # a real sharded axis when the platform has multiple chips
        px = 2
        dims = (px, 1, 1)
    else:
        dims = (1, 1, 1)
    mesh = make_domain_mesh(dims, devices=jax.devices()[: dims[0]])
    ssolver = _build_solver(size_level, mesh=mesh, shard_dims=dims)
    scycle_s, _, ssol, srhs, _ = _time_cycle(ssolver, n_timed)
    n = (1 << size_level) + 1
    detail["sharded_glups"] = round(float(n) ** 3 / scycle_s / 1e9, 4)
    detail["sharded_cycle_ms"] = round(scycle_s * 1e3, 3)
    detail["sharded_mesh"] = "x".join(map(str, dims))
    if max(dims) == 1:
        # comm/compute overlap and halo aggregation need a sharded axis
        # (P[d] > 1); their parity is covered on a 2x2 virtual-CPU mesh
        # by tests/test_overlap_agg.py
        detail["overlap_ab"] = "n/a-single-device (see tests/test_overlap_agg.py)"


def bench_dsl(size_level: int, n_timed: int):
    """Time MGCycle@finest of the DSL benchmark program (staged L4
    interpreter path — what a user of the framework actually runs)."""
    import jax

    from exastencils_jax.config import Knowledge
    from exastencils_jax.dsl.interpreter import L4Executable
    from exastencils_jax.dsl.parser import parse_l4

    base = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples", "poisson_3d_bench.exa4")
    k = Knowledge(
        dimensionality=3,
        minLevel=1,
        maxLevel=size_level,
        useDblPrecision=False,
        compute_dtype="float32",
    ).update()

    prog = parse_l4(base)
    ex = L4Executable(prog, k, out=lambda s: None)
    finest = k.maxLevel
    ex.call_function(ex.functions[("InitF", finest)], finest, [])
    cyc = ex.functions[("MGCycle", finest)]

    def run():
        ex.call_function(cyc, finest, [])
        return ex.state[("U", finest)]

    t0 = time.perf_counter()
    jax.block_until_ready(run())  # warmup / staged compiles
    compile_s = time.perf_counter() - t0
    elapsed = _timeit_calls(run, n_timed)

    n = (1 << size_level) + 1
    glups = float(n) ** 3 * n_timed / elapsed / 1e9
    return glups, elapsed / n_timed, compile_s


# ======================================================================
# FivePointStencil + OptFlow2D (the reference's other two benchmark
# problems, run through the DSL interpreter from the UNMODIFIED inputs)
# ======================================================================

_REF_BENCH = {
    "fivepoint": ("/root/reference/Benchmark/FivePointStencil/5pt_Jac_Cell",
                  "Smoother", "Solution"),
    "optflow": ("/root/reference/Benchmark/OptFlow2D/2D_FD_OptFlow",
                "mgCycle", "u"),
}


def bench_reference_program(problem: str, n_timed: int, max_level=None):
    import jax

    from exastencils_jax.config import Knowledge
    from exastencils_jax.config.parser import parse_config_file
    from exastencils_jax.dsl.interpreter import L4Executable
    from exastencils_jax.dsl.parser import parse_l4

    base, step_fn, field = _REF_BENCH[problem]
    k = Knowledge()
    parse_config_file(base + ".knowledge", k)
    if max_level is not None:
        k.maxLevel = max_level
        k.minLevel = min(k.minLevel, max_level)
    k.useDblPrecision = False
    k.compute_dtype = "float32"
    k.update()
    prog = parse_l4(base + ".exa4")
    ex = L4Executable(prog, k, out=lambda s: None)
    lvl = k.maxLevel
    # initialize via the program's own init functions
    for fn_name in ("InitFields", "InitSolution", "InitRHS", "initImgs",
                    "initGradients", "InitImgs"):
        for key in ((fn_name, lvl), (fn_name, None)):
            if key in ex.functions:
                ex.call_function(ex.functions[key], lvl, [])
                break
    fn = ex.functions.get((step_fn, lvl)) or ex.functions.get((step_fn, None))

    def run():
        ex.call_function(fn, lvl, [])
        return ex.state[(field, lvl)]

    device = require_gpu()
    t0 = time.perf_counter()
    jax.block_until_ready(run())
    compile_s = time.perf_counter() - t0
    elapsed = _timeit_calls(run, n_timed)

    shape = ex.true_shape(field, lvl)
    dofs = 1.0
    for s in shape:
        dofs *= s
    glups = dofs * n_timed / elapsed / 1e9
    return {
        "metric": f"{problem}_{step_fn.lower()}_glups",
        "value": round(glups, 4),
        "unit": "GLUP/s",
        "device": device,
        "detail": {
            "grid": "x".join(map(str, shape)),
            "step_fn": step_fn,
            "step_ms": round(elapsed / n_timed * 1e3, 3),
            "compile_s": round(compile_s, 1),
            "source": base + ".exa4",
        },
    }


# ======================================================================
# drivers
# ======================================================================


def run_default():
    size_level = int(os.environ.get("BENCH_LEVEL", "9"))
    n_timed = int(os.environ.get("BENCH_ITERS", "10"))

    glups, roofline, detail, _solver = bench_poisson3d(size_level, n_timed)

    if os.environ.get("BENCH_SHARDED", "1") != "0":
        bench_sharded(size_level, n_timed, detail)

    if os.environ.get("BENCH_DSL", "1") != "0":
        dsl_level = int(os.environ.get("BENCH_DSL_LEVEL", str(size_level)))
        dsl_glups, dsl_cycle_s, dsl_compile_s = bench_dsl(dsl_level, n_timed)
        detail["dsl_glups"] = round(dsl_glups, 4)
        detail["dsl_grid"] = f"{1 << dsl_level}^3"
        detail["dsl_cycle_ms"] = round(dsl_cycle_s * 1e3, 3)
        detail["dsl_compile_s"] = round(dsl_compile_s, 1)
        detail["dsl_vs_api"] = round(dsl_glups / glups, 4)

    print(json.dumps({
        "metric": "poisson3d_vcycle_glups",
        "value": round(glups, 4),
        "unit": "GLUP/s",
        "vs_baseline": round(glups / roofline, 4),
        "device": detail["device"],
        "detail": detail,
    }))


_SWEEP_KEYS = {
    "level": int,
    "smoother": str,
    "dtype": {"f32": "float32", "bf16": "bfloat16"},
}


def run_sweep(specs, n_timed):
    """ConfigRunner-lite: cartesian product over `key=v1,v2 ...` axes,
    one JSON line per configuration (reference ConfigRunner.scala:33 /
    runner/Variability.scala)."""
    axes = []
    for spec in specs:
        key, _, vals = spec.partition("=")
        if key not in _SWEEP_KEYS:
            raise SystemExit(
                f"unknown sweep axis {key!r} (have {sorted(_SWEEP_KEYS)})")
        conv = _SWEEP_KEYS[key]
        parsed = []
        for v in vals.split(","):
            parsed.append(conv[v] if isinstance(conv, dict) else conv(v))
        axes.append((key, parsed))
    base_level = int(os.environ.get("BENCH_LEVEL", "9"))
    for combo in itertools.product(*(vals for _, vals in axes)):
        cfg = dict(zip((k for k, _ in axes), combo))
        level = cfg.get("level", base_level)
        glups, roofline, detail, _ = bench_poisson3d(
            level, n_timed, full_detail=False,
            smoother=cfg.get("smoother", "RBGS"),
            dtype=cfg.get("dtype", "float32"),
        )
        print(json.dumps({
            "metric": "poisson3d_vcycle_glups",
            "value": round(glups, 4),
            "unit": "GLUP/s",
            "vs_baseline": round(glups / roofline, 4),
            "config": cfg,
            "device": detail["device"],
            "detail": detail,
        }))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--problem", choices=["poisson3d", "fivepoint", "optflow"],
                    default="poisson3d")
    ap.add_argument("--sweep", nargs="+", metavar="KEY=V1,V2",
                    help="sweep axes (level=..., smoother=..., dtype=...)")
    ap.add_argument("--iters", type=int,
                    default=int(os.environ.get("BENCH_ITERS", "10")))
    ap.add_argument("--max-level", type=int, default=None,
                    help="override maxLevel for fivepoint/optflow")
    args = ap.parse_args()

    from exastencils_jax.runtime.compile_cache import enable_compile_cache

    enable_compile_cache()
    if args.sweep:
        run_sweep(args.sweep, args.iters)
        return 0
    if args.problem == "poisson3d":
        run_default()
        return 0
    print(json.dumps(bench_reference_program(
        args.problem, args.iters, max_level=args.max_level)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
