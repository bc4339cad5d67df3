"""CLI driver: `python -m exastencils_jax <settings> <knowledge> [platform]`.

Reference counterpart: Compiler/src/Main.scala:44-52 (argument parsing:
settings/knowledge/platform file triple) and :101-135 (generate).  Where
the reference emits a C++ project to Settings.outputPath, this runs the
generated solver directly on the default JAX backend (the GPU when one
is present; `--cpu` selects the CPU) and prints the solver output;
`--trace-dir` additionally captures a jax.profiler trace.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="exastencils_jax",
        description="ExaStencils on JAX: run ExaSlang L1-L4 configs",
    )
    ap.add_argument("settings", help=".settings file (layer files, paths)")
    ap.add_argument("knowledge", nargs="?", help=".knowledge file")
    ap.add_argument("platform", nargs="?",
                    help=".platform file (accepted for compatibility)")
    ap.add_argument("--function", default="Application",
                    help="entry function (default: Application)")
    ap.add_argument("--f64", action="store_true",
                    help="enable float64 (golden-parity mode)")
    ap.add_argument("--cpu", action="store_true", help="force the CPU backend")
    ap.add_argument("--trace-dir", default=None,
                    help="capture a jax.profiler trace to this directory")
    ap.add_argument("--check", default=None, metavar="GOLDEN.results",
                    help="diff the program output against a golden "
                         ".results file (reference Testing/run_test.py; "
                         "native C differ): exit 0 on match, 1 with the "
                         "first differing line otherwise")
    ap.add_argument("--check-eps", type=float, default=1e-6,
                    help="numeric tolerance for --check (default 1e-6, "
                         "the reference's EPS)")
    args = ap.parse_args(argv)

    if args.cpu:
        import os

        os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    if args.f64:
        jax.config.update("jax_enable_x64", True)
    from exastencils_jax.runtime.compile_cache import enable_compile_cache

    enable_compile_cache()

    from exastencils_jax.config import Knowledge
    from exastencils_jax.config.parser import parse_config_file
    from exastencils_jax.dsl.driver import build_program
    from exastencils_jax.dsl.interpreter import L4Executable

    k = Knowledge()
    if args.knowledge:
        parse_config_file(args.knowledge, k)
    if args.platform:
        parse_config_file(args.platform, k)  # platform keys land in _unused
    prog = build_program(args.settings, k)

    lines = []

    def emit(s):
        print(s)
        lines.append(str(s))

    def run():
        ex = L4Executable(prog, k, out=emit if args.check else print)
        ex.run(args.function)
        return ex

    if args.trace_dir:
        with jax.profiler.trace(args.trace_dir):
            run()
    else:
        run()

    if args.check:
        import tempfile

        from exastencils_jax.native import check_results

        with tempfile.NamedTemporaryFile(
                "w", suffix=".out", delete=False) as f:
            f.write("\n".join(lines) + ("\n" if lines else ""))
            got_path = f.name
        rc = check_results(got_path, args.check, eps=args.check_eps)
        if rc == 0:
            print(f"CHECK OK: output matches {args.check}")
            return 0
        if rc > 0:
            print(f"CHECK FAILED: first difference at line {rc} "
                  f"(vs {args.check})")
        else:
            print(f"CHECK FAILED: rc={rc} "
                  "(-2: golden unreadable, -3: line-count mismatch)")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
