#!/usr/bin/env bash
# Two-tier test gate (reference: .github/workflows/main.yml gates every
# push with compile+assembly; full solver suites run nightly on a Slurm
# cluster via Testing/tests1_all.sh — here: quick on every change, full
# nightly).
#
#   ./ci.sh          quick tier: bytecode check + unit/golden tests (<7 min)
#   ./ci.sh full     + the slow golden/sharded suites (~1 h)
#   ./ci.sh nightly  + the huge 576^3 CommBasic goldens (~+40 min)
set -euo pipefail
cd "$(dirname "$0")"

python -m compileall -q exastencils_jax bench.py chip_smoke.py __graft_entry__.py

case "${1:-quick}" in
    nightly) python -m pytest tests -q ;;
    full)    python -m pytest tests -q -m "not huge" ;;
    *)       python -m pytest tests -q -m "not slow and not huge" ;;
esac
