"""Comm/compute overlap (`overlap_halo`) and k-wide halo aggregation
(`comm_haloAggregationFactor`) on the sharded backend: both must leave
the solver's numbers untouched — the reference's IR_SplitLoops /
begin-finish exchange split and halo-aggregation knobs are pure
communication-structure transforms (communication/ir/IR_Communicate.scala:31,
config/Knowledge.scala:800-804)."""

import numpy as np
import pytest

import jax

from exastencils_jax.config import Knowledge
from exastencils_jax.models.poisson import PoissonMGSolver
from exastencils_jax.parallel.mesh import make_domain_mesh
from exastencils_jax.parallel.topology import fragments_to_dense

pytestmark = pytest.mark.slow


@pytest.fixture(autouse=True)
def _needs_four_devices(four_devices):
    pass

P = (2, 2)


def _run(**kw):
    k = Knowledge(dimensionality=2, minLevel=2, maxLevel=6, **kw).update()
    mesh = make_domain_mesh(P, devices=jax.devices()[: P[0] * P[1]])
    solver = PoissonMGSolver(k, mesh=mesh, shard_dims=P)
    sol, lines, res0, resN, it = solver.solve(max_its=20, target_res_reduction=1e-10)
    h = solver.backend.handle(k.maxLevel)
    dense_sol = fragments_to_dense(
        np.asarray(sol), solver.backend.topo, h.local_cells
    )
    return dense_sol, lines, it


def _run_dense(**kw):
    k = Knowledge(dimensionality=2, minLevel=2, maxLevel=6, **kw).update()
    _, lines, _, _, it = PoissonMGSolver(k).solve(
        max_its=20, target_res_reduction=1e-10
    )
    return lines, it


def test_overlap_halo_bitwise_and_golden_parity():
    base_sol, base_lines, base_it = _run()
    ov_sol, ov_lines, ov_it = _run(overlap_halo=True)
    assert ov_it == base_it
    assert ov_lines == base_lines
    # the split-exchange interior/shell formulation computes the very
    # same per-point arithmetic -> bitwise-equal solutions
    np.testing.assert_array_equal(ov_sol, base_sol)
    dlines, dit = _run_dense()
    assert ov_lines == dlines and ov_it == dit


def test_halo_aggregation_golden_parity():
    base_sol, base_lines, base_it = _run()
    ag_sol, ag_lines, ag_it = _run(comm_haloAggregationFactor=6)
    assert ag_it == base_it
    assert ag_lines == base_lines
    np.testing.assert_array_equal(ag_sol, base_sol)


def test_overlap_plus_aggregation_compose():
    base_sol, base_lines, base_it = _run()
    both_sol, both_lines, both_it = _run(
        overlap_halo=True, comm_haloAggregationFactor=4
    )
    assert both_it == base_it
    assert both_lines == base_lines
    np.testing.assert_array_equal(both_sol, base_sol)
