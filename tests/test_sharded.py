"""Distributed-correctness tests on virtual CPU devices — the analog of
the reference's CommBasic suite (Testing/CommBasic/PureMPI.* etc., run
via `mpirun --oversubscribe`): halo exchange, ownership-aware
reductions, and dense-vs-sharded solver parity."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from exastencils_jax.config import Knowledge
from exastencils_jax.models.poisson import PoissonMGSolver
from exastencils_jax.parallel.backend import ShardedBackend
from exastencils_jax.parallel.mesh import make_domain_mesh
from exastencils_jax.parallel.topology import (
    ShardTopology,
    dense_to_fragments,
    fragments_to_dense,
)

pytestmark = pytest.mark.slow


@pytest.fixture(autouse=True)
def _needs_four_devices(four_devices):
    pass


def make_topo(P=(2, 2), ghost=1):
    mesh = make_domain_mesh(P, devices=jax.devices()[: P[0] * P[1]])
    names = tuple(n if p > 1 else None for n, p in zip(mesh.axis_names, P))
    return ShardTopology(mesh, P, names, ghost)


def test_roundtrip_dense_fragments():
    topo = make_topo()
    n = (8, 8)
    rng = np.random.default_rng(0)
    dense = rng.normal(size=(17, 17))
    stacked = dense_to_fragments(dense, topo, n)
    back = fragments_to_dense(stacked, topo, n)
    np.testing.assert_array_equal(dense, back)


def test_halo_exchange_fills_ghosts_and_dups():
    topo = make_topo()
    n = (8, 8)  # local cells; global 16 cells -> 17x17 nodes
    rng = np.random.default_rng(1)
    dense = rng.normal(size=(17, 17))
    stacked = jnp.asarray(dense_to_fragments(dense, topo, n))

    exchanged = jax.jit(
        jax.shard_map(
            lambda x: topo.exchange(x, n),
            mesh=topo.mesh,
            in_specs=topo.spec(),
            out_specs=topo.spec(),
        )
    )(stacked)
    ex = np.asarray(exchanged)

    g = topo.ghost
    T = n[0] + 1 + 2 * g  # 11
    # fragment (0,0): ghost-right column must hold dense[:, 9] rows 0..8
    f00 = ex[0:T, 0:T]
    np.testing.assert_allclose(f00[g : g + n[0] + 1, T - 1], dense[0:9, 9])
    # fragment (1,1): ghost-left col = dense[., 7]; dup-left col = dense[., 8]
    f11 = ex[T : 2 * T, T : 2 * T]
    np.testing.assert_allclose(f11[g : g + n[0] + 1, 0], dense[8:17, 7])
    np.testing.assert_allclose(f11[g : g + n[0] + 1, g], dense[8:17, 8])
    # physical boundary ghosts of fragment (0,0) stay zero
    np.testing.assert_array_equal(f00[:, 0], np.zeros(T))
    np.testing.assert_array_equal(f00[0, :], np.zeros(T))


def test_owned_reduction_counts_each_node_once():
    topo = make_topo()
    n = (8, 8)
    dense = np.ones((17, 17))
    stacked = jnp.asarray(dense_to_fragments(dense, topo, n))

    def local_sum(x):
        return topo.psum(jnp.sum(jnp.where(topo.owned_mask(x.shape, n), x, 0)))

    total = jax.jit(
        jax.shard_map(
            local_sum, mesh=topo.mesh, in_specs=topo.spec(), out_specs=jax.sharding.PartitionSpec()
        )
    )(stacked)
    assert float(total) == 17 * 17


@pytest.mark.parametrize("P", [(2, 2), (4, 2)])
def test_dense_vs_sharded_poisson_parity(P):
    """The full V-cycle solver must produce identical residual sequences
    on the dense and sharded backends (golden-test transitivity)."""
    k = Knowledge(dimensionality=2, minLevel=2, maxLevel=6).update()

    dense_solver = PoissonMGSolver(k)
    _, dense_lines, dres0, dresN, dit = dense_solver.solve(
        max_its=20, target_res_reduction=1e-10
    )

    mesh = make_domain_mesh(P, devices=jax.devices()[: P[0] * P[1]])
    sharded_solver = PoissonMGSolver(k, mesh=mesh, shard_dims=P)
    _, shard_lines, sres0, sresN, sit = sharded_solver.solve(
        max_its=20, target_res_reduction=1e-10
    )

    assert dit == sit
    assert dense_lines == shard_lines  # reduced-precision print parity
    assert abs(dres0 - sres0) / dres0 < 1e-12
    assert abs(dresN - sresN) / max(dresN, 1e-300) < 1e-6
