"""Embedding API (VERDICT r5 item 7): a host application that owns its
field data as plain numpy arrays drives a generated solver through
`GeneratedSolver.export()` without touching framework internals — the
JAX analog of the reference's external-field interfacing
(interfacing/ir/IR_ExternalField.scala, IR_CopyToExternalField.scala,
IR_Fortranify.scala)."""

import math

import numpy as np

from exastencils_jax.config import Knowledge
from exastencils_jax.models.poisson import PoissonMGSolver


def _numpy_problem(shape):
    """Manufactured rhs/exact on the unit square, built by the HOST app
    with plain numpy (no framework calls)."""
    ny, nx = shape
    x = np.linspace(0.0, 1.0, nx)[None, :]
    y = np.linspace(0.0, 1.0, ny)[:, None]
    exact = np.cos(math.pi * y) - np.sin(2.0 * math.pi * x)
    rhs = (math.pi ** 2) * np.cos(math.pi * y) \
        - 4.0 * (math.pi ** 2) * np.sin(2.0 * math.pi * x)
    return rhs, exact


def test_export_numpy_roundtrip_dense():
    k = Knowledge(dimensionality=2, minLevel=0, maxLevel=6).update()
    solver = PoissonMGSolver(k)
    ex = solver.gen.export()

    rhs, exact = _numpy_problem(ex.shape)
    sol, it, rel = ex.solve(rhs, target_res_reduction=1e-10, max_its=50)

    assert isinstance(sol, np.ndarray) and sol.shape == ex.shape
    assert rel < 1e-10 and it < 20
    # discretization error of the manufactured solution at h = 1/64
    err = np.abs(sol - exact)[1:-1, 1:-1].max()
    assert err < 5e-3, err
    # caller's array untouched (copy-in contract)
    rhs2, _ = _numpy_problem(ex.shape)
    assert np.array_equal(rhs, rhs2)


def test_export_warm_start():
    k = Knowledge(dimensionality=2, minLevel=0, maxLevel=5).update()
    ex = PoissonMGSolver(k).gen.export()
    rhs, exact = _numpy_problem(ex.shape)
    sol, it0, _ = ex.solve(rhs, target_res_reduction=1e-8)
    assert it0 > 1
    # warm start from the converged iterate: the reduction target is
    # relative to THIS run's initial residual (reference
    # solver_targetResReduction semantics), and one cycle reduces ~30x
    _, it1, rel = ex.solve(rhs, u0=sol, target_res_reduction=1e-1,
                           max_its=3)
    assert it1 <= 1 and rel <= 1e-1


def test_export_device_step_contract():
    """The raw `step` callable donates its iterate (documented fast
    path for jax-native hosts)."""
    import jax.numpy as jnp

    k = Knowledge(dimensionality=2, minLevel=0, maxLevel=5).update()
    g = PoissonMGSolver(k).gen
    ex = g.export()
    sol, rhs = g.init_state()
    r0 = float(ex.residual_norm(jnp.copy(sol), rhs))
    s1 = ex.step(jnp.copy(sol), rhs)
    r1 = float(ex.residual_norm(jnp.copy(s1), rhs))
    assert r1 < 0.2 * r0


def test_export_numpy_roundtrip_sharded(four_devices):
    """Global numpy arrays scatter/gather across the mesh transparently."""
    from exastencils_jax.parallel.mesh import make_domain_mesh

    k = Knowledge(dimensionality=2, minLevel=0, maxLevel=6,
                  coarse_replicate_threshold=4).update()
    P = (2, 2)
    mesh = make_domain_mesh(P, devices=four_devices)
    ex = PoissonMGSolver(k, mesh=mesh, shard_dims=P).gen.export()
    rhs, exact = _numpy_problem(ex.shape)
    sol, it, rel = ex.solve(rhs, target_res_reduction=1e-10, max_its=50)
    assert sol.shape == ex.shape
    assert rel < 1e-10
    err = np.abs(sol - exact)[1:-1, 1:-1].max()
    assert err < 5e-3, err
