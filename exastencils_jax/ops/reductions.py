"""Field reductions (dot products, norms).

Reference: `loop over f with reduction(op : var)` lowering to OMP
reductions + MPI_Allreduce (parallelization/api/mpi/MPI_Reduction.scala).
Here these are jnp reductions; the sharded backend composes them with
`jax.lax.psum`/`pmax` over the mesh axes (exastencils_jax.parallel).

Boundary DOFs participate exactly as in the reference's loops (each
global DOF once); callers keep boundary values consistent via bc before
reducing, which the golden residual sequences depend on.
"""

from __future__ import annotations

import jax.numpy as jnp


def dot(a: jnp.ndarray, b: jnp.ndarray):
    return jnp.sum(a * b)


def norm_l2(a: jnp.ndarray):
    return jnp.sqrt(jnp.sum(a * a))


def norm_max(a: jnp.ndarray):
    return jnp.max(jnp.abs(a))


def sum_all(a: jnp.ndarray):
    return jnp.sum(a)
