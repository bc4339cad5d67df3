"""Parity tests: the plain jnp multigrid ops vs independent numpy loops.

The jnp implementations (ops/smoothers.py, ops/stencil_apply.py,
ops/transfer.py) are what every level runs, and the reference that any
hand-written kernel must match (the analog of the reference's host code
next to CUDA kernels, parallelization/api/cuda/).  The numpy references
below share no code with them: red-black sweeps, residuals and 2:1
transfers are written out point by point from their definitions, and
tolerances are tight (f64)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from exastencils_jax.core.stencil import (
    BoundStencil,
    node_prolongation,
    node_restriction,
)
from exastencils_jax.ops.smoothers import color_mask, is_star_radius1, make_smoother
from exastencils_jax.ops.stencil_apply import apply_stencil, prolong, restrict
from exastencils_jax.ops.transfer import (
    apply_separable,
    build_prolong_mats,
    build_restrict_mats,
)
from exastencils_jax.solver.mg import MGLevelOps, _smooth_n

OMEGA = 0.8


def star3d(h=0.1):
    offsets = [(0, 0, 0)]
    coefs = [6.0 / h**2]
    for d in range(3):
        for s in (-1, 1):
            off = [0, 0, 0]
            off[d] = s
            offsets.append(tuple(off))
            coefs.append(-1.0 / h**2)
    return BoundStencil("L", tuple(offsets), tuple(coefs))


def boundary_mask(shape):
    m = np.zeros(shape, bool)
    for d in range(len(shape)):
        sl = [slice(None)] * len(shape)
        sl[d] = 0
        m[tuple(sl)] = True
        sl[d] = -1
        m[tuple(sl)] = True
    return m


# ----------------------------------------------------------------------
# numpy references (point loops over the definitions)
# ----------------------------------------------------------------------


def np_apply(A, u, idx):
    """(A u)[idx] with zero values outside the array."""
    acc = 0.0
    for off, c in zip(A.offsets, A.coefs):
        j = tuple(i + o for i, o in zip(idx, off))
        if all(0 <= jj < n for jj, n in zip(j, u.shape)):
            acc += c * u[j]
    return acc


def np_rbgs(sol, rhs, A, omega, n_iters):
    """Red-black Gauss-Seidel: per color, every interior point of that
    color takes sol += omega/diag * (rhs - A sol), reading the values
    left by the previous color; boundary points stay fixed."""
    u = np.array(sol, dtype=np.float64)
    f = np.asarray(rhs, dtype=np.float64)
    diag = A.coefs[A.offsets.index((0, 0, 0))]
    inner = np.argwhere(~boundary_mask(u.shape))
    for _ in range(n_iters):
        for color in (0, 1):
            pts = [tuple(p) for p in inner if sum(p) % 2 == color]
            upd = [u[p] + omega / diag * (f[p] - np_apply(A, u, p)) for p in pts]
            for p, v in zip(pts, upd):
                u[p] = v
    return u


def np_residual(sol, rhs, A):
    """rhs - A sol on interior points, zero on the Dirichlet boundary."""
    r = np.zeros(sol.shape)
    for p in np.argwhere(~boundary_mask(sol.shape)):
        p = tuple(p)
        r[p] = rhs[p] - np_apply(A, sol, p)
    return r


def np_restrict(ig, fine, coarse_shape):
    """coarse[i] = sum_k w[k] fine[2i + lo + k], zero outside."""
    out = np.zeros(coarse_shape)
    for i in np.ndindex(*coarse_shape):
        for k in np.ndindex(*ig.weights.shape):
            j = tuple(2 * a + lo + b for a, lo, b in zip(i, ig.lo, k))
            if all(0 <= jj < n for jj, n in zip(j, fine.shape)):
                out[i] += ig.weights[k] * fine[j]
    return out


def np_prolong(ig, coarse, fine_shape):
    """fine[2c + lo + k] += w[k] coarse[c] (transpose of restriction)."""
    out = np.zeros(fine_shape)
    for c in np.ndindex(*coarse.shape):
        for k in np.ndindex(*ig.weights.shape):
            j = tuple(2 * a + lo + b for a, lo, b in zip(c, ig.lo, k))
            if all(0 <= jj < n for jj, n in zip(j, fine_shape)):
                out[j] += ig.weights[k] * coarse[c]
    return out


# ----------------------------------------------------------------------
# the jnp ops as the cycle composes them (solver/mg.py)
# ----------------------------------------------------------------------


def jnp_level(A, shape, bvals):
    """MGLevelOps of one dense level with Dirichlet values `bvals`."""
    bmask = jnp.asarray(boundary_mask(shape))
    bc_sol = lambda x: jnp.where(bmask, bvals, x)
    coloring = [color_mask(shape, 0), color_mask(shape, 1)]
    return MGLevelOps(
        grid=None, shape=shape,
        A_apply=lambda x: apply_stencil(A, x),
        smooth=make_smoother(A, bc_sol, omega=OMEGA, coloring=coloring),
        bc_sol=bc_sol,
        bc_res=lambda x: jnp.where(bmask, 0.0, x),
    )


def jnp_rbgs(sol, rhs, A, n_iters):
    lv = jnp_level(A, sol.shape, sol)
    return jax.jit(lambda s, r: _smooth_n(lv, n_iters, s, r))(sol, rhs)


def coarse_of(fine):
    return tuple((n - 1) // 2 + 1 for n in fine)


@pytest.mark.parametrize("shape", [(9, 9, 9), (17, 12, 21), (8, 9, 16)])
@pytest.mark.parametrize("n_iters", [1, 2, 3])
def test_rbgs_matches_numpy(shape, n_iters):
    rng = np.random.default_rng(42)
    sol = rng.standard_normal(shape)
    rhs = rng.standard_normal(shape)
    A = star3d()
    assert is_star_radius1(A)

    want = np_rbgs(sol, rhs, A, OMEGA, n_iters)
    got = jnp_rbgs(jnp.asarray(sol), jnp.asarray(rhs), A, n_iters)

    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-12, atol=1e-12)


def test_boundary_preserved():
    rng = np.random.default_rng(0)
    shape = (9, 9, 9)
    sol = jnp.asarray(rng.standard_normal(shape))
    rhs = jnp.asarray(rng.standard_normal(shape))
    got = jnp_rbgs(sol, rhs, star3d(), 2)
    bmask = boundary_mask(shape)
    np.testing.assert_array_equal(np.asarray(got)[bmask], np.asarray(sol)[bmask])


def test_rejects_non_star():
    offsets = ((0, 0, 0), (1, 1, 0))
    coefs = (4.0, -1.0)
    assert not is_star_radius1(BoundStencil("L", offsets, coefs))


# ----------------------------------------------------------------------
# inter-grid transfers: banded-matrix contractions (sharded backend) vs
# strided-slice sums (dense backend, DSL)
# ----------------------------------------------------------------------


@pytest.mark.parametrize("level", [3, 4])
def test_restrict_matmul_matches_slicing(level):
    rng = np.random.default_rng(7)
    n = 2 ** level + 1
    fine = (n, n, n)
    coarse = coarse_of(fine)
    x = jnp.asarray(rng.standard_normal(fine))
    R = node_restriction(3)

    mm = apply_separable(build_restrict_mats(R, coarse, fine, coarse), x)
    sl = restrict(R, x, coarse)
    np.testing.assert_allclose(np.asarray(mm), np.asarray(sl),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("level", [3, 4])
def test_prolong_matmul_matches_slicing(level):
    rng = np.random.default_rng(11)
    n = 2 ** level + 1
    fine = (n, n, n)
    coarse = coarse_of(fine)
    xc = jnp.asarray(rng.standard_normal(coarse))
    Pop = node_prolongation(3)

    mm = apply_separable(build_prolong_mats(Pop, fine, coarse, fine), xc)
    sl = prolong(Pop, xc, fine)
    np.testing.assert_allclose(np.asarray(mm), np.asarray(sl),
                               rtol=1e-12, atol=1e-12)


# ----------------------------------------------------------------------
# cycle legs: pre-smooth + residual + restriction (down) and
# prolongation + correction + post-smooth (up), composed from the jnp
# ops as Multigrid.cycle does, vs the numpy composition
# ----------------------------------------------------------------------


@pytest.mark.parametrize("level,K", [(3, 1), (3, 3), (4, 2)])
def test_down_leg_matches_numpy(level, K):
    rng = np.random.default_rng(5)
    n = 2 ** level + 1
    fine = (n, n, n)
    coarse = coarse_of(fine)
    sol = rng.standard_normal(fine)
    rhs = rng.standard_normal(fine)
    A = star3d()
    R = node_restriction(3)

    s_want = np_rbgs(sol, rhs, A, OMEGA, K)
    rc_want = np_restrict(R, np_residual(s_want, rhs, A), coarse)

    lv = jnp_level(A, fine, jnp.asarray(sol))

    @jax.jit
    def down(s, r):
        s = _smooth_n(lv, K, s, r)
        res = lv.bc_res(r - lv.A_apply(s))
        return s, restrict(R, res, coarse)

    s_got, rc_got = down(jnp.asarray(sol), jnp.asarray(rhs))
    np.testing.assert_allclose(np.asarray(s_got), s_want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(rc_got), rc_want, rtol=1e-12, atol=1e-10)


@pytest.mark.parametrize("level,K", [(3, 1), (3, 3), (4, 2)])
def test_up_leg_matches_numpy(level, K):
    rng = np.random.default_rng(9)
    n = 2 ** level + 1
    fine = (n, n, n)
    coarse = coarse_of(fine)
    sol = rng.standard_normal(fine)
    sol_c = rng.standard_normal(coarse)
    rhs = rng.standard_normal(fine)
    A = star3d()
    Pop = node_prolongation(3)

    inner = ~boundary_mask(fine)
    s_want = sol + np.where(inner, np_prolong(Pop, sol_c, fine), 0.0)
    s_want = np_rbgs(s_want, rhs, A, OMEGA, K)

    lv = jnp_level(A, fine, jnp.asarray(sol))

    @jax.jit
    def up(s, sc, r):
        s = lv.bc_sol(s + prolong(Pop, sc, fine))
        return _smooth_n(lv, K, s, r)

    s_got = up(jnp.asarray(sol), jnp.asarray(sol_c), jnp.asarray(rhs))
    np.testing.assert_allclose(np.asarray(s_got), s_want, rtol=1e-12, atol=1e-12)
