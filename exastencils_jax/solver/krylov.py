"""Krylov (coarse-grid) solvers.

Reference: the L3 coarse-grid-solver generators —
solver/l3/L3_ConjugateGradientForEquation.scala:33 (CG; its expanded L4
form is visible in mgCycle@coarsest of
Examples/Poisson/2D_FD_Poisson_fromL4.exa4 and is matched operation-for-
operation here, including reduction order and the early-exit placement),
L3_BiCGStabForEquation, L3_MinResForEquation,
L3_ConjugateResidualForEquation.

All solvers are `lax.while_loop`s over device-resident carries — the
JAX rendering of `repeat 128 times count curStep { ... return }`
with dynamic convergence checks (`repeat until`), so an entire coarse
solve compiles into the V-cycle without host synchronization.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax.numpy as jnp
from jax import lax

from exastencils_jax.ops.reductions import dot, norm_l2


class KrylovResult(NamedTuple):
    sol: jnp.ndarray
    iterations: jnp.ndarray
    residual: jnp.ndarray


def _ident(x):
    return x


def cg(
    A_apply: Callable,
    sol: jnp.ndarray,
    rhs: jnp.ndarray,
    *,
    bc_sol: Callable = _ident,
    bc_res: Callable = _ident,
    max_its: int = 128,
    res_reduction: float = 1e-3,
    dot_fn: Callable = dot,
    norm_fn: Callable = norm_l2,
) -> KrylovResult:
    """Conjugate gradients, matching the reference's generated CG
    (mgCycle@coarsest of 2D_FD_Poisson_fromL4.exa4):

        r = bc(rhs - A sol); p = bc(r)
        loop: Ap; alpha = <r,r>/<p,Ap>; sol += alpha p (bc);
              r -= alpha Ap (bc); early-exit on ||r|| <= eps*||r0||;
              beta = ||r_new||^2/||r||^2; p = bc(r + beta p)
    """
    r = bc_res(rhs - A_apply(sol))
    init_res = norm_fn(r)
    p = bc_res(r)

    def cond(c):
        it, _, _, _, _, done = c
        return jnp.logical_and(it < max_its, jnp.logical_not(done))

    def body(c):
        it, sol, r, p, cur_res, _ = c
        Ap = A_apply(p)
        alpha_nom = dot_fn(r, r)
        alpha_denom = dot_fn(p, Ap)
        alpha = alpha_nom / alpha_denom
        sol = bc_sol(sol + alpha * p)
        r = bc_res(r - alpha * Ap)
        next_res = norm_fn(r)
        done = next_res <= res_reduction * init_res
        beta = (next_res * next_res) / (cur_res * cur_res)
        p = bc_res(r + beta * p)
        return (it + 1, sol, r, p, next_res, done)

    it, sol, r, p, cur_res, done = lax.while_loop(
        cond, body, (jnp.int32(0), sol, r, p, init_res, init_res <= 0.0)
    )
    return KrylovResult(sol, it, cur_res)


def bicgstab(
    A_apply: Callable,
    sol: jnp.ndarray,
    rhs: jnp.ndarray,
    *,
    bc_sol: Callable = _ident,
    bc_res: Callable = _ident,
    max_its: int = 128,
    res_reduction: float = 1e-3,
    dot_fn: Callable = dot,
    norm_fn: Callable = norm_l2,
    restart_after: int = 0,
) -> KrylovResult:
    """BiCGStab (reference solver/l3/L3_BiCGStabForEquation.scala).

    `restart_after > 0` re-seeds r0/p from the true residual every N
    iterations (the reference's `solver_cgs_restart` /
    `solver_cgs_restartAfter` protection against shadow-residual drift,
    config/Knowledge.scala solver_cgs_restart*)."""
    r = bc_res(rhs - A_apply(sol))
    init_res = norm_fn(r)
    r0 = r
    p = bc_res(r)

    def cond(c):
        it, *_, done = c
        return jnp.logical_and(it < max_its, jnp.logical_not(done))

    def body(c):
        it, sol, r, r0, p, _, _ = c
        if restart_after and restart_after > 0:
            def do_restart(args):
                sol, _, _, _ = args
                r_new = bc_res(rhs - A_apply(sol))
                return sol, r_new, r_new, bc_res(r_new)

            sol, r, r0, p = lax.cond(
                jnp.logical_and(it > 0, it % restart_after == 0),
                do_restart,
                lambda args: args,
                (sol, r, r0, p),
            )
        Ap = A_apply(p)
        alpha = dot_fn(r, r0) / dot_fn(Ap, r0)
        s = bc_res(r - alpha * Ap)
        As = A_apply(s)
        omega = dot_fn(As, s) / dot_fn(As, As)
        sol = bc_sol(sol + alpha * p + omega * s)
        r_new = bc_res(s - omega * As)
        next_res = norm_fn(r_new)
        done = next_res <= res_reduction * init_res
        beta = (dot_fn(r_new, r0) / dot_fn(r, r0)) * (alpha / omega)
        p = bc_res(r_new + beta * (p - omega * Ap))
        return (it + 1, sol, r_new, r0, p, next_res, done)

    it, sol, r, r0, p, cur_res, done = lax.while_loop(
        cond, body, (jnp.int32(0), sol, r, r0, p, init_res, init_res <= 0.0)
    )
    return KrylovResult(sol, it, cur_res)


def conjugate_residual(
    A_apply: Callable,
    sol: jnp.ndarray,
    rhs: jnp.ndarray,
    *,
    bc_sol: Callable = _ident,
    bc_res: Callable = _ident,
    max_its: int = 128,
    res_reduction: float = 1e-3,
    dot_fn: Callable = dot,
    norm_fn: Callable = norm_l2,
) -> KrylovResult:
    """Conjugate residual (reference L3_ConjugateResidualForEquation.scala)."""
    r = bc_res(rhs - A_apply(sol))
    init_res = norm_fn(r)
    p = bc_res(r)
    Ar = A_apply(r)
    Ap = Ar

    def cond(c):
        it, *_, done = c
        return jnp.logical_and(it < max_its, jnp.logical_not(done))

    def body(c):
        it, sol, r, p, Ar, Ap, _, _ = c
        rAr = dot_fn(r, Ar)
        alpha = rAr / dot_fn(Ap, Ap)
        sol = bc_sol(sol + alpha * p)
        r_new = bc_res(r - alpha * Ap)
        next_res = norm_fn(r_new)
        done = next_res <= res_reduction * init_res
        Ar_new = A_apply(r_new)
        beta = dot_fn(r_new, Ar_new) / rAr
        p = bc_res(r_new + beta * p)
        Ap = Ar_new + beta * Ap
        return (it + 1, sol, r_new, p, Ar_new, Ap, next_res, done)

    it, sol, r, p, Ar, Ap, cur_res, done = lax.while_loop(
        cond, body, (jnp.int32(0), sol, r, p, Ar, Ap, init_res, init_res <= 0.0)
    )
    return KrylovResult(sol, it, cur_res)


def minres(
    A_apply: Callable,
    sol: jnp.ndarray,
    rhs: jnp.ndarray,
    *,
    bc_sol: Callable = _ident,
    bc_res: Callable = _ident,
    max_its: int = 128,
    res_reduction: float = 1e-3,
    dot_fn: Callable = dot,
    norm_fn: Callable = norm_l2,
) -> KrylovResult:
    """MinRes (Paige & Saunders): Lanczos tridiagonalization + Givens QR
    (reference solver/l3/L3_MinResForEquation.scala — distinct from CR;
    valid for symmetric *indefinite* systems, e.g. the saddle-point
    Stokes coarse problems).

    Carries are the Lanczos pair (v_old, v), the two search directions
    (w_old, w), the running Givens cosines/sines, and the residual-norm
    estimate |eta| (exact in exact arithmetic)."""
    r = bc_res(rhs - A_apply(sol))
    init_res = norm_fn(r)
    beta1 = init_res
    safe_beta1 = jnp.where(beta1 > 0, beta1, 1.0)
    v = r / safe_beta1
    zeros = jnp.zeros_like(r)

    def cond(c):
        it = c[0]
        done = c[-1]
        return jnp.logical_and(it < max_its, jnp.logical_not(done))

    def body(c):
        (it, sol, v_old, v, beta, eta, c_old, c_cur, s_old, s_cur,
         w_old, w, _, _) = c
        # Lanczos step: v_new orthogonal to v, v_old
        Av = A_apply(v)
        alpha = dot_fn(v, Av)
        v_new = bc_res(Av - alpha * v - beta * v_old)
        beta_new = norm_fn(v_new)
        v_new = v_new / jnp.where(beta_new > 0, beta_new, 1.0)
        # apply previous two Givens rotations to the new tridiag column
        delta = c_cur * alpha - c_old * s_cur * beta
        rho2 = s_cur * alpha + c_old * c_cur * beta
        rho3 = s_old * beta
        rho1 = jnp.sqrt(delta * delta + beta_new * beta_new)
        safe_rho1 = jnp.where(rho1 > 0, rho1, 1.0)
        c_new = delta / safe_rho1
        s_new = beta_new / safe_rho1
        # update search direction and solution
        w_new = (v - rho3 * w_old - rho2 * w) / safe_rho1
        sol = bc_sol(sol + (c_new * eta) * w_new)
        eta = -s_new * eta
        next_res = jnp.abs(eta)
        done = next_res <= res_reduction * init_res
        return (it + 1, sol, v, v_new, beta_new, eta, c_cur, c_new,
                s_cur, s_new, w, w_new, next_res, done)

    init = (
        jnp.int32(0), sol, zeros, v, jnp.zeros_like(beta1), beta1,
        jnp.ones_like(beta1), jnp.ones_like(beta1),
        jnp.zeros_like(beta1), jnp.zeros_like(beta1),
        zeros, zeros, init_res, init_res <= 0.0,
    )
    out = lax.while_loop(cond, body, init)
    return KrylovResult(out[1], out[0], out[-2])


SOLVERS = {
    "CG": cg,
    "ConjugateGradient": cg,
    "BiCGStab": bicgstab,
    "MinRes": minres,
    "ConjugateResidual": conjugate_residual,
    "CR": conjugate_residual,
}
