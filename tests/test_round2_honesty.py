"""Round-2 honesty pass: real MinRes, F-cycle, BiCGStab restart,
stencil algebra (compose / transpose / Galerkin), StencilFromExpr DSL
lowering, seq-loop jit-cache correctness, config-parser block comments,
and native/Python golden-comparator equivalence."""

import numpy as np
import pytest
import jax.numpy as jnp

from exastencils_jax.config import Knowledge
from exastencils_jax.core.stencil import (
    BoundStencil,
    galerkin_product,
    node_prolongation,
    node_restriction,
)
from exastencils_jax.ops.stencil_apply import apply_stencil, prolong, restrict
from exastencils_jax.solver.krylov import bicgstab, conjugate_residual, minres


# ---------------------------------------------------------------- Krylov


def _sym_indefinite(n=24, seed=0):
    rng = np.random.RandomState(seed)
    Q, _ = np.linalg.qr(rng.randn(n, n))
    # symmetric indefinite: mixed-sign spectrum
    eigs = np.concatenate([-np.linspace(1.0, 3.0, n // 2), np.linspace(1.0, 4.0, n - n // 2)])
    A = Q @ np.diag(eigs) @ Q.T
    return jnp.asarray(A), jnp.asarray(rng.randn(n))


def test_minres_indefinite_converges():
    """A real MinRes must solve a symmetric *indefinite* system (CR/CG
    require SPD and generally break down here)."""
    A, b = _sym_indefinite()
    res = minres(lambda x: A @ x, jnp.zeros_like(b), b, max_its=100, res_reduction=1e-10)
    x_np = np.linalg.solve(np.asarray(A), np.asarray(b))
    assert np.allclose(np.asarray(res.sol), x_np, atol=1e-6)
    true_res = float(jnp.linalg.norm(b - A @ res.sol))
    assert true_res <= 1e-8 * float(jnp.linalg.norm(b))


def test_minres_survives_cr_breakdown():
    """CR divides by r^T A r, which vanishes for this indefinite system
    (A = diag(1,-1), b = (1,1): r0^T A r0 = 0) — the round-1 MinRes
    alias inherited the breakdown.  Real MinRes must still solve it."""
    A = jnp.asarray(np.diag([1.0, -1.0]))
    b = jnp.asarray([1.0, 1.0])
    c = conjugate_residual(lambda x: A @ x, jnp.zeros_like(b), b,
                           max_its=10, res_reduction=1e-12)
    assert not np.all(np.isfinite(np.asarray(c.sol))) or float(c.residual) > 1e-6
    m = minres(lambda x: A @ x, jnp.zeros_like(b), b,
               max_its=10, res_reduction=1e-12)
    assert np.allclose(np.asarray(m.sol), [1.0, -1.0], atol=1e-10)


def test_minres_spd_matches_reference_quality():
    """On SPD systems MinRes must converge like CG/CR."""
    rng = np.random.RandomState(2)
    M = rng.randn(20, 20)
    A = jnp.asarray(M @ M.T + 20 * np.eye(20))
    b = jnp.asarray(rng.randn(20))
    res = minres(lambda x: A @ x, jnp.zeros_like(b), b, max_its=60, res_reduction=1e-12)
    assert np.allclose(np.asarray(A @ res.sol), np.asarray(b), atol=1e-7)


def test_bicgstab_restart():
    rng = np.random.RandomState(3)
    M = rng.randn(30, 30)
    A = jnp.asarray(M @ M.T + 30 * np.eye(30))
    b = jnp.asarray(rng.randn(30))
    res = bicgstab(
        lambda x: A @ x, jnp.zeros_like(b), b,
        max_its=200, res_reduction=1e-10, restart_after=5,
    )
    assert np.allclose(np.asarray(A @ res.sol), np.asarray(b), atol=1e-6)


# ---------------------------------------------------------------- F-cycle


def test_f_cycle_runs_and_beats_v():
    """mg_cycle = 'F' must execute a genuine F-cycle: per-cycle residual
    trajectory differs from V and converges at least as fast."""
    from exastencils_jax.models.poisson import PoissonMGSolver

    def run(cycle):
        k = Knowledge(dimensionality=2, minLevel=1, maxLevel=5,
                      mg_cycle=cycle, testing_enabled=True).update()
        s = PoissonMGSolver(k)
        sol, rhs = s.init_state()
        traj = []
        for _ in range(4):
            sol = s._cycle(sol, rhs)
            traj.append(float(s._res_norm(sol, rhs)))
        return traj

    v = run("V")
    f = run("F")
    assert f != v
    assert f[-1] <= v[-1] * 1.0001


def test_unknown_cycle_type_rejected():
    from exastencils_jax.solver.mg import Multigrid

    mg = Multigrid(levels={}, min_level=0, max_level=1,
                   coarse_solve=lambda s, r: s, cycle_type="Q")
    with pytest.raises(ValueError, match="unknown cycle type"):
        mg.cycle(None, None, level=1)


# ------------------------------------------------------- stencil algebra


def _laplace_1d_bound(h=1.0):
    return BoundStencil("A", ((-1,), (0,), (1,)), (-1.0 / h**2, 2.0 / h**2, -1.0 / h**2))


def test_compose_constant():
    A = _laplace_1d_bound()
    AA = A.compose(A)
    ent = dict(AA.items())
    # (-1,2,-1)^2 = (1,-4,6,-4,1)
    assert ent[(0,)] == 6.0 and ent[(-1,)] == -4.0 and ent[(2,)] == 1.0


def test_transpose_variable_coefficient():
    """S^T[o](i) = S[-o](i+o): verify against dense matrices."""
    n = 7
    rng = np.random.RandomState(0)
    c_m = jnp.asarray(rng.rand(n))
    c_0 = jnp.asarray(rng.rand(n))
    c_p = jnp.asarray(rng.rand(n))
    S = BoundStencil("S", ((-1,), (0,), (1,)), (c_m, c_0, c_p))

    def dense(st):
        M = np.zeros((n, n))
        for off, c in st.items():
            c = np.broadcast_to(np.asarray(c), (n,))
            for i in range(n):
                j = i + off[0]
                if 0 <= j < n:
                    M[i, j] += c[i]
        return M

    assert np.allclose(dense(S.transposed()), dense(S).T)


def test_galerkin_matches_triple_application_2d():
    """Galerkin A_c = R A P must equal applying R(A(P(u_c))) through the
    existing transfer/convolution ops (interior points)."""
    nd = 2
    R = node_restriction(nd)
    P = node_prolongation(nd)
    h = 1.0 / 16
    A = BoundStencil(
        "L",
        ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)),
        (4.0 / h**2, -1.0 / h**2, -1.0 / h**2, -1.0 / h**2, -1.0 / h**2),
    )
    Ac = galerkin_product(R, A, P)

    rng = np.random.RandomState(1)
    coarse_shape = (9, 9)
    fine_shape = (17, 17)
    uc = jnp.asarray(rng.rand(*coarse_shape))
    direct = apply_stencil(Ac, uc)
    via_fine = restrict(R, apply_stencil(A, prolong(P, uc, fine_shape)), coarse_shape)
    # interior only: boundary rows differ by the zero-ghost convention
    r = 2
    sl = (slice(r, -r),) * nd
    assert np.allclose(np.asarray(direct[sl]), np.asarray(via_fine[sl]), rtol=1e-12)


def test_galerkin_1d_constant_known_result():
    """1D: R [-1 2 -1]/h^2 P = [-1 2 -1]/(2h)^2 * 2 ... verified against
    the classical result that FW/linear Galerkin reproduces the coarse
    FD Laplacian exactly."""
    R = node_restriction(1)
    P = node_prolongation(1)
    h = 0.125
    A = _laplace_1d_bound(h)
    Ac = galerkin_product(R, A, P)
    ent = {off: float(c) for off, c in Ac.items() if abs(float(c)) > 1e-14}
    H = 2 * h
    assert ent == pytest.approx({(-1,): -1.0 / H**2, (0,): 2.0 / H**2, (1,): -1.0 / H**2})


# ------------------------------------------------ DSL StencilFromExpr


L4_SEXPR = """
Domain global< [0.0, 0.0] to [1.0, 1.0] >

Layout NodeNoComm< Real, Node >@all {
  duplicateLayers = [1, 1]
  ghostLayers     = [0, 0]
}

Field u< global, NodeNoComm, 0.0 >@all
Field w< global, NodeNoComm, 0.0 >@all

Stencil A@all {
  [ 0,  0] =>  4.0
  [-1,  0] => -1.0
  [ 1,  0] => -1.0
  [ 0, -1] => -1.0
  [ 0,  1] => -1.0
}

Stencil A2@all from ( A * A )
Stencil At@all from ( transpose ( 2.0 * A ) )

Function Application ( ) : Unit {
  loop over u@finest {
    u@finest = vf_nodePos_x + 2.0 * vf_nodePos_y
  }
  loop over w@finest {
    w@finest = A2@finest * u@finest - 0.5 * ( At@finest * u@finest )
  }
  Var norm : Real = 0.0
  loop over w@finest with reduction ( + : norm ) {
    norm += w@finest * w@finest
  }
  print ( sqrt ( norm ) )
}
"""


def test_stencil_from_expr_dsl():
    from exastencils_jax.dsl.interpreter import L4Executable
    from exastencils_jax.dsl.parser import parse_l4

    k = Knowledge(dimensionality=2, minLevel=0, maxLevel=3,
                  testing_enabled=True).update()
    prog = parse_l4(L4_SEXPR)
    lines = []
    ex = L4Executable(prog, k, out=lines.append)
    # check the algebra objects directly
    A = ex._stencil_at("A", 3)
    A2 = ex._stencil_at("A2", 3)
    At = ex._stencil_at("At", 3)
    assert dict(A2.items())[(0, 0)] == 20.0  # 16 + 4*1
    assert dict(At.items())[(1, 0)] == -2.0
    ex.run()
    assert len(lines) == 1 and float(lines[0]) >= 0.0


# -------------------------------------------- seq-loop cache correctness


L4_SEQ_OMEGA = """
Domain global< [0.0, 0.0] to [1.0, 1.0] >

Layout NodeNoComm< Real, Node >@all {
  duplicateLayers = [1, 1]
  ghostLayers     = [0, 0]
}

Field u< global, NodeNoComm, 0.0 >@all
Field f< global, NodeNoComm, None >@all

Stencil A@all {
  [ 0,  0] =>  4.0
  [-1,  0] => -1.0
  [ 1,  0] => -1.0
  [ 0, -1] => -1.0
  [ 0,  1] => -1.0
}

Function Sweep@all ( om : Real ) : Unit {
  loop over u@current sequentially {
    u@current += om * ( ( f@current - A@current * u@current ) / diag ( A@current ) )
  }
}

Function Application ( ) : Unit {
  loop over f@finest {
    f@finest = 1.0
  }
  Sweep@finest ( 1.0 )
  Var n1 : Real = 0.0
  loop over u@finest with reduction ( + : n1 ) { n1 += u@finest * u@finest }
  Sweep@finest ( 0.0 )
  Var n2 : Real = 0.0
  loop over u@finest with reduction ( + : n2 ) { n2 += u@finest * u@finest }
  print ( n1 )
  print ( n2 )
}
"""


def test_seq_loop_does_not_bake_frame_vars():
    """A sequential (GS) sweep whose damping factor is a function
    argument must honor the *current* value on every call — the round-1
    jit cache baked the first call's value."""
    from exastencils_jax.dsl.interpreter import L4Executable
    from exastencils_jax.dsl.parser import parse_l4

    k = Knowledge(dimensionality=2, minLevel=0, maxLevel=3,
                  testing_enabled=True).update()
    lines = []
    L4Executable(parse_l4(L4_SEQ_OMEGA), k, out=lines.append).run()
    n1, n2 = (float(v) for v in lines)
    assert n1 > 0.0
    # omega = 0 sweep must leave u unchanged -> norms equal
    assert n2 == pytest.approx(n1, rel=1e-12)


# ----------------------------------------------------- config parser


def test_block_comment_preserves_statements(tmp_path):
    from exastencils_jax.config.parser import parse_config_text

    k = Knowledge()
    parse_config_text(
        "minLevel = 1 /* span\nmore comment */\nmaxLevel = 5\n"
        'discr_type = "Finite/*not a comment*/Volumes"\n',
        k,
    )
    assert k.minLevel == 1 and k.maxLevel == 5
    assert k.discr_type == "Finite/*not a comment*/Volumes"


# ----------------------------------------------------- native parity


def test_check_results_leading_whitespace(tmp_path):
    """C and Python comparators must agree on lines differing only in
    leading whitespace (both treat it as significant)."""
    from exastencils_jax import native

    a = tmp_path / "a.txt"
    b = tmp_path / "b.txt"
    a.write_text("hello\n  world\n")
    b.write_text("hello\nworld\n")
    rc_py = native.check_results(str(a), str(b), force_py=True)
    assert rc_py == 2
    if native.get_lib() is not None:
        assert native.check_results(str(a), str(b)) == rc_py


def test_rank_fragments_ndim_guard():
    from exastencils_jax import native

    with pytest.raises(ValueError):
        native.rank_fragments([2, 2, 2, 2], [1, 1, 1, 1], 0)
