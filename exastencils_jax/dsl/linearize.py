"""Symbolic linearization of equation expressions into stencils.

Reference counterpart: the `generate operators` statement
(operator/l2 L2_GenerateStencilFromEquation / the `store in` mapping
seen in Examples/Poisson/2D_FV_Poisson_fromL2.exa3 and the Stokes
examples): an equation lhs like

  -1.0 * ( integrateOverEastFace(1.0) * (u@[1,0] - u@[0,0]) / (...) - ... )

is decomposed into per-unknown stencil entries {offset -> coefficient
expression} plus a constant remainder.  Coefficient expressions may
reference virtual fields (vf_cellWidth_*, vf_gridWidth_*) and grid
integrals (integrateOver*Face) and are evaluated per level when the
stencil is bound (dsl/interpreter._stencil_at).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from exastencils_jax.dsl import nodes as N


class NonlinearError(NotImplementedError):
    pass


def _mul(a: Optional[N.Expr], b: Optional[N.Expr]) -> Optional[N.Expr]:
    if a is None or b is None:
        return None
    if isinstance(a, N.Num) and a.value == 1.0:
        return b
    if isinstance(b, N.Num) and b.value == 1.0:
        return a
    return N.BinOp("*", a, b)


def _neg(a: Optional[N.Expr]) -> Optional[N.Expr]:
    if a is None:
        return None
    if isinstance(a, N.Num):
        return N.Num(-a.value)
    return N.UnOp("-", a)


class _Linear:
    """terms: {(field, offset) -> coef expr}; const: expr or None (zero)."""

    def __init__(self, terms=None, const=None):
        self.terms: Dict[Tuple[str, Tuple[int, ...]], N.Expr] = terms or {}
        self.const: Optional[N.Expr] = const

    def add(self, other: "_Linear", sign: float = 1.0) -> "_Linear":
        out = _Linear(dict(self.terms), self.const)
        for k, c in other.terms.items():
            c = c if sign > 0 else _neg(c)
            out.terms[k] = c if k not in out.terms else N.BinOp("+", out.terms[k], c)
        oc = other.const if sign > 0 else _neg(other.const)
        if oc is not None:
            out.const = oc if out.const is None else N.BinOp("+", out.const, oc)
        return out

    def scale(self, factor: N.Expr) -> "_Linear":
        return _Linear(
            {k: _mul(factor, c) for k, c in self.terms.items()},
            _mul(factor, self.const),
        )

    def divide(self, denom: N.Expr) -> "_Linear":
        inv = N.BinOp("/", N.Num(1.0), denom)
        return self.scale(inv)

    @property
    def is_const(self) -> bool:
        return not self.terms


def _contains_unknown(e: N.Expr, unknowns: set) -> bool:
    if isinstance(e, N.Access):
        return e.name in unknowns
    if isinstance(e, N.BinOp):
        return _contains_unknown(e.lhs, unknowns) or _contains_unknown(e.rhs, unknowns)
    if isinstance(e, N.UnOp):
        return _contains_unknown(e.operand, unknowns)
    if isinstance(e, N.Call):
        return any(_contains_unknown(a, unknowns) for a in e.args)
    return False


def linearize(e: N.Expr, unknowns: set, ndim: int) -> _Linear:
    """Decompose `e` as sum over (unknown, offset) of coef * access plus
    a constant (reference IR_LocalSolve.processExpression logic, lifted
    to symbolic coefficient expressions)."""
    if isinstance(e, N.Access) and e.name in unknowns:
        off = tuple(e.offset) if e.offset else (0,) * ndim
        return _Linear({(e.name, off): N.Num(1.0)})
    if not _contains_unknown(e, unknowns):
        return _Linear(const=e)
    if isinstance(e, N.UnOp) and e.op == "-":
        inner = linearize(e.operand, unknowns, ndim)
        return _Linear({k: _neg(c) for k, c in inner.terms.items()}, _neg(inner.const))
    if isinstance(e, N.BinOp):
        if e.op == "+":
            return linearize(e.lhs, unknowns, ndim).add(
                linearize(e.rhs, unknowns, ndim))
        if e.op == "-":
            return linearize(e.lhs, unknowns, ndim).add(
                linearize(e.rhs, unknowns, ndim), sign=-1.0)
        if e.op == "*":
            l_has = _contains_unknown(e.lhs, unknowns)
            r_has = _contains_unknown(e.rhs, unknowns)
            if l_has and r_has:
                raise NonlinearError(f"nonlinear product: {e}")
            if l_has:
                return linearize(e.lhs, unknowns, ndim).scale(e.rhs)
            return linearize(e.rhs, unknowns, ndim).scale(e.lhs)
        if e.op == "/":
            if _contains_unknown(e.rhs, unknowns):
                raise NonlinearError(f"unknown in divisor: {e}")
            return linearize(e.lhs, unknowns, ndim).divide(e.rhs)
    raise NonlinearError(f"cannot linearize {e}")


def extract_stencils(
    lhs: N.Expr,
    unknowns: set,
    ndim: int,
) -> Dict[str, List[N.StencilOffsetEntry]]:
    """Per-unknown stencil entries from an equation lhs."""
    lin = linearize(lhs, unknowns, ndim)
    out: Dict[str, Dict[Tuple[int, ...], N.Expr]] = {}
    for (name, off), coef in lin.terms.items():
        out.setdefault(name, {})[off] = coef
    result = {}
    for name, coefs in out.items():
        zero = (0,) * ndim
        entries = []
        for off in sorted(coefs, key=lambda o: (o != zero, o)):
            entries.append(
                N.StencilOffsetEntry([N.Num(float(v)) for v in off], coefs[off]))
        result[name] = entries
    return result
