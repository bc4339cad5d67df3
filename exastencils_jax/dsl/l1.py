"""ExaSlang-1 frontend: continuous problem specification + FD
discretization to L2.

Reference counterparts: parsers/l1 grammar, node packages
{base,domain,operator,solver}/l1, the discretization engine
discretization/l1/L1_DiscretizationHints.scala:56 ->
L1_OperatorDiscretization.scala:71 (`discretizeExpression`, Taylor
finite-difference approach L1_FD_TaylorApproach), and
app/l1/L1_LayerHandler.scala:80-130.

Surface covered (Examples/*/*.exa1):
  Knowledge { ... }
  \\Omega = ( 0, 1 ) \\times ( 0, 1 ) [\\times ( 0, 1 )]
  f \\in \\Omega = <expr in x,y,z>
  u \\in \\partial \\Omega = <expr> | Neumann
  op = - \\Delta   |  linear combos of \\partial_{xx}, \\partial_{x}, ...
  uEq: f = op * u  |  uEq: op * u = f
  DiscretizationHints { f on Node ... op on \\Omega ... uEq ... k = v }
  SolverHints { generate solver for u in uEq ... k = v }
  ApplicationHints { k = v }

Discretization emits the same coefficient *expressions* the reference
produces at L2 (e.g. `2/(hx**2) + 2/(hy**2)` for -Laplace on Node),
so residual goldens match digit-for-digit.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional, Tuple

from exastencils_jax.dsl import nodes as N
from exastencils_jax.dsl.l3 import (
    EquationDecl,
    GenerateSolver,
    L3FieldDecl,
    L3Parser,
    L3Program,
)

_AXES = "xyz"


# ---------------------------------------------------------------- L1 AST

@dataclass
class L1Program:
    domain: Optional[Tuple[List[float], List[float]]] = None
    # name -> expr over (x,y,z): interior value definitions
    values: Dict[str, N.Expr] = dc_field(default_factory=dict)
    # name -> boundary expr (or Call('Neumann'))
    boundaries: Dict[str, Optional[N.Expr]] = dc_field(default_factory=dict)
    # name -> symbolic operator: {deriv_key: coef} with deriv_key like
    # 'xx', 'x', 'laplace'
    operators: Dict[str, Dict[str, float]] = dc_field(default_factory=dict)
    # name -> (lhs_expr, rhs_expr) raw equation
    equations: Dict[str, Tuple[N.Expr, N.Expr]] = dc_field(default_factory=dict)
    # discretization hints: name -> localization; op -> domain
    field_loc: Dict[str, str] = dc_field(default_factory=dict)
    active_equations: List[str] = dc_field(default_factory=list)
    gen_solvers: List[GenerateSolver] = dc_field(default_factory=list)
    inline_knowledge: dict = dc_field(default_factory=dict)


# ---------------------------------------------------------------- parser

class L1Parser(L3Parser):
    """Parses .exa1 source; token stream shares the ExaSlang lexer with
    backslash commands tokenized as identifiers."""

    def parse_l1_program(self, base: str = ".") -> L1Program:
        prog = L1Program()
        ts = self.ts
        while not ts.at("eof"):
            v = ts.cur.value
            if ts.accept("keyword", "import"):
                path = ts.expect("string").value
                sub = parse_l1_file(os.path.join(base, path))
                prog.values.update(sub.values)
                prog.boundaries.update(sub.boundaries)
                prog.operators.update(sub.operators)
                prog.equations.update(sub.equations)
                prog.inline_knowledge.update(sub.inline_knowledge)
                if sub.domain:
                    prog.domain = sub.domain
            elif v == "Knowledge":
                prog.inline_knowledge.update(self.parse_inline_knowledge())
            elif v == "\\Omega":
                ts.next()
                ts.expect("op", "=")
                prog.domain = self._parse_domain_product()
            elif v == "DiscretizationHints" or v == "Discretize":
                ts.next()
                self._parse_discretization_hints(prog)
            elif v == "SolverHints" or v == "Solve":
                ts.next()
                self._parse_solver_hints(prog)
            elif v == "ApplicationHints":
                ts.next()
                self._parse_param_block(prog)
            else:
                self._parse_definition(prog)
        return prog

    def _parse_domain_product(self) -> Tuple[List[float], List[float]]:
        ts = self.ts
        lowers, uppers = [], []
        while True:
            ts.expect("op", "(")
            lowers.append(self.parse_signed_number())
            ts.expect("op", ",")
            uppers.append(self.parse_signed_number())
            ts.expect("op", ")")
            if not (ts.cur.value == "\\times"):
                break
            ts.next()
        return lowers, uppers

    def _parse_definition(self, prog: L1Program):
        """`name \\in \\Omega = expr`, `name \\in \\partial \\Omega = expr`,
        `name = <operator expr>` or `name: lhs = rhs` (equation)."""
        ts = self.ts
        name = ts.next().value
        if ts.cur.value == "\\in":
            ts.next()
            on_boundary = False
            if ts.cur.value == "\\partial":
                ts.next()
                on_boundary = True
            assert ts.next().value == "\\Omega"
            ts.expect("op", "=")
            if on_boundary:
                if ts.at("ident", "Neumann"):
                    ts.next()
                    prog.boundaries[name] = N.Call("Neumann", None, [])
                else:
                    prog.boundaries[name] = self.parse_expr()
            else:
                prog.values[name] = self.parse_expr()
            return
        if ts.accept("op", ":"):
            # equation: `uEq: f = op * u`
            lhs = self.parse_expr(no_compare=True)
            ts.expect("op", "=")
            rhs = self.parse_expr(no_compare=True)
            prog.equations[name] = (lhs, rhs)
            return
        ts.expect("op", "=")
        prog.operators[name] = self._parse_operator_expr()

    def _parse_operator_expr(self) -> Dict[str, float]:
        """Linear combination of differential operators
        (operator/l1 L1_Laplace / L1_PartialDerivative)."""
        terms: Dict[str, float] = {}
        ts = self.ts

        def add(key: str, coef: float):
            terms[key] = terms.get(key, 0.0) + coef

        def parse_sum(sign: float):
            parse_term(sign)
            while ts.at("op", "+") or ts.at("op", "-"):
                op = ts.next().value
                parse_term(sign if op == "+" else -sign)

        def parse_term(sign: float):
            coef = sign
            while ts.at("op", "-"):
                ts.next()
                coef = -coef
            if ts.cur.kind in ("int", "real"):
                coef *= float(ts.next().value)
                ts.expect("op", "*")
                parse_term(coef)
                return
            if ts.at("op", "("):
                ts.next()
                parse_sum(coef)
                ts.expect("op", ")")
                return
            v = ts.next().value
            if v == "\\Delta":
                add("laplace", coef)
            elif v.startswith("\\partial_{"):
                add(v[len("\\partial_{"):-1], coef)
            else:
                raise self.err(f"unsupported operator term {v!r}")

        parse_sum(1.0)
        return {k: v for k, v in terms.items() if v != 0.0}

    def _parse_discretization_hints(self, prog: L1Program):
        ts = self.ts
        ts.expect("op", "{")
        while not ts.at("op", "}"):
            t = ts.cur
            nxt = ts.peek()
            if nxt.value == "on" and nxt.kind in ("keyword", "ident"):
                name = ts.next().value
                ts.next()  # on
                loc = ts.next().value  # Node | Cell | \Omega
                if loc.startswith("\\"):
                    loc = "domain"
                prog.field_loc[name] = loc
            elif nxt.kind == "op" and nxt.value == "=":
                key = ts.next().value
                ts.next()
                prog.inline_knowledge[key] = self._parse_config_value()
            else:
                # bare equation activation: `uEq`
                prog.active_equations.append(ts.next().value)
        ts.expect("op", "}")

    def _parse_solver_hints(self, prog: L1Program):
        ts = self.ts
        ts.expect("op", "{")
        while not ts.at("op", "}"):
            if ts.cur.value == "generate":
                ts.next()
                assert ts.next().value == "solver"
                prog.gen_solvers.append(self.parse_generate_solver())
            else:
                key = ts.next().value
                ts.expect("op", "=")
                prog.inline_knowledge[key] = self._parse_config_value()
        ts.expect("op", "}")

    def _parse_param_block(self, prog: L1Program):
        ts = self.ts
        ts.expect("op", "{")
        while not ts.at("op", "}"):
            key = ts.next().value
            ts.expect("op", "=")
            prog.inline_knowledge[key] = self._parse_config_value()
        ts.expect("op", "}")


def parse_l1_file(path: str) -> L1Program:
    with open(path) as f:
        src = f.read()
    return L1Parser(src, path).parse_l1_program(
        base=os.path.dirname(os.path.abspath(path))
    )


# ---------------------------------------------------------------- L1 -> L2

def _coord_subst(e: N.Expr, mapping: Dict[str, str]) -> N.Expr:
    """Substitute coordinate identifiers x/y/z by virtual-field accesses."""
    if isinstance(e, N.Access) and e.name in mapping:
        return N.Access(mapping[e.name])
    if isinstance(e, N.BinOp):
        return N.BinOp(e.op, _coord_subst(e.lhs, mapping), _coord_subst(e.rhs, mapping))
    if isinstance(e, N.UnOp):
        return N.UnOp(e.op, _coord_subst(e.operand, mapping))
    if isinstance(e, N.Call):
        return N.Call(e.name, e.level, [_coord_subst(a, mapping) for a in e.args])
    return e


def _h(d: int) -> N.Expr:
    return N.Access(f"vf_gridWidth_{_AXES[d]}")


def _hsq(d: int) -> N.Expr:
    return N.BinOp("**", _h(d), N.Num(2.0))


def _num(v: float) -> N.Num:
    return N.Num(v)


def discretize_operator(terms: Dict[str, float], ndim: int) -> List[N.StencilOffsetEntry]:
    """Second-order central FD discretization (Taylor approach,
    discretization/l1/L1_FD_TaylorApproach): \\partial_{dd} ->
    [1, -2, 1]/h_d^2; \\partial_d -> [-1, 0, 1]/(2 h_d); \\Delta = sum of
    second derivatives.  Coefficients are built as grid-width expression
    trees matching the reference's emitted L2 stencils."""
    coefs: Dict[Tuple[int, ...], N.Expr] = {}
    zero = (0,) * ndim

    def add(off: Tuple[int, ...], e: N.Expr):
        coefs[off] = e if off not in coefs else N.BinOp("+", coefs[off], e)

    def second(d: int, c: float):
        off_m = tuple(-1 if i == d else 0 for i in range(ndim))
        off_p = tuple(+1 if i == d else 0 for i in range(ndim))
        # c * (u[-1] - 2u[0] + u[+1]) / h^2
        add(off_m, N.BinOp("/", _num(c), _hsq(d)))
        add(zero, N.BinOp("/", _num(-2.0 * c), _hsq(d)))
        add(off_p, N.BinOp("/", _num(c), _hsq(d)))

    def first(d: int, c: float):
        off_m = tuple(-1 if i == d else 0 for i in range(ndim))
        off_p = tuple(+1 if i == d else 0 for i in range(ndim))
        add(off_p, N.BinOp("/", _num(c), N.BinOp("*", _num(2.0), _h(d))))
        add(off_m, N.BinOp("/", _num(-c), N.BinOp("*", _num(2.0), _h(d))))

    for key, c in terms.items():
        if key == "laplace":
            for d in range(ndim):
                second(d, c)
        elif len(key) == 2 and key[0] == key[1]:
            second(_AXES.index(key[0]), c)
        elif len(key) == 1:
            first(_AXES.index(key), c)
        else:
            raise NotImplementedError(f"mixed derivative {key!r}")

    # order entries center-first then sorted offsets (reference prints
    # center first in generated L2; summation order only affects last-ulp)
    entries = []
    for off in sorted(coefs, key=lambda o: (o != zero, o)):
        entries.append(N.StencilOffsetEntry([_num(v) for v in off], coefs[off]))
    return entries


def _analyze_l1_equation(name: str, lhs: N.Expr, rhs: N.Expr,
                         operators: Dict[str, Dict[str, float]],
                         values: Dict[str, N.Expr]):
    """Normalize `f = op * u` / `op * u = f` to (op, unknown, rhs_field)."""
    def split(e: N.Expr):
        if (isinstance(e, N.BinOp) and e.op == "*"
                and isinstance(e.lhs, N.Access) and e.lhs.name in operators
                and isinstance(e.rhs, N.Access)):
            return (e.lhs.name, e.rhs.name)
        return None

    for a, b in ((lhs, rhs), (rhs, lhs)):
        op_side = split(a)
        if op_side and isinstance(b, N.Access):
            return op_side[0], op_side[1], b.name
    raise NotImplementedError(f"equation {name}: expected `f = op * u` form")


def discretize_l1(l1: L1Program, knowledge) -> L3Program:
    """L1 -> L2/L3 progression: build fields, discretized operator
    stencils, and equations; carry solver hints through
    (L1_ProcessDiscretizationHints + L2/L3 handlers)."""
    for k, v in l1.inline_knowledge.items():
        knowledge.set(k, v)
    knowledge.update()
    ndim = knowledge.dimensionality

    out = L3Program()
    out.inline_knowledge.update(l1.inline_knowledge)
    if l1.domain is not None:
        out.domains.append(N.DomainDecl("global", l1.domain[0], l1.domain[1]))

    # equations first: identifies unknowns vs rhs fields
    eq_info = {}
    for name, (lhs, rhs) in l1.equations.items():
        if l1.active_equations and name not in l1.active_equations:
            continue
        eq_info[name] = _analyze_l1_equation(name, lhs, rhs, l1.operators, l1.values)

    node_subst = {a: f"vf_nodePos_{a}" for a in _AXES}
    bnd_subst = {a: f"vf_boundaryPos_{a}" for a in _AXES}

    declared = set()
    for eqname, (opname, unknown, rhs_field) in eq_info.items():
        loc = l1.field_loc.get(unknown, "Node")
        # unknown: init + bc
        if unknown not in declared:
            declared.add(unknown)
            init = l1.values.get(unknown)
            fd = L3FieldDecl(unknown, None, "Real", loc, "global",
                             init=_coord_subst(init, node_subst) if init is not None else None)
            out.fields.append(fd)
            bc = l1.boundaries.get(unknown)
            if bc is not None:
                bc_decl = L3FieldDecl(unknown)
                bc_decl.bc = (bc if isinstance(bc, N.Call)
                              else _coord_subst(bc, bnd_subst))
                out.fields.append(bc_decl)
        # rhs field: init at finest only (reference declares RHS@finest
        # with init, coarser without)
        if rhs_field not in declared:
            declared.add(rhs_field)
            init = l1.values.get(rhs_field)
            fd = L3FieldDecl(rhs_field, N.LvlFinest(), "Real", loc, "global",
                             init=_coord_subst(init, node_subst) if init is not None else None)
            out.fields.append(fd)
            out.fields.append(L3FieldDecl(
                rhs_field, N.LvlAllBut(N.LvlAll(), N.LvlFinest()), "Real", loc, "global"))
        # operator
        if opname not in {getattr(o, "name", None) for o in out.operators}:
            entries = discretize_operator(l1.operators[opname], ndim)
            out.operators.append(N.StencilDecl(opname, None, entries))
        # equation in L3 normal form: `op * unknown == rhs`
        out.equations.append(EquationDecl(
            eqname, None,
            N.BinOp("*", N.Access(opname), N.Access(unknown)),
            N.Access(rhs_field)))

    out.gen_solvers.extend(l1.gen_solvers)
    return out
