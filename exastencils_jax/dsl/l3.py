"""ExaSlang-3 frontend: "algorithmic" layer with solver generation.

Reference counterparts: parsers/l3 grammar + node packages
{base,field,operator,solver}/l3, and app/l3/L3_LayerHandler.scala:86-157
(the schedule that resolves `generate solver` via
solver/l3/L3_SolverForEquation.scala then progresses everything to L4).

Surface covered (from Examples/*/*.exa3):
  Domain g< [..] to [..] >
  Field f [@lvl] with <dtype> on <loc> of <domain> [= init]
  Field f [@lvl] on boundary = expr | Neumann
  Field f [@lvl] from g
  override bc for f [@lvl] with expr
  Operator Op [@lvl] from Stencil { ... } | from default restriction ...
  Equation name [@lvl] { lhs == rhs }      (also L2's `name { ... }`)
  Globals { Var/Val/Expr ... }
  Function ... { ... }   with statement-level field assignments and
                         `... where <cond>` masks
  generate solver for u in uEq [and v in vEq ...] with { opts }
                   modifiers { append|prepend|replace to '<t>' @lvl { } }
  generate operators @lvl { equation for u is uEq store in { u => A } }

Lowering produces an L4 `N.Program` executed by dsl/interpreter.py; the
`generate solver` expansion lives in dsl/solvergen.py.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional, Tuple

from exastencils_jax.dsl import nodes as N
from exastencils_jax.dsl.parser import L4Parser
from exastencils_jax.dsl.solvergen import (
    EqEntry,
    EqTerm,
    SolverGenerator,
    SolverSpec,
    default_application,
)

_LOC_NAMES = {"Node", "Cell", "Face_x", "Face_y", "Face_z"}


# ---------------------------------------------------------------- L3 AST

@dataclass
class L3FieldDecl:
    name: str
    levels: Optional[N.LevelSpec] = None
    dtype: str = "Real"
    localization: Optional[str] = None
    domain: Optional[str] = None
    init: Optional[N.Expr] = None
    bc: Optional[N.Expr] = None  # expr | Call('Neumann') | None
    from_field: Optional[str] = None
    num_slots: int = 1  # `Field h ... 2 times` (slotted, L2/L3 grammar)


@dataclass
class BcOverride:
    field: str
    levels: Optional[N.LevelSpec]
    bc: Optional[N.Expr]


@dataclass
class EquationDecl:
    name: str
    levels: Optional[N.LevelSpec]
    lhs: N.Expr
    rhs: N.Expr


@dataclass
class GenerateSolver:
    entries: List[Tuple[str, str]]  # (unknown field, equation name)
    options: Dict[str, object] = dc_field(default_factory=dict)
    modifiers: List[Tuple[str, str, Optional[N.LevelSpec], List[N.Stmt]]] = dc_field(
        default_factory=list
    )


@dataclass
class GenerateOperators:
    levels: Optional[N.LevelSpec]
    # (unknown, equation, {field -> operator name})
    entries: List[Tuple[str, str, Dict[str, str]]] = dc_field(default_factory=list)


@dataclass
class L3Program:
    domains: List[N.DomainDecl] = dc_field(default_factory=list)
    fields: List[L3FieldDecl] = dc_field(default_factory=list)
    operators: List[object] = dc_field(default_factory=list)  # StencilDecl | StencilFromDefault
    equations: List[EquationDecl] = dc_field(default_factory=list)
    globals_: List[N.VarDecl] = dc_field(default_factory=list)
    functions: List[N.FunctionDecl] = dc_field(default_factory=list)
    bc_overrides: List[BcOverride] = dc_field(default_factory=list)
    gen_solvers: List[GenerateSolver] = dc_field(default_factory=list)
    gen_operators: List[GenerateOperators] = dc_field(default_factory=list)
    inline_knowledge: dict = dc_field(default_factory=dict)

    def merge(self, other: "L3Program") -> "L3Program":
        for attr in ("domains", "fields", "operators", "equations", "globals_",
                     "functions", "bc_overrides", "gen_solvers", "gen_operators"):
            getattr(self, attr).extend(getattr(other, attr))
        self.inline_knowledge.update(other.inline_knowledge)
        return self


# ---------------------------------------------------------------- parser

class L3Parser(L4Parser):
    """Parses .exa3 source into an L3Program."""

    def parse_l3_program(self, base: str = ".") -> L3Program:
        prog = L3Program()
        ts = self.ts
        while not ts.at("eof"):
            t = ts.cur
            v = t.value
            if ts.accept("keyword", "import"):
                path = ts.expect("string").value
                sub = parse_l3_file(os.path.join(base, path))
                prog.merge(sub)
            elif v == "Domain":
                prog.domains.append(self.parse_domain())
            elif v == "Field":
                ts.next()
                prog.fields.append(self.parse_l3_field())
            elif v == "Operator" or v == "Stencil":
                ts.next()
                prog.operators.append(self.parse_operator())
            elif v == "Equation":
                ts.next()
                prog.equations.append(self.parse_equation())
            elif v == "Globals":
                prog.globals_.extend(self.parse_globals())
            elif v == "Function" or v == "noinline":
                prog.functions.append(self.parse_function())
            elif v == "Knowledge":
                prog.inline_knowledge.update(self.parse_inline_knowledge())
            elif v == "override":
                prog.bc_overrides.append(self.parse_override_bc())
            elif v == "generate":
                self.parse_generate(prog)
            else:
                raise self.err("unexpected L3 top-level construct")
        return prog

    # ------------------------------------------------ field declarations
    def parse_l3_field(self, name: Optional[str] = None) -> L3FieldDecl:
        """After the introducing keyword/name (L3_FieldDecl variants)."""
        ts = self.ts
        if name is None:
            name = ts.expect("ident").value
        decl = L3FieldDecl(name)
        decl.levels = self.maybe_level()
        if ts.accept("keyword", "with"):
            decl.dtype = self.parse_datatype()
        if ts.accept("keyword", "from"):
            decl.from_field = ts.expect("ident").value
            return decl
        if ts.at("keyword", "on"):
            ts.next()
            if ts.at("keyword", "boundary"):
                ts.next()
                ts.expect("op", "=")
                decl.bc = self._parse_bc_expr()
                return decl
            decl.localization = ts.next().value
        if ts.accept("keyword", "of"):
            decl.domain = ts.next().value
        if ts.cur.kind == "int" and ts.peek().value == "times":
            decl.num_slots = int(ts.next().value)
            ts.next()  # times
        if ts.accept("op", "="):
            decl.init = self.parse_expr()
        return decl

    def _parse_bc_expr(self) -> Optional[N.Expr]:
        ts = self.ts
        if ts.at("ident", "None"):
            ts.next()
            return None
        if ts.at("ident", "Neumann"):
            ts.next()
            if ts.at("op", "("):
                ts.next()
                order = self.parse_expr()
                ts.expect("op", ")")
                return N.Call("Neumann", None, [order])
            return N.Call("Neumann", None, [])
        return self.parse_expr()

    def parse_override_bc(self) -> BcOverride:
        ts = self.ts
        ts.expect("ident", "override")
        ts.expect("keyword", "bc")
        assert ts.next().value == "for"
        name = ts.expect("ident").value
        levels = self.maybe_level()
        ts.expect("keyword", "with")
        return BcOverride(name, levels, self._parse_bc_expr())

    # ------------------------------------------------ operators / equations
    def parse_operator(self):
        """`Operator id [@lvl] from Stencil { .. } | from default ...`
        (operator/l3/L3_OperatorDecl)."""
        ts = self.ts
        name = ts.expect("ident").value
        levels = self.maybe_level()
        ts.expect("keyword", "from")
        if ts.at("ident", "default"):
            ts.next()
            kind = ts.next().value  # restriction | prolongation
            ts.expect("keyword", "on")
            loc = ts.next().value
            ts.expect("keyword", "with")
            interp = ts.expect("string").value
            return N.StencilFromDefault(name, kind, loc, interp, levels)
        if ts.at("keyword", "StencilField") or ts.at("ident", "StencilTemplate"):
            # `Operator A from StencilTemplate on Face_x of global { [o] => }`
            # (L2_StencilTemplateDecl): runtime-assembled stencil field
            ts.next()
            ts.expect("keyword", "on")
            loc = ts.next().value
            ts.expect("keyword", "of")
            dom = ts.next().value
            offsets = []
            ts.expect("op", "{")
            while not ts.at("op", "}"):
                offsets.append(tuple(self.parse_int_list()))
                ts.expect("op", "=>")
            ts.expect("op", "}")
            return N.StencilTemplateDecl(name, loc, dom, offsets, levels)
        ts.expect("keyword", "Stencil")
        decl = self._parse_stencil_body(name, levels)
        return decl

    def _parse_stencil_body(self, name: str, levels) -> N.StencilDecl:
        ts = self.ts
        entries = []
        ts.expect("op", "{")
        while not ts.at("op", "}"):
            ts.accept("op", ",")
            ts.expect("op", "[")
            first = [self.parse_expr()]
            while ts.accept("op", ","):
                first.append(self.parse_expr())
            ts.expect("op", "]")
            if ts.accept("keyword", "from"):
                ts.expect("op", "[")
                fe = [self.parse_expr()]
                while ts.accept("op", ","):
                    fe.append(self.parse_expr())
                ts.expect("op", "]")
                ts.expect("keyword", "with")
                coef = self.parse_expr()
                to_idx = [e.name for e in first if isinstance(e, N.Access)]
                entries.append(N.StencilMappingEntry(to_idx, fe, coef))
            else:
                ts.expect("op", "=>")
                entries.append(N.StencilOffsetEntry(first, self.parse_expr()))
        ts.expect("op", "}")
        return N.StencilDecl(name, levels, entries)

    def parse_equation(self, name: Optional[str] = None) -> EquationDecl:
        """`Equation id [@lvl] { lhs == rhs }` (solver/l3 L3_EquationDecl)."""
        ts = self.ts
        if name is None:
            name = ts.expect("ident").value
        levels = self.maybe_level()
        ts.expect("op", "{")
        eq = self.parse_expr()
        if not (isinstance(eq, N.BinOp) and eq.op == "=="):
            raise self.err("equation must be `lhs == rhs`")
        ts.expect("op", "}")
        return EquationDecl(name, levels, eq.lhs, eq.rhs)

    # ------------------------------------------------ generate ...
    def parse_generate(self, prog: L3Program):
        ts = self.ts
        ts.next()  # 'generate'
        what = ts.next().value
        if what == "solver":
            prog.gen_solvers.append(self.parse_generate_solver())
        elif what == "operators":
            prog.gen_operators.append(self.parse_generate_operators())
        else:
            raise self.err(f"unknown generate target {what!r}")

    def parse_generate_solver(self) -> GenerateSolver:
        ts = self.ts
        assert ts.next().value == "for"
        entries = [self._parse_solver_entry()]
        while ts.accept("keyword", "and"):
            entries.append(self._parse_solver_entry())
        gs = GenerateSolver(entries)
        if ts.accept("keyword", "with"):
            ts.expect("op", "{")
            while not ts.at("op", "}"):
                key = ts.next().value
                ts.expect("op", "=")
                gs.options[key] = self._parse_config_value()
            ts.expect("op", "}")
        if ts.at("ident", "modifiers"):
            ts.next()
            ts.expect("op", "{")
            while not ts.at("op", "}"):
                action = ts.next().value  # append | prepend | replace
                ts.expect("keyword", "to")
                target = ts.expect("string").value
                levels = self.maybe_level()
                stmts = self.parse_block()
                gs.modifiers.append((action, target, levels, stmts))
            ts.expect("op", "}")
        return gs

    def _parse_solver_entry(self) -> Tuple[str, str]:
        ts = self.ts
        unknown = ts.expect("ident").value
        assert ts.next().value == "in"
        eq = ts.expect("ident").value
        return (unknown, eq)

    def _parse_config_value(self):
        ts = self.ts
        t = ts.cur
        if t.kind == "string":
            ts.next()
            return t.value
        if t.value in ("true", "false"):
            ts.next()
            return t.value == "true"
        sgn = 1.0
        if ts.accept("op", "-"):
            sgn = -1.0
        t = ts.next()
        if t.kind == "int":
            return int(sgn) * int(t.value)
        if t.kind == "real":
            return sgn * float(t.value)
        return t.value

    def parse_generate_operators(self) -> GenerateOperators:
        ts = self.ts
        levels = self.maybe_level()
        go = GenerateOperators(levels)
        ts.expect("op", "{")
        while not ts.at("op", "}"):
            assert ts.next().value == "equation"
            assert ts.next().value == "for"
            unknown = ts.expect("ident").value
            assert ts.next().value == "is"
            eq = ts.expect("ident").value
            assert ts.next().value == "store"
            assert ts.next().value == "in"
            ts.expect("op", "{")
            store: Dict[str, str] = {}
            while not ts.at("op", "}"):
                f = ts.expect("ident").value
                ts.expect("op", "=>")
                store[f] = ts.expect("ident").value
            ts.expect("op", "}")
            go.entries.append((unknown, eq, store))
        ts.expect("op", "}")
        return go

    # ------------------------------------------------ statements
    def parse_assign_or_call(self) -> N.Stmt:
        """L3 allows `<field assign> where <cond>` (progressed to a masked
        loop in the reference's L3->L4 handler)."""
        st = super().parse_assign_or_call()
        if isinstance(st, N.Assign) and self.ts.at("keyword", "where"):
            self.ts.next()
            cond = self.parse_expr()
            return N.LoopOverField(
                N.Access(st.target.name, st.target.level), [st], condition=cond
            )
        return st


def parse_l3_file(path: str) -> L3Program:
    with open(path) as f:
        src = f.read()
    return L3Parser(src, path).parse_l3_program(
        base=os.path.dirname(os.path.abspath(path))
    )


def parse_l3(src_or_path: str) -> L3Program:
    if os.path.exists(src_or_path):
        return parse_l3_file(src_or_path)
    return L3Parser(src_or_path).parse_l3_program()


# ---------------------------------------------------------------- lowering

def _loc_layout(prog: N.Program, loc: str, dtype: str = "Real") -> str:
    key = "" if dtype == "Real" else         "_" + dtype.replace("<", "").replace(">", "").replace(" ", "")
    name = f"__loc_{loc}{key}__"
    if not any(l.name == name for l in prog.layouts):
        prog.layouts.append(N.LayoutDecl(name, dtype, loc, None))
    return name


def _flatten_terms(e: N.Expr, sign: float = 1.0):
    """Flatten a lhs into +/- terms."""
    if isinstance(e, N.BinOp) and e.op == "+":
        return _flatten_terms(e.lhs, sign) + _flatten_terms(e.rhs, sign)
    if isinstance(e, N.BinOp) and e.op == "-":
        return _flatten_terms(e.lhs, sign) + _flatten_terms(e.rhs, -sign)
    if isinstance(e, N.UnOp) and e.op == "-":
        return _flatten_terms(e.operand, -sign)
    return [(sign, e)]


def _contains_operator(x, operators: set) -> bool:
    if isinstance(x, N.Access):
        return x.name in operators
    if isinstance(x, N.BinOp):
        return _contains_operator(x.lhs, operators) or _contains_operator(
            x.rhs, operators)
    if isinstance(x, N.UnOp):
        return _contains_operator(x.operand, operators)
    return False


def analyze_equation(
    eq: EquationDecl, operators: set, fields: set
) -> Tuple[Optional[str], List[EqTerm]]:
    """Normalize an equation lhs into a sum of `[coef *] Op * field`
    terms (reference L3_EquationCollection normalization).  Coefficient
    factors may be arbitrary operator-free scalar expressions, including
    field accesses (LinearElasticity: `(lambda+mu)*(dxx*u + dxy*v) +
    lambda*Laplace*u`).  rhs is a field access or the literal 0
    (returned as None — the generator synthesizes a zero gen_rhs)."""
    if isinstance(eq.rhs, N.Access) and eq.rhs.name in fields:
        rhs_name: Optional[str] = eq.rhs.name
    elif isinstance(eq.rhs, N.Num) and float(eq.rhs.value) == 0.0:
        rhs_name = None
    else:
        raise NotImplementedError(
            f"equation {eq.name}: rhs must be a field access or 0")
    terms: List[EqTerm] = []

    def mul(a, b):
        if a is None:
            return b
        if b is None:
            return a
        return N.BinOp("*", a, b)

    def split_coef_op(x):
        """x contains exactly one operator access: (coefExpr|None, op)."""
        if isinstance(x, N.Access) and x.name in operators:
            return None, x.name
        if isinstance(x, N.BinOp) and x.op == "*":
            if _contains_operator(x.lhs, operators):
                c, op = split_coef_op(x.lhs)
                return mul(c, x.rhs), op
            if _contains_operator(x.rhs, operators):
                c, op = split_coef_op(x.rhs)
                return mul(x.lhs, c), op
        raise NotImplementedError(
            f"equation {eq.name}: cannot factor operator out of {x}")

    def emit(coef, sign, opname, fieldname):
        if sign != 1.0:
            coef = mul(N.Num(-1.0), coef) if coef is not None else N.Num(-1.0)
        terms.append(EqTerm(opname, fieldname, coef=coef))

    def walk(x, sign, coef):
        if isinstance(x, N.BinOp) and x.op in ("+", "-"):
            walk(x.lhs, sign, coef)
            walk(x.rhs, sign if x.op == "+" else -sign, coef)
            return
        if isinstance(x, N.UnOp) and x.op == "-":
            walk(x.operand, -sign, coef)
            return
        if isinstance(x, N.BinOp) and x.op == "*":
            lhs_has = _contains_operator(x.lhs, operators)
            rhs_has = _contains_operator(x.rhs, operators)
            if lhs_has and rhs_has:
                raise NotImplementedError(
                    f"equation {eq.name}: operator-operator product {x}")
            if rhs_has:  # coefficient * (operator expression)
                walk(x.rhs, sign, mul(coef, x.lhs))
                return
            if lhs_has:
                if isinstance(x.rhs, N.Access) and x.rhs.name in fields:
                    c2, opname = split_coef_op(x.lhs)
                    emit(mul(coef, c2), sign, opname, x.rhs.name)
                    return
                walk(x.lhs, sign, mul(coef, x.rhs))
                return
        raise NotImplementedError(
            f"equation {eq.name}: term {x} is not `[coef *] Operator * field`"
        )

    walk(eq.lhs, 1.0, None)
    return rhs_name, terms


def _add_bc_applications(stmts: List[N.Stmt], bc_fields: set) -> List[N.Stmt]:
    """The reference's L3->L4 progression inserts `apply bc` after every
    assignment to a bc-carrying field (app/l4/L4_LayerHandler.scala:106
    L4_AddCommunicationToLoops; visible in the generated
    2D_FD_Poisson_fromL4.exa4)."""
    out: List[N.Stmt] = []
    for s in stmts:
        if isinstance(s, N.Assign) and s.target.name in bc_fields:
            out.append(s)
            out.append(N.ApplyBC(N.Access(s.target.name, s.target.level)))
        elif isinstance(s, N.LoopOverField):
            out.append(s)
            # where-lowered field assignment loops: single assign body
            if (len(s.body) == 1 and isinstance(s.body[0], N.Assign)
                    and s.body[0].target.name == s.field.name
                    and s.field.name in bc_fields):
                out.append(N.ApplyBC(N.Access(s.field.name, s.field.level)))
        elif isinstance(s, N.If):
            out.append(N.If(s.cond, _add_bc_applications(s.then_body, bc_fields),
                            _add_bc_applications(s.else_body, bc_fields)))
        elif isinstance(s, N.RepeatTimes):
            out.append(N.RepeatTimes(s.count, _add_bc_applications(s.body, bc_fields),
                                     s.count_var, s.contraction))
        elif isinstance(s, N.RepeatUntil):
            out.append(N.RepeatUntil(s.cond, _add_bc_applications(s.body, bc_fields),
                                     s.is_while))
        elif isinstance(s, N.ColorWith):
            out.append(N.ColorWith(s.colors, _add_bc_applications(s.body, bc_fields)))
        elif isinstance(s, N.LevelScope):
            out.append(N.LevelScope(s.levels, _add_bc_applications(s.body, bc_fields)))
        else:
            out.append(s)
    return out


def lower_l3(l3: L3Program, knowledge, user_l4: Optional[N.Program] = None) -> N.Program:
    """Progress an L3 program (plus optional user L4 additions, e.g. a
    PrintError function from the companion .exa4 file) to an executable
    L4 N.Program (reference app/l3 schedule -> L4)."""
    prog = N.Program()
    prog.inline_knowledge.update(l3.inline_knowledge)
    prog.domains = list(l3.domains)
    prog.globals_ = list(l3.globals_)
    bc_fields = {
        fd.name for fd in l3.fields if fd.bc is not None
    } | {ov.field for ov in l3.bc_overrides if ov.bc is not None}
    # field-from clones inherit bcs
    for fd in l3.fields:
        if fd.from_field is not None and fd.from_field in bc_fields:
            bc_fields.add(fd.name)
    prog.functions = [
        N.FunctionDecl(f.name, f.levels, f.params, f.rettype,
                       _add_bc_applications(f.body, bc_fields), f.noinline)
        for f in l3.functions
    ]

    # --- operators -> stencils (StencilTemplates become stencil fields) ---
    for op in l3.operators:
        if isinstance(op, N.StencilTemplateDecl):
            prog.stencil_templates.append(op)
        else:
            prog.stencils.append(op)

    # --- resolve `from` field clones + bc overrides ---
    fields: Dict[str, List[L3FieldDecl]] = {}
    order: List[str] = []
    for fd in l3.fields:
        if fd.name not in fields:
            fields[fd.name] = []
            order.append(fd.name)
        fields[fd.name].append(fd)

    resolved: Dict[str, dict] = {}

    def resolve(name: str) -> dict:
        """Merge a field's declarations: defining decls (with
        localization or `from`), bc decls, per-level inits."""
        if name in resolved:
            return resolved[name]
        info = {"loc": None, "dtype": "Real", "domain": None,
                "level_decls": [], "bcs": [], "inits": [], "slots": 1}
        resolved[name] = info
        for d in fields.get(name, []):
            if d.from_field is not None:
                src = resolve(d.from_field)
                info["loc"] = src["loc"]
                info["dtype"] = src["dtype"]
                info["domain"] = src["domain"]
                info["bcs"].extend(src["bcs"])  # inherit bcs (L3 field-from)
                info["level_decls"].append(d.levels)
            elif d.localization is not None:
                info["loc"] = d.localization
                info["slots"] = max(info["slots"], d.num_slots)
                info["dtype"] = d.dtype
                info["domain"] = d.domain or info["domain"]
                info["level_decls"].append(d.levels)
                if d.init is not None:
                    info["inits"].append((d.levels, d.init))
            elif d.bc is not None or (d.init is None and d.localization is None):
                # `Field f [@lvl] on boundary = bc` (bc may be None-keyword)
                info["bcs"].append((d.levels, d.bc))
            if d.localization is None and d.from_field is None and d.init is not None \
                    and d.bc is None:
                info["inits"].append((d.levels, d.init))
        if info["loc"] is None:
            info["loc"] = "Node"
        return info

    for name in order:
        resolve(name)
    for ov in l3.bc_overrides:
        if ov.field in resolved:
            resolved[ov.field]["bcs"].append((ov.levels, ov.bc))

    eq_by_name = {e.name: e for e in l3.equations}
    op_names = {getattr(o, "name") for o in l3.operators}
    field_names = set(resolved)

    # --- generate operators: extract stencils from free-form equation
    # expressions and rewrite the equations into `sum Op * field` normal
    # form (reference `generate operators ... store in` + the L2
    # equation-to-stencil extraction) ---
    from exastencils_jax.dsl.gridops import contains_grid_call, expand_grid_calls
    from exastencils_jax.dsl.linearize import extract_stencils

    def _loc_of(nm: str) -> Optional[str]:
        return resolved[nm]["loc"] if nm in resolved else None

    for go in l3.gen_operators:
        for (unknown, eqname, store) in go.entries:
            eq = eq_by_name[eqname]
            lhs = eq.lhs
            if contains_grid_call(lhs):
                # FV surface integrals over the unknown's (staggered)
                # control volume become offset accesses + vf_gridWidth
                # areas (IR_IntegrateOnGrid), which linearize cleanly
                lhs = expand_grid_calls(lhs, knowledge.dimensionality, _loc_of)
            stencils = extract_stencils(lhs, set(store), knowledge.dimensionality)
            new_lhs: Optional[N.Expr] = None
            for fname, opname in store.items():
                entries = stencils.get(fname)
                if not entries:
                    continue
                prog.stencils.append(N.StencilDecl(opname, go.levels, entries))
                op_names.add(opname)
                term = N.BinOp("*", N.Access(opname), N.Access(fname))
                new_lhs = term if new_lhs is None else N.BinOp("+", new_lhs, term)
            if new_lhs is not None:
                eq_by_name[eqname] = EquationDecl(eqname, eq.levels, new_lhs, eq.rhs)

    # --- generate solver(s) ---
    gen_programs: List[N.Program] = []
    solve_fn = None
    for gs in l3.gen_solvers:
        entries = []
        for unknown, eqname in gs.entries:
            eq = eq_by_name[eqname]
            rhs, terms = analyze_equation(eq, op_names, field_names)
            entries.append(EqEntry(unknown, rhs, terms,
                                   localization=resolved[unknown]["loc"]))
        spec = SolverSpec(entries, gs.options, gs.modifiers)
        gen = SolverGenerator(spec, knowledge)
        gen_programs.append(gen.generate())
        solve_fn = "gen_solve"
        # unknowns: declared bc applies to finest only; coarser levels get
        # the zero-Dirichlet correction bc (L3_SolverForEqEntry.prepEqForMG)
        for e in entries:
            info = resolved[e.unknown]
            new_bcs = []
            for (lvls, bc) in info["bcs"]:
                is_neumann = isinstance(bc, N.Call) and bc.name == "Neumann"
                if lvls is None and not is_neumann and bc is not None:
                    new_bcs.append((N.LvlFinest(), bc))
                    new_bcs.append((N.LvlAllBut(N.LvlAll(), N.LvlFinest()), N.Num(0.0)))
                else:
                    new_bcs.append((lvls, bc))
            info["bcs"] = new_bcs

    # --- emit field decls: defining decls first (bc None), then bc decls
    # so later declarations override earlier per-level bcs ---
    for name in order:
        info = resolved[name]
        layout = _loc_layout(prog, info["loc"], info["dtype"])
        dom = info["domain"] or "global"
        for lvls in info["level_decls"] or [None]:
            prog.fields.append(
                N.FieldDecl(name, dom, layout, None, lvls, info["slots"]))
        for lvls, bc in info["bcs"]:
            prog.fields.append(
                N.FieldDecl(name, dom, layout, bc, lvls, info["slots"]))
    # --- merge generated solver programs ---
    for gp in gen_programs:
        prog.fields.extend(gp.fields)
        prog.stencils.extend(gp.stencils)
        prog.functions.extend(gp.functions)
        for l in gp.fields:
            _loc_layout(prog, l.layout[len("__loc_"):-2] if l.layout.startswith("__loc_") else "Node")

    # --- merge user L4 program (companion .exa4) ---
    if user_l4 is not None:
        prog.domains.extend(user_l4.domains)
        prog.layouts.extend(user_l4.layouts)
        prog.fields.extend(user_l4.fields)
        prog.stencils.extend(user_l4.stencils)
        prog.stencil_fields.extend(user_l4.stencil_fields)
        prog.functions.extend(user_l4.functions)
        prog.globals_.extend(user_l4.globals_)
        prog.inline_knowledge.update(user_l4.inline_knowledge)

    # --- InitFields function from field init expressions (the reference
    # L3->L4 progression generates this; companion .exa4 apps call it) ---
    lo = knowledge.minLevel
    hi = knowledge.maxLevel
    init_stmts: List[N.Stmt] = []
    for name in order:
        info = resolved[name]
        for lvls, ie in info["inits"]:
            if _is_zero(ie):
                continue  # initFieldsWithZero covers it
            for lvl in (lvls or N.LvlAll()).resolve(lo, hi):
                a = N.Access(name, N.LvlSingle(lvl))
                init_stmts.append(N.LoopOverField(a, [N.Assign(a, "=", ie)]))
    prog.functions.append(N.FunctionDecl("InitFields", None, [], "Unit", init_stmts))

    # --- default Application (L4_AddDefaultApplication) ---
    if not any(f.name == "Application" for f in prog.functions):
        app_init: List[N.Stmt] = [N.ExprStmt(N.Call("InitFields", None, []))]
        # apply bc at finest for bc-carrying fields
        for name in order:
            info = resolved[name]
            for (lvls, bc) in info["bcs"]:
                if bc is None:
                    continue
                if hi in (lvls or N.LvlAll()).resolve(lo, hi):
                    app_init.append(N.ApplyBC(N.Access(name, N.LvlFinest())))
                    break
        if solve_fn is None:
            solve_fn = "Solve" if any(f.name == "Solve" for f in prog.functions) else None
        if solve_fn is not None:
            prog.functions.append(default_application(app_init, solve_fn))
    return prog


def _is_zero(e: Optional[N.Expr]) -> bool:
    return isinstance(e, N.Num) and float(e.value) == 0.0
