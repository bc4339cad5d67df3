"""Recursive-descent parser for ExaSlang 4.

Reference grammar: parsers/l4/L4_Parser.scala (productions cited per
method).  Covers the surface used by the reference Examples/ and
Testing/ suites; unsupported constructs raise SyntaxError with location.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

from exastencils_jax.dsl.lexer import Token, TokenStream, tokenize
from exastencils_jax.dsl import nodes as N

SLOT_KEYWORDS = {"active", "activeSlot", "next", "nextSlot", "previous", "previousSlot"}

# offset aliases (reference util/l4/L4_OffsetAlias.scala): parsed as the
# alias NAME; L4Executable resolves them to dimensionality-sized tuples
DIRECTION_ALIASES = {"center", "east", "west", "north", "south", "top", "bottom"}


class L4Parser:
    def __init__(self, src: str, filename: str = "<l4>"):
        self.ts = TokenStream(tokenize(src, filename), filename)
        self.filename = filename
        # FunctionTemplate declarations, instantiated by `Instantiate`
        # (L4_Parser.scala:218-221 generics)
        self._templates = {}

    # ------------------------------------------------------------------
    @classmethod
    def parse_file(cls, path: str) -> N.Program:
        with open(path) as f:
            src = f.read()
        return cls(src, path).parse_program(base=os.path.dirname(os.path.abspath(path)))

    def err(self, msg: str) -> SyntaxError:
        t = self.ts.cur
        return SyntaxError(f"{self.filename}:{t.line}:{t.col}: {msg} (at {t.value!r})")

    # ------------------------------------------------------------------
    def parse_program(self, base: str = ".") -> N.Program:
        prog = N.Program()
        ts = self.ts
        while not ts.at("eof"):
            if ts.accept("keyword", "import"):
                path = ts.expect("string").value
                sub = L4Parser.parse_file(os.path.join(base, path))
                for attr in ("domains", "layouts", "fields", "stencils",
                             "stencil_fields", "functions", "globals_"):
                    getattr(prog, attr).extend(getattr(sub, attr))
                prog.inline_knowledge.update(sub.inline_knowledge)
            elif ts.at("keyword", "Domain"):
                prog.domains.append(self.parse_domain())
            elif ts.at("keyword", "Layout"):
                prog.layouts.append(self.parse_layout())
            elif ts.at("keyword", "Field"):
                prog.fields.append(self.parse_field())
            elif ts.at("keyword", "external"):
                ts.next()
                ts.expect("keyword", "Field")  # external fields: parse & drop decl
                self.parse_field(consumed_kw=True)
            elif ts.at("keyword", "Stencil"):
                prog.stencils.append(self.parse_stencil())
            elif ts.at("keyword", "StencilField"):
                prog.stencil_fields.append(self.parse_stencil_field())
            elif ts.at("keyword", "Function") or ts.at("keyword", "noinline"):
                prog.functions.append(self.parse_function())
            elif ts.at("keyword", "Globals"):
                prog.globals_.extend(self.parse_globals())
            elif ts.at("keyword", "Knowledge"):
                prog.inline_knowledge.update(self.parse_inline_knowledge())
            elif ts.at_value("FunctionTemplate"):
                self.parse_function_template()
            elif ts.at_value("Instantiate"):
                prog.functions.append(self.parse_instantiate())
            elif ts.at_value("Equation"):
                # L4 `Equation id@lvl { lhs == rhs }` declarations (kept
                # by the L3->L4 progression for solve-locally/debug use;
                # parsed and recorded, referenced only where consumed)
                ts.next()
                name = ts.expect("ident").value
                level = self.maybe_level()
                ts.expect("op", "{")
                eq = self.parse_expr()  # `lhs == rhs` parses as one BinOp
                ts.expect("op", "}")
                prog.equations.append((name, level, eq))
            else:
                raise self.err("unexpected top-level construct")
        return prog

    # ------------------------------------------------------------------
    def parse_level_spec_after_at(self) -> N.LevelSpec:
        """After consuming '@' (L4_Parser.scala:118-168)."""
        ts = self.ts
        if ts.at("int"):
            return N.LvlSingle(int(ts.next().value))
        if ts.at("op", "("):
            ts.next()
            spec = self.parse_level_expr()
            ts.expect("op", ")")
            return spec
        return self.parse_level_atom()

    def parse_level_atom(self) -> N.LevelSpec:
        ts = self.ts
        t = ts.cur
        if t.kind == "op" and t.value == "(":
            ts.next()
            spec = self.parse_level_expr()
            ts.expect("op", ")")
            return spec
        if t.kind == "int":
            ts.next()
            return N.LvlSingle(int(t.value))
        name = t.value
        if name == "all":
            ts.next()
            return N.LvlAll()
        if name in ("finest", "coarsest", "current", "coarser", "finer"):
            ts.next()
            off = 0
            if (ts.at("op", "+") or ts.at("op", "-")) and ts.peek().kind == "int":
                sgn = -1 if ts.next().value == "-" else 1
                off = sgn * int(ts.expect("int").value)
            if name == "finest":
                return N.LvlFinest(off)
            if name == "coarsest":
                return N.LvlCoarsest(off)
            if name == "current":
                return N.LvlRelative(off)
            if name == "coarser":
                return N.LvlRelative(-1 + off)
            return N.LvlRelative(1 + off)
        raise self.err(f"bad level spec {name!r}")

    def parse_level_expr(self) -> N.LevelSpec:
        ts = self.ts
        if ts.at("keyword", "all") and ts.peek().value == "but":
            ts.next()
            ts.expect("keyword", "but")
            excluded = self.parse_level_atom()
            return N.LvlAllBut(N.LvlAll(), excluded)
        if ts.at("keyword", "not"):
            ts.next()
            excluded = self.parse_level_atom()
            return N.LvlAllBut(N.LvlAll(), excluded)
        first = self.parse_level_atom()
        if ts.at("keyword", "to"):
            ts.next()
            second = self.parse_level_atom()
            return N.LvlRange(first, second)
        if ts.at("keyword", "and") or ts.at("op", ","):
            specs = [first]
            while ts.accept("keyword", "and") or ts.accept("op", ","):
                specs.append(self.parse_level_atom())
            return N.LvlList(specs)
        if ts.at("keyword", "but"):
            ts.next()
            excluded = self.parse_level_atom()
            return N.LvlAllBut(first, excluded)
        return first

    def maybe_level(self) -> Optional[N.LevelSpec]:
        if self.ts.accept("op", "@"):
            return self.parse_level_spec_after_at()
        return None

    # ------------------------------------------------------------------
    def parse_domain(self) -> N.DomainDecl:
        """`Domain id< [lo] to [hi] >` (L4_Parser.scala:394)."""
        ts = self.ts
        ts.expect("keyword", "Domain")
        name = ts.expect("ident").value
        ts.expect("op", "<")
        lower = self.parse_number_list()
        ts.expect("keyword", "to")
        upper = self.parse_number_list()
        ts.expect("op", ">")
        return N.DomainDecl(name, lower, upper)

    def parse_number_list(self) -> List[float]:
        ts = self.ts
        ts.expect("op", "[")
        vals = [self.parse_signed_number()]
        while ts.accept("op", ","):
            vals.append(self.parse_signed_number())
        ts.expect("op", "]")
        return vals

    def parse_signed_number(self) -> float:
        ts = self.ts
        sgn = 1.0
        while ts.at("op", "-") or ts.at("op", "+"):
            if ts.next().value == "-":
                sgn = -sgn
        t = ts.cur
        if t.kind in ("int", "real"):
            ts.next()
            return sgn * float(t.value)
        raise self.err("expected number")

    def parse_int_list(self) -> Tuple[int, ...]:
        return tuple(int(v) for v in self.parse_number_list())

    # ------------------------------------------------------------------
    def parse_layout(self) -> N.LayoutDecl:
        """`Layout id< dtype, localization >@lvl { dup/ghost/innerPoints }`
        (L4_Parser.scala:398-401)."""
        ts = self.ts
        ts.expect("keyword", "Layout")
        name = ts.expect("ident").value
        ts.expect("op", "<")
        datatype = self.parse_datatype()
        ts.expect("op", ",")
        loc = ts.next().value
        ts.expect("op", ">")
        levels = self.maybe_level()
        decl = N.LayoutDecl(name, datatype, loc, levels)
        ts.expect("op", "{")
        while not ts.at("op", "}"):
            opt = ts.next().value
            ts.expect("op", "=")
            vals = self.parse_int_list()
            comm = False
            if ts.accept("keyword", "with"):
                ts.expect("ident", "communication")
                comm = True
            if opt == "duplicateLayers":
                decl.dup_layers, decl.dup_comm = vals, comm
            elif opt == "ghostLayers":
                decl.ghost_layers, decl.ghost_comm = vals, comm
            elif opt == "innerPoints":
                decl.inner_points = vals
            else:
                raise self.err(f"unknown layout option {opt!r}")
        ts.expect("op", "}")
        return decl

    _GENERIC_DTYPES = (
        "Matrix", "Vector", "ColumnVector", "RowVector", "Complex",
        "Tensor1", "Tensor2", "TensorN",
    )

    def parse_datatype(self) -> str:
        """Canonical datatype string, e.g. `Matrix<Real,2,2>`,
        `Complex<Double>` (reference L4_Parser.scala:175-205)."""
        ts = self.ts
        base = ts.next().value
        if base in self._GENERIC_DTYPES and ts.accept("op", "<"):
            parts = []
            while True:
                if ts.at("int"):
                    parts.append(ts.next().value)
                else:
                    parts.append(self.parse_datatype())
                if not ts.accept("op", ","):
                    break
            ts.expect("op", ">")
            return f"{base}<{','.join(parts)}>"
        return base

    # ------------------------------------------------------------------
    def parse_field(self, consumed_kw: bool = False) -> N.FieldDecl:
        """`Field id< domain, layout, bc >[slots]@lvl` (L4_Parser.scala:406)."""
        ts = self.ts
        if not consumed_kw:
            ts.expect("keyword", "Field")
        name = ts.expect("ident").value
        ts.expect("op", "<")
        domain = ts.next().value
        ts.expect("op", ",")
        layout = ts.next().value
        ts.expect("op", ",")
        if ts.at("ident", "None") or ts.at("keyword", "None"):
            ts.next()
            bc = None
        else:
            bc = self.parse_expr(stop_gt=True)
        ts.expect("op", ">")
        slots = 1
        if ts.accept("op", "["):
            slots = int(ts.expect("int").value)
            ts.expect("op", "]")
        levels = self.maybe_level()
        return N.FieldDecl(name, domain, layout, bc, levels, slots)

    # ------------------------------------------------------------------
    def parse_stencil(self) -> N.StencilDecl:
        """Offset entries `[o,..] => coef` and mapping entries
        `[i0,..] from [expr,..] with coef` (L4_Parser.scala:653)."""
        ts = self.ts
        ts.expect("keyword", "Stencil")
        name = ts.expect("ident").value
        levels = self.maybe_level()
        if ts.accept("keyword", "from"):
            if ts.at("op", "("):
                # `Stencil id from ( <stencil expr> )`
                ts.next()
                expr = self.parse_expr()
                ts.expect("op", ")")
                return N.StencilFromExpr(name, levels, expr)
            # `Stencil id from default restriction on Cell with 'linear'`
            ts.expect("ident", "default")
            kind = ts.next().value  # restriction | prolongation
            ts.expect("keyword", "on")
            loc = ts.next().value
            ts.expect("keyword", "with")
            interp = ts.expect("string").value
            if levels is None:
                levels = self.maybe_level()
            return N.StencilFromDefault(name, kind, loc, interp, levels)
        entries = []
        ts.expect("op", "{")
        while not ts.at("op", "}"):
            ts.accept("op", ",")
            if ts.cur.value in DIRECTION_ALIASES:
                # `east => 0.25` — direction-alias entry (SWE Centering)
                dirname = ts.next().value
                ts.expect("op", "=>")
                entries.append(N.StencilOffsetEntry(dirname, self.parse_expr()))
                continue
            ts.expect("op", "[")
            first_exprs = [self.parse_expr()]
            while ts.accept("op", ","):
                first_exprs.append(self.parse_expr())
            ts.expect("op", "]")
            if ts.accept("keyword", "from"):
                ts.expect("op", "[")
                from_exprs = [self.parse_expr()]
                while ts.accept("op", ","):
                    from_exprs.append(self.parse_expr())
                ts.expect("op", "]")
                ts.expect("keyword", "with")
                coef = self.parse_expr()
                to_idx = [e.name for e in first_exprs if isinstance(e, N.Access)]
                entries.append(N.StencilMappingEntry(to_idx, from_exprs, coef))
            else:
                ts.expect("op", "=>")
                coef = self.parse_expr()
                entries.append(N.StencilOffsetEntry(first_exprs, coef))
        ts.expect("op", "}")
        return N.StencilDecl(name, levels, entries)

    def parse_stencil_field(self) -> N.StencilFieldDecl:
        ts = self.ts
        ts.expect("keyword", "StencilField")
        name = ts.expect("ident").value
        ts.expect("op", "<")
        fld = ts.next().value
        ts.expect("op", "=>")
        st = ts.next().value
        ts.expect("op", ">")
        levels = self.maybe_level()
        return N.StencilFieldDecl(name, fld, st, levels)

    # ------------------------------------------------------------------
    def parse_function(self) -> N.FunctionDecl:
        ts = self.ts
        noinline = bool(ts.accept("keyword", "noinline"))
        ts.expect("keyword", "Function")
        name = ts.next().value
        levels = self.maybe_level()
        params: List[Tuple[str, str]] = []
        if ts.accept("op", "("):
            while not ts.at("op", ")"):
                pname = ts.expect("ident").value
                ts.expect("op", ":")
                ptype = self.parse_datatype()
                params.append((pname, ptype))
                if not ts.accept("op", ","):
                    break
            ts.expect("op", ")")
        rettype = "Unit"
        if ts.accept("op", ":"):
            rettype = self.parse_datatype()
        body = self.parse_block()
        return N.FunctionDecl(name, levels, params, rettype, body, noinline)

    def parse_function_template(self):
        """`FunctionTemplate id < tp0, tp1, ... > ( params ) : ret {...}`
        (L4_Parser.scala:218: function templates / generics)."""
        ts = self.ts
        ts.next()  # FunctionTemplate
        name = ts.expect("ident").value
        ts.expect("op", "<")
        tparams = [ts.expect("ident").value]
        while ts.accept("op", ","):
            tparams.append(ts.expect("ident").value)
        ts.expect("op", ">")
        params: List[Tuple[str, str]] = []
        if ts.accept("op", "("):
            while not ts.at("op", ")"):
                pname = ts.expect("ident").value
                ts.expect("op", ":")
                params.append((pname, self.parse_datatype()))
                if not ts.accept("op", ","):
                    break
            ts.expect("op", ")")
        rettype = "Unit"
        if ts.accept("op", ":"):
            rettype = self.parse_datatype()
        body = self.parse_block()
        self._templates[name] = (tparams, params, rettype, body)

    def parse_instantiate(self) -> N.FunctionDecl:
        """`Instantiate tmpl < args > as id@lvls` — expands the template
        body with the argument expressions substituted for the template
        parameters (L4_Parser.scala:221)."""
        ts = self.ts
        ts.next()  # Instantiate
        tname = ts.expect("ident").value
        if tname not in self._templates:
            raise self.err(f"unknown function template {tname!r}")
        ts.expect("op", "<")
        args = [self.parse_expr(stop_gt=True)]
        while ts.accept("op", ","):
            args.append(self.parse_expr(stop_gt=True))
        ts.expect("op", ">")
        kw = ts.next()
        if kw.value != "as":
            raise self.err("expected 'as' in Instantiate")
        name = ts.expect("ident").value
        levels = self.maybe_level()
        tparams, params, rettype, body = self._templates[tname]
        if len(args) != len(tparams):
            raise self.err(
                f"template {tname!r} takes {len(tparams)} args, got {len(args)}")
        inst = N.substitute(list(body), dict(zip(tparams, args)))
        return N.FunctionDecl(name, levels, list(params), rettype, inst, False)

    def parse_globals(self) -> List[N.VarDecl]:
        ts = self.ts
        ts.expect("keyword", "Globals")
        ts.expect("op", "{")
        out = []
        while not ts.at("op", "}"):
            out.append(self.parse_var_decl())
        ts.expect("op", "}")
        return out

    def parse_inline_knowledge(self) -> dict:
        ts = self.ts
        ts.expect("keyword", "Knowledge")
        ts.expect("op", "{")
        out = {}
        while not ts.at("op", "}"):
            key = ts.next().value
            ts.expect("op", "=")
            tok = ts.next()
            if tok.kind == "string":
                out[key] = tok.value
            elif tok.kind in ("int",):
                out[key] = int(tok.value)
            elif tok.kind == "real":
                out[key] = float(tok.value)
            elif tok.value in ("true", "false"):
                out[key] = tok.value == "true"
            else:
                out[key] = tok.value
        ts.expect("op", "}")
        return out

    # ------------------------------------------------------------------
    def parse_block(self) -> List[N.Stmt]:
        ts = self.ts
        ts.expect("op", "{")
        body = []
        while not ts.at("op", "}"):
            body.append(self.parse_statement())
        ts.expect("op", "}")
        return body

    def parse_var_decl(self) -> N.VarDecl:
        ts = self.ts
        kw = ts.next().value  # Var(iable) | Val(ue) | Expr
        is_val = kw in ("Val", "Value", "Expr")
        name = ts.expect("ident").value
        # `Expr f = <expression>` declares a LAZY alias: uses re-evaluate
        # the expression in context, and `f@east` evaluates it with every
        # contained access shifted (reference L4_ExpressionDeclaration —
        # inlined, not materialized; SWE flux expressions)
        dtype = "__Expr__" if kw == "Expr" else "Real"
        if ts.accept("op", ":"):
            dtype = self.parse_datatype()
        init = None
        if ts.accept("op", "="):
            init = self.parse_expr()
        return N.VarDecl(name, dtype, init, is_val)

    def parse_statement(self) -> N.Stmt:
        ts = self.ts
        t = ts.cur
        if t.value in ("Var", "Variable", "Val", "Value", "Expr"):
            return self.parse_var_decl()
        if t.value == "if":
            return self.parse_if()
        if t.value == "repeat":
            return self.parse_repeat()
        if t.value == "loop":
            return self.parse_loop()
        if t.value == "communicate" or t.value == "begin" or t.value == "finish":
            return self.parse_communicate()
        if t.value == "apply":
            ts.next()
            ts.expect("keyword", "bc")
            ts.expect("keyword", "to")
            return N.ApplyBC(self.parse_access())
        if t.value == "advance":
            ts.next()
            return N.Advance(self.parse_access())
        if t.value == "return":
            ts.next()
            if ts.at("op", "}"):
                return N.Return(None)
            return N.Return(self.parse_expr())
        if t.value == "break":
            ts.next()
            return N.Break()
        if t.value == "color":
            ts.next()
            ts.expect("keyword", "with")
            ts.expect("op", "{")
            colors = self.parse_expr()
            ts.expect("op", ",")
            more = []
            # additional `expr % n,` colorings (cross-product, e.g.
            # `color with { i0 % 3, i1 % 3, ... }`): an expression
            # followed by a comma is a color, not a statement
            while True:
                mark = ts.i
                try:
                    c = self.parse_expr()
                except SyntaxError:
                    ts.i = mark
                    break
                if ts.accept("op", ","):
                    more.append(c)
                else:
                    ts.i = mark
                    break
            body = []
            while not ts.at("op", "}"):
                body.append(self.parse_statement())
            ts.expect("op", "}")
            return N.ColorWith(colors, body, more_colors=more)
        if t.value == "solve":
            return self.parse_solve_locally()
        if t.value == "solveMatSys":
            ts.next()
            A = self.parse_access()
            ts.expect("op", ",")
            u = self.parse_access()
            ts.expect("op", ",")
            f = self.parse_access()
            if ts.accept("op", "{"):  # {shape=..., ...} hints: ignored
                while not ts.at("op", "}"):
                    ts.next()
                ts.expect("op", "}")
            return N.SolveMatSys(A, u, f)
        if t.kind == "op" and t.value == "@":
            ts.next()
            spec = self.parse_level_spec_after_at()
            body = self.parse_block()
            return N.LevelScope(spec, body)
        # assignment or expression statement
        return self.parse_assign_or_call()

    def parse_if(self) -> N.If:
        ts = self.ts
        ts.expect("keyword", "if")
        ts.expect("op", "(")
        cond = self.parse_expr()
        ts.expect("op", ")")
        then_body = self.parse_block()
        else_body: List[N.Stmt] = []
        if ts.accept("keyword", "else"):
            if ts.at("keyword", "if"):
                else_body = [self.parse_if()]
            else:
                else_body = self.parse_block()
        return N.If(cond, then_body, else_body)

    def parse_repeat(self) -> N.Stmt:
        ts = self.ts
        ts.expect("keyword", "repeat")
        if ts.accept("keyword", "with"):
            # `repeat with { cond0, cond1, ..., stmts }` (L4_Parser.scala:337)
            ts.expect("op", "{")
            conds = []
            while True:
                save = ts.i
                try:
                    e = self.parse_expr()
                    if ts.at("op", ","):
                        ts.next()
                        conds.append(e)
                        continue
                    ts.i = save
                    break
                except SyntaxError:
                    ts.i = save
                    break
            body = []
            while not ts.at("op", "}"):
                body.append(self.parse_statement())
            ts.expect("op", "}")
            return N.RepeatWith(conds, body)
        if ts.accept("keyword", "until"):
            cond = self.parse_expr()
            body = self.parse_block()
            return N.RepeatUntil(cond, body, is_while=False)
        if ts.accept("keyword", "while"):
            cond = self.parse_expr()
            body = self.parse_block()
            return N.RepeatUntil(cond, body, is_while=True)
        count = self.parse_expr()
        ts.expect("keyword", "times")
        count_var = None
        contraction = None
        if ts.accept("keyword", "count"):
            count_var = ts.expect("ident").value
        if ts.accept("keyword", "with"):
            ts.expect("keyword", "contraction")
            contraction = self.parse_int_list()
        body = self.parse_block()
        return N.RepeatTimes(count, body, count_var, contraction)

    def parse_loop(self) -> N.Stmt:
        """`loop over ...` (L4_Parser.scala:286-305)."""
        ts = self.ts
        ts.expect("keyword", "loop")
        ts.expect("keyword", "over")
        if ts.at("keyword", "fragments"):
            ts.next()
            red = self.maybe_reduction()
            body = self.parse_block()
            return N.LoopOverFragments(body, red)
        field = self.parse_access()
        loop = N.LoopOverField(field, [])
        while not ts.at("op", "{"):
            if ts.accept("keyword", "only"):
                region = ts.next().value  # ghost|dup|inner
                rdir = None
                if ts.at("op", "["):
                    rdir = self.parse_int_list()
                loop.region = (region, rdir)
                if ts.accept("keyword", "on"):
                    ts.expect("keyword", "boundary")
                    loop.on_boundary = True
            elif ts.accept("keyword", "sequentially"):
                loop.sequentially = True
            elif ts.accept("keyword", "novect"):
                pass  # vectorization hint (L4_Parser.scala:295) — XLA's
                # call; semantics unchanged
            elif ts.accept("keyword", "where"):
                loop.condition = self.parse_expr()
            elif ts.accept("keyword", "starting"):
                loop.starting = self.parse_int_list()
            elif ts.accept("keyword", "ending"):
                loop.ending = self.parse_int_list()
            elif ts.accept("keyword", "stepping"):
                loop.stepping = self.parse_int_list()
            elif ts.at("keyword", "with"):
                loop.reduction = self.maybe_reduction()
            else:
                raise self.err("unexpected loop modifier")
        loop.body = self.parse_block()
        return loop

    def maybe_reduction(self) -> Optional[Tuple[str, str]]:
        ts = self.ts
        if not ts.accept("keyword", "with"):
            return None
        ts.expect("keyword", "reduction")
        ts.expect("op", "(")
        op = ts.next().value  # + | * | min | max
        ts.expect("op", ":")
        var = ts.expect("ident").value
        ts.expect("op", ")")
        return (op, var)

    def parse_communicate(self) -> N.Communicate:
        ts = self.ts
        op = "both"
        if ts.at("keyword", "begin") or ts.at("keyword", "finish"):
            op = ts.next().value
            ts.expect("keyword", "communicate")
        else:
            ts.expect("keyword", "communicate")
            if ts.at("keyword", "begin") or ts.at("keyword", "finish"):
                op = ts.next().value
        targets = []
        while ts.cur.value in ("all", "dup", "ghost"):
            targets.append(ts.next().value)
            if ts.at("op", "["):  # index range - parse & ignore for now
                self.parse_int_list()
                if ts.accept("keyword", "to"):
                    self.parse_int_list()
            ts.accept("keyword", "of")
        field = self.parse_access()
        if ts.accept("keyword", "where"):
            self.parse_expr()  # condition: accepted, not yet used
        return N.Communicate(field, op, targets)

    def parse_solve_locally(self) -> N.SolveLocally:
        ts = self.ts
        ts.expect("keyword", "solve")
        ts.expect("keyword", "locally")
        jac = False
        relax = None
        anchor = None
        while True:
            if ts.accept("keyword", "with"):
                ts.expect("keyword", "jacobi")
                jac = True
            elif ts.accept("keyword", "relax"):
                relax = self.parse_expr()
            elif ts.at("ident", "at"):
                # `solve locally at p ...`: anchor field supplies the
                # implicit iteration space (L4_LocalSolve.scala)
                ts.next()
                anchor = self.parse_access()
            else:
                break
        ts.expect("op", "{")
        unknowns = []
        equations = []
        while not ts.at("op", "}"):
            u = self.parse_access()
            ts.expect("op", "=>")
            eq = self.parse_expr()  # `lhs == rhs` parses as one comparison
            if not (isinstance(eq, N.BinOp) and eq.op == "=="):
                raise self.err("solve locally equation must be `lhs == rhs`")
            unknowns.append(u)
            equations.append((eq.lhs, eq.rhs))
        ts.expect("op", "}")
        sl = N.SolveLocally(unknowns, equations, jac, relax)
        if anchor is not None:
            # anchored form: wrap in the implicit loop over the anchor
            # field so color masks / interior masks apply as usual
            return N.LoopOverField(anchor, [sl])
        return sl

    def parse_assign_or_call(self) -> N.Stmt:
        ts = self.ts
        start = ts.i
        target = self.parse_access(allow_call=True)
        if isinstance(target, N.Call):
            return N.ExprStmt(target)
        if ts.cur.value in ("=", "+=", "-=", "*=", "/="):
            op = ts.next().value
            value = self.parse_expr()
            return N.Assign(target, op, value)
        # bare access as statement? treat as 0-arg call
        ts.i = start
        expr = self.parse_expr()
        return N.ExprStmt(expr)

    # ------------------------------------------------------------------
    # expressions
    def parse_expr(self, stop_gt: bool = False, no_compare: bool = False) -> N.Expr:
        return self.parse_or(stop_gt, no_compare)

    def parse_or(self, stop_gt=False, no_compare=False) -> N.Expr:
        lhs = self.parse_and(stop_gt, no_compare)
        while self.ts.at("op", "||") or self.ts.at("ident", "or"):
            self.ts.next()
            lhs = N.BinOp("||", lhs, self.parse_and(stop_gt, no_compare))
        return lhs

    def parse_and(self, stop_gt=False, no_compare=False) -> N.Expr:
        lhs = self.parse_compare(stop_gt, no_compare)
        while self.ts.at("op", "&&") or self.ts.at("keyword", "and"):
            self.ts.next()
            lhs = N.BinOp("&&", lhs, self.parse_compare(stop_gt, no_compare))
        return lhs

    def parse_compare(self, stop_gt=False, no_compare=False) -> N.Expr:
        lhs = self.parse_add(stop_gt)
        while True:
            t = self.ts.cur
            ops = ["==", "!=", "<=", ">="]
            if not no_compare:
                ops += ["<"] + ([] if stop_gt else [">"])
            if t.kind == "op" and t.value in ops:
                self.ts.next()
                lhs = N.BinOp(t.value, lhs, self.parse_add(stop_gt))
            else:
                return lhs

    def parse_add(self, stop_gt=False) -> N.Expr:
        lhs = self.parse_mul(stop_gt)
        while self.ts.cur.value in ("+", "-") and self.ts.cur.kind == "op":
            op = self.ts.next().value
            lhs = N.BinOp(op, lhs, self.parse_mul(stop_gt))
        return lhs

    def parse_mul(self, stop_gt=False) -> N.Expr:
        lhs = self.parse_unary(stop_gt)
        while self.ts.cur.kind == "op" and self.ts.cur.value in (
            "*", "/", "%", ".*", "./", ".^", ".%"
        ):
            op = self.ts.next().value
            lhs = N.BinOp(op, lhs, self.parse_unary(stop_gt))
        return lhs

    def parse_unary(self, stop_gt=False) -> N.Expr:
        ts = self.ts
        if ts.at("op", "-"):
            ts.next()
            return N.UnOp("-", self.parse_unary(stop_gt))
        if ts.at("op", "+"):
            ts.next()
            return self.parse_unary(stop_gt)
        if ts.at("op", "!"):
            ts.next()
            return N.UnOp("!", self.parse_unary(stop_gt))
        return self.parse_power(stop_gt)

    def parse_power(self, stop_gt=False) -> N.Expr:
        base = self.parse_primary(stop_gt)
        if self.ts.at("op", "**"):
            self.ts.next()
            return N.BinOp("**", base, self.parse_unary(stop_gt))
        return base

    def parse_primary(self, stop_gt=False) -> N.Expr:
        ts = self.ts
        t = ts.cur
        if t.kind in ("int", "real"):
            ts.next()
            return N.Num(float(t.value), is_int=t.kind == "int")
        if t.kind == "imag":
            ts.next()
            return N.Num(float(t.value), is_imag=True)
        if t.kind == "string":
            ts.next()
            return N.Str(t.value)
        if ts.at("op", "("):
            ts.next()
            e = self.parse_expr()
            ts.expect("op", ")")
            if ts.at("ident", "j"):
                # `(expr)j` imaginary suffix (ComplexNumbers suites)
                ts.next()
                return N.UnOp("im", e)
            return e
        if t.kind == "ident" and t.value in ("tens1", "tens2", "tensN") \
                and ts.peek().value == "{":
            return self.parse_tensor_literal()
        if ts.at("op", "["):
            # `[a; b; c]` column-vector literal (L4 matrix expressions;
            # IOTest vector suites, SWE flux vectors) — rows split on ';'
            ts.next()
            rows = [[self.parse_expr()]]
            while ts.accept("op", ";"):
                rows.append([self.parse_expr()])
            ts.expect("op", "]")
            return N.MatrixLit(rows)
        if ts.at("op", "{"):
            # matrix `{ {..},{..} }` or column-vector `{a, b}` literal
            ts.next()
            rows: list = []
            if ts.at("op", "{"):
                while not ts.at("op", "}"):
                    ts.expect("op", "{")
                    row = [self.parse_expr()]
                    while ts.accept("op", ","):
                        row.append(self.parse_expr())
                    ts.expect("op", "}")
                    rows.append(row)
                    ts.accept("op", ",")
            else:
                while not ts.at("op", "}"):
                    rows.append([self.parse_expr()])
                    if not ts.accept("op", ","):
                        break
            ts.expect("op", "}")
            if ts.accept("ident", "T"):
                # `{a, b}T` — transposed literal (reference L4 matrix
                # expressions).  A flat `{a, b}` parses here as a column
                # vector already, which IS the reference's row-literal-
                # transposed; nested literals transpose for real.
                if any(len(r) != 1 for r in rows):
                    rows = [list(col) for col in zip(*rows)]
            return N.MatrixLit(rows)
        if t.kind in ("ident", "keyword"):
            if t.value in ("true", "false"):
                ts.next()
                return N.Num(1.0 if t.value == "true" else 0.0, is_int=True)
            return self.parse_access(allow_call=True)
        raise self.err("expected expression")

    def parse_tensor_literal(self) -> N.TensorLit:
        """`tens1{ n ; [idx] := expr, ... }`, `tens2{ [i,j] := ... }`
        (dim defaults to 3 when omitted), `tensN{ dim ; order ; ... }`
        (TensorClass suites; reference baseExt L4 tensor expressions)."""
        ts = self.ts
        kw = ts.next().value  # tens1 | tens2 | tensN
        ts.expect("op", "{")
        if kw == "tensN":
            dim = int(ts.expect("int").value)
            ts.expect("op", ";")
            order = int(ts.expect("int").value)
            ts.expect("op", ";")
        else:
            order = int(kw[-1])
            dim = 3
            if ts.at("int") and ts.peek().value == ";":
                dim = int(ts.next().value)
                ts.next()  # ';'
        entries = []
        while not ts.at("op", "}"):
            idx = self.parse_int_list()
            ts.expect("op", ":=")
            entries.append((idx, self.parse_expr()))
            ts.accept("op", ",")
        ts.expect("op", "}")
        return N.TensorLit(order, dim, entries)

    def parse_access(self, allow_call: bool = False) -> N.Expr:
        """ident [@lvl | @[offset]] [<slot>] [( args )] [[offsets]]"""
        ts = self.ts
        name = ts.next().value
        level = None
        offset0 = None
        slot = None
        # slot/level/offset modifiers may appear in either order
        # (`Solution<active>@current`, `Solution@current<next>`)
        while True:
            if offset0 is None and ts.at("op", "@") \
                    and ts.peek().value in DIRECTION_ALIASES:
                # `F@east` — offset alias (L4_OffsetAlias), resolved to a
                # concrete tuple once the dimensionality is known
                ts.next()
                offset0 = ts.next().value
            elif level is None and ts.at("op", "@") and ts.peek().value != "[":
                mark = ts.i
                ts.next()
                level = self.parse_level_spec_after_at()
                if isinstance(level, (N.LvlAllBut, N.LvlList, N.LvlAll)) \
                        and ts.at("op", "{"):
                    # not this access's level: a level-SCOPE statement
                    # follows (`apply bc to dest \n @(all but ...) { ... }`
                    # — ExaFluids templates; multi-level specs are not
                    # meaningful on a value access anyway).  Backtrack.
                    ts.i = mark
                    break
            elif offset0 is None and ts.at("op", "@") and ts.peek().value == "[":
                ts.next()
                offset0 = self.parse_int_list()
            elif slot is None and ts.at("op", "<") and self._looks_like_slot():
                ts.next()
                slot = ts.next().value
                ts.expect("op", ">")
            else:
                break
        if allow_call and ts.at("op", "("):
            ts.next()
            args = []
            while not ts.at("op", ")"):
                args.append(self.parse_expr())
                if not ts.accept("op", ","):
                    break
            ts.expect("op", ")")
            return N.Call(name, level, args)
        offset = offset0
        if offset is None and ts.at("op", "[") and self._bracket_is_offset():
            offset = self.parse_int_list()
        # stencil-field entry designator `A:[-1,0]` (may follow an @[..]
        # offset; reference L4 stencil-field access/assignment syntax)
        sten_entry = None
        if ts.at("op", ":") and ts.peek().value == "[":
            ts.next()
            sten_entry = tuple(self.parse_int_list())
        # matrix/vector component access: `m[i][j]`, `m[0:2][:]`, `v[i]`
        comps = []
        while ts.at("op", "[") and self._bracket_is_component():
            comps.extend(self._parse_component_group())
        return N.Access(name, level, offset, slot, tuple(comps) or None,
                        sten_entry)

    def _looks_like_slot(self) -> bool:
        t1 = self.ts.peek(1)
        t2 = self.ts.peek(2)
        return (t1.value in SLOT_KEYWORDS or t1.kind == "int") and t2.value == ">"

    def _scan_bracket_group(self):
        """Tokens of the bracket group starting at the cursor (which must
        be '['), up to the matching ']' (exclusive)."""
        toks = self.ts.toks
        j = self.ts.i + 1
        out = []
        depth = 1
        while j < len(toks):
            t = toks[j]
            if t.value == "[":
                depth += 1
            elif t.value == "]":
                depth -= 1
                if depth == 0:
                    return out
            out.append(t)
            j += 1
        return out

    def _bracket_is_offset(self) -> bool:
        """`[1, 0]`-style stencil offsets: a comma-separated all-int list
        (a single `[i]` group parses as a component access instead and is
        reinterpreted as a 1D offset by the executor when the target is a
        scalar field)."""
        grp = self._scan_bracket_group()
        if not any(t.value == "," for t in grp):
            return False
        return all(
            t.kind == "int" or t.value in (",", "-", "+") for t in grp
        )

    def _bracket_is_component(self) -> bool:
        return bool(self._scan_bracket_group())

    def _parse_component_group(self):
        """One `[...]` group: `:` | `expr` | `expr : expr`; a comma
        splits the group into multiple index components within one
        bracket pair (`t1[a, 2]`, TensorClass access syntax) — the
        caller flattens the returned list."""
        ts = self.ts
        ts.expect("op", "[")
        out = []
        while True:
            if ts.accept("op", ":"):
                out.append(("slice", None, None))
            else:
                e1 = self.parse_expr()
                if ts.accept("op", ":"):
                    out.append(("slice", e1, self.parse_expr()))
                else:
                    out.append(("idx", e1))
            if not ts.accept("op", ","):
                break
        ts.expect("op", "]")
        return out


def parse_l4(src_or_path: str) -> N.Program:
    if os.path.exists(src_or_path):
        return L4Parser.parse_file(src_or_path)
    return L4Parser(src_or_path).parse_program()
