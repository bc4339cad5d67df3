"""`solve locally` / `color with` execution: per-point block systems
(Vanka building block, solver/ir/IR_LocalSolve.scala:38) as batched
dense solves — split from interpreter.py (VERDICT r5 item 5)."""

from __future__ import annotations

import math
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from exastencils_jax.core import matval as MV
from exastencils_jax.core.field import DirichletBC, NeumannBC
from exastencils_jax.core.grid import CELL, FACES, NODE
from exastencils_jax.core.matval import MatVal, is_mat
from exastencils_jax.dsl import nodes as N
from exastencils_jax.dsl.interp_base import (
    _MATH_FNS,
    _LOC_MAP,
    Frame,
    _LoopCtx,
    _FieldInfo,
    _FunctionBC,
    _Return,
    _Break,
    _Exit,
    _classify_mat_shape,
    _compensated_sum,
    _fmt,
    _glibc_rand_stream,
    _is_stencil,
    _apply_binop,
    _apply_assign,
)
from exastencils_jax.utils.printing import reduced_prec_str

class L4LocalSolveMixin:
    def _exec_solve_locally(self, s: N.SolveLocally, fr: Frame, loop: _LoopCtx):
        """Per-point block solve (reference solver/ir/IR_LocalSolve.scala:38,
        the Vanka building block): unknowns are (field, offset) DOFs
        around the loop point (e.g. the 5 velocity/pressure DOFs of a
        staggered Stokes cell); neighbors outside the block are fixed.
        All points solve their n x n center system simultaneously as a
        batched dense solve followed by the relaxed masked update."""
        if loop is None:
            raise ValueError("solve locally outside a loop")
        nd = len(loop.shape)
        unknowns = [
            (u.name, self._resolve_level(u.level, fr), tuple(u.offset or (0,) * nd))
            for u in s.unknowns
        ]
        n = len(unknowns)
        relax = float(self.eval_expr(s.relax, fr, loop)) if s.relax is not None else 1.0
        dtype = self.dtype
        if any(self.fields[nm].is_complex for nm, _, _ in unknowns):
            dtype = self.complex_dtype  # complex per-point systems (Helmholtz)
        shape = loop.shape

        rows = []
        Dm = []
        for (lhs, rhs) in s.equations:
            r = self.eval_expr(rhs, fr, loop) - self.eval_expr(lhs, fr, loop)
            rows.append(jnp.broadcast_to(jnp.asarray(r, dtype), shape))
            coefs = self._block_coefs(lhs, unknowns, fr, loop)
            Dm.append([jnp.broadcast_to(jnp.asarray(c, dtype), shape) for c in coefs])

        # unknowns on the physical boundary (Dirichlet DOFs) get identity
        # rows: delta = 0, value kept for `apply bc` (reference
        # IR_LocalDirectInvert.scala:80-99, IR_IsValidComputationPoint)
        for j, (nm, lvl, off) in enumerate(unknowns):
            valid = self._valid_dof_mask(nm, lvl, off, shape)
            if valid is None:
                continue
            rows[j] = jnp.where(valid, rows[j], 0.0)
            for jj in range(n):
                ident = 1.0 if jj == j else 0.0
                Dm[j][jj] = jnp.where(valid, Dm[j][jj], ident)

        D = jnp.stack([jnp.stack(row, axis=-1) for row in Dm], axis=-2)  # (..., eq, unk)
        rv = jnp.stack(rows, axis=-1)[..., None]  # (..., eq, 1)
        delta = jnp.linalg.solve(D, rv)[..., 0]  # (..., unk)

        for j, (nm, lvl, off) in enumerate(unknowns):
            cur = self.get_field(nm, lvl)
            upd = relax * delta[..., j]
            if loop.mask is not None:
                upd = jnp.where(loop.mask, upd, 0)
            if cur.shape == tuple(shape) and not any(off):
                self.set_field(nm, lvl, cur + upd)
            else:
                from exastencils_jax.ops.shardsafe import embed_add

                self.set_field(nm, lvl, embed_add(cur, upd, tuple(off)))

    def _valid_dof_mask(self, name: str, lvl: int, off, shape):
        """False where the DOF (field, offset) sits on a physical-boundary
        plane whose value is bc-determined (reference
        IR_IsValidComputationPoint).  Function BCs count: their dup-plane
        writes pin those DOFs exactly like Dirichlet values, so local
        solves must give them identity rows (ExaStokes ApplyBC_u)."""
        info = self.fields[name]
        if not isinstance(info.bc_by_level.get(lvl), (DirichletBC, _FunctionBC)):
            return None
        loc = info.localization
        if loc == CELL:
            return None
        true_shape = self.true_shape(name, lvl)
        nd = len(shape)
        dims = list(range(nd)) if loc == NODE else [FACES.index(loc)]
        m = None
        for d in dims:
            i = lax.broadcasted_iota(jnp.int32, shape, d) + (off[d] if off else 0)
            ok = jnp.logical_and(i > 0, i < true_shape[d] - 1)
            m = ok if m is None else jnp.logical_and(m, ok)
        return m

    def _block_coefs(self, expr: N.Expr, unknowns, fr: Frame, loop):
        """Coefficient of each block unknown (field, offset) in one local
        equation: for a term `S@[off_f] * F@[off_f]`, unknown (F, off_u)
        couples with S.coef[off_u - off_f] (staggered index algebra)."""
        nd = len(loop.shape)
        coefs = [0.0] * len(unknowns)
        unk_fields = {nm for nm, _, _ in unknowns}

        def refs_unknown(e) -> bool:
            if isinstance(e, N.Access):
                return e.name in unk_fields
            if isinstance(e, N.BinOp):
                return refs_unknown(e.lhs) or refs_unknown(e.rhs)
            if isinstance(e, N.UnOp):
                return refs_unknown(e.operand)
            if isinstance(e, N.Call):
                return any(refs_unknown(a) for a in e.args)
            return False

        def add_field_term(acc: N.Access, factor, mult):
            """factor: None (plain access), scalar/array, or stencil marker."""
            off_f = tuple(acc.offset or (0,) * nd)
            lvl_f = self._resolve_level(acc.level, fr)
            for j, (nm, lvl, off_u) in enumerate(unknowns):
                if nm != acc.name or lvl != lvl_f:
                    continue
                if factor is not None and _is_stencil(factor):
                    st = factor[1]
                    delta = tuple(a - b for a, b in zip(off_u, off_f))
                    cmap = dict(zip(st.offsets, st.coefs))
                    if delta in cmap:
                        c = cmap[delta]
                        if hasattr(c, "shape") and c.shape:
                            # stencil-field coefficients are per-point
                            # arrays on the stencil's own grid: read them
                            # at loop point + off_f
                            c = self._to_loop_space(c, off_f, loop)
                        coefs[j] = coefs[j] + mult * c
                elif off_u == off_f:
                    coefs[j] = coefs[j] + mult * (1.0 if factor is None else factor)

        def walk(e, mult):
            if isinstance(e, N.BinOp) and e.op == "+":
                walk(e.lhs, mult)
                walk(e.rhs, mult)
                return
            if isinstance(e, N.BinOp) and e.op == "-":
                walk(e.lhs, mult)
                walk(e.rhs, -1.0 * mult)
                return
            if isinstance(e, N.UnOp) and e.op == "-":
                walk(e.operand, -1.0 * mult)
                return
            if isinstance(e, N.Access) and e.name in unk_fields:
                add_field_term(e, None, mult)
                return
            if isinstance(e, N.BinOp) and e.op == "*":
                if (
                    isinstance(e.rhs, N.Access)
                    and e.rhs.name in unk_fields
                    and not refs_unknown(e.lhs)
                ):
                    add_field_term(e.rhs, self.eval_expr(e.lhs, fr, loop), mult)
                    return
                if not refs_unknown(e.lhs):
                    walk(e.rhs, mult * self._as_scalar(e.lhs, fr, loop))
                    return
                if not refs_unknown(e.rhs):
                    walk(e.lhs, mult * self._as_scalar(e.rhs, fr, loop))
                    return
            if not refs_unknown(e):
                return  # constant term: no center dependence
            raise ValueError(f"solve locally: cannot linearize {e}")

        walk(expr, 1.0)
        return coefs

    def _as_scalar(self, e, fr, loop):
        v = self.eval_expr(e, fr, loop)
        if _is_stencil(v):
            raise ValueError("unexpected stencil factor")
        return v

