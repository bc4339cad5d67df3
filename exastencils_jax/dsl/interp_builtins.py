"""Builtin-function evaluation of the L4 interpreter: the reference's
resolved native/timer/IO/print/matrix builtins (util/ir, timing/ir,
io/ir resolvers) — split from interpreter.py (VERDICT r5 item 5)."""

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

class L4BuiltinsMixin:
    def _eval_call(self, e: N.Call, fr: Frame, loop):
        name = e.name
        if (name.startswith(("integrateOver", "evalAt"))
                and name.endswith("Face")):
            # grid integral / face evaluation: expand once per call site
            # into interpolated offset accesses * face area (gridops,
            # reference IR_IntegrateOnGrid/IR_EvaluateOnGrid), then
            # evaluate the rewritten expression normally
            # keyed by id(e) WITH the node retained in the entry: id
            # reuse after GC of a transient AST can otherwise alias a
            # different call site to a stale expansion (advisor r3 #3)
            key = id(e)
            hit = self._gridcall_cache.get(key)
            cached = hit[1] if hit is not None and hit[0] is e else None
            if cached is None:
                from exastencils_jax.dsl.gridops import expand_grid_call

                def loc_of(nm):
                    if nm in self.stencil_templates:
                        return self.stencil_templates[nm].localization
                    info = self.fields.get(nm)
                    return info.localization if info else None

                cached = expand_grid_call(e, self.k.dimensionality, loc_of)
                if cached is None:
                    raise ValueError(f"unrecognized grid call {name!r}")
                self._gridcall_cache[key] = (e, cached)
            return self.eval_expr(cached, fr, loop)
        if name in _MATH_FNS:
            return _MATH_FNS[name](self.eval_expr(e.args[0], fr, loop))
        if name in ("min", "max"):
            vals = [self.eval_expr(a, fr, loop) for a in e.args]
            f = jnp.minimum if name == "min" else jnp.maximum
            out = vals[0]
            for v in vals[1:]:
                out = f(out, v)
            return out
        if name == "pow":
            return self.eval_expr(e.args[0], fr, loop) ** self.eval_expr(e.args[1], fr, loop)
        if name == "diag":
            st = self.eval_expr(e.args[0], fr, loop)
            if isinstance(st, tuple) and st[0] == "__stencil__":
                return st[1].diag()
            raise ValueError("diag() expects a stencil")
        if name == "diag_inv":
            # L3 inverse-diagonal builtin (operator/l3 diag_inv)
            st = self.eval_expr(e.args[0], fr, loop)
            if isinstance(st, tuple) and st[0] == "__stencil__":
                return 1.0 / st[1].diag()
            raise ValueError("diag_inv() expects a stencil")
        if name in ("transpose", "transposed"):
            v = self.eval_expr(e.args[0], fr, loop)
            if _is_stencil(v):
                return ("__stencil__", v[1].transposed(), v[2])
            if is_mat(v):
                return MV.transpose(v)
            return jnp.swapaxes(v, -1, -2)
        if name == "dot":
            a = self.eval_expr(e.args[0], fr, loop)
            b = self.eval_expr(e.args[1], fr, loop)
            if is_mat(a) and is_mat(b):
                return MV.dot_product(a, b)
            # L3 field dot product: sum over all grid points
            # (solver/l3 L3_FieldFieldConvolution); optional third arg
            # selects the summation algorithm (ComplexNumbers/sumAlgos)
            if len(e.args) > 2:
                algo = str(getattr(e.args[2], "value", "")).strip("'\"")
                return _compensated_sum((a * b).ravel(), algo)
            return jnp.sum(a * b)
        # ---- matrix builtins (reference baseExt/ir/IR_MatNodes/*) ----
        if name == "dotProduct":
            return MV.dot_product(self.eval_expr(e.args[0], fr, loop),
                                  self.eval_expr(e.args[1], fr, loop))
        if name == "cross":
            return MV.cross(self.eval_expr(e.args[0], fr, loop),
                            self.eval_expr(e.args[1], fr, loop))
        if name == "trace":
            return MV.trace(self.eval_expr(e.args[0], fr, loop))
        if name in ("det", "determinant"):
            v = self.eval_expr(e.args[0], fr, loop)
            return MV.determinant(v) if is_mat(v) else v
        if name in ("inverse", "inv"):
            # extra string args are shape hints ("shape=schur", "block=6",
            # IR_ClassifyMatShape.scala) selecting the reference's inversion
            # algorithm; the batched LU inverse handles every shape here
            v = self.eval_expr(e.args[0], fr, loop)
            if _is_stencil(v):
                raise ValueError("stencil inverse not supported; use diag_inv")
            return MV.inverse(v)
        if name in ("norm", "frobeniusNorm"):
            v = self.eval_expr(e.args[0], fr, loop)
            if is_mat(v):
                return MV.frobenius_norm(v)
            if (hasattr(v, "dtype") and jnp.iscomplexobj(v)) or isinstance(v, complex):
                # std::norm semantics: |z|^2 (ComplexNumbers/BasicFunc)
                a = jnp.abs(v) if hasattr(v, "dtype") else abs(v)
                return a * a
            return jnp.sqrt(jnp.sum(jnp.asarray(v) ** 2))
        # ---- tensor builtins (reference baseExt/ir/IR_TensorOperations
        # .scala resolveFunctions: add/dotp/dyadic/deter/eigen/...) ----
        if name == "add":
            a = self.eval_expr(e.args[0], fr, loop)
            b = self.eval_expr(e.args[1], fr, loop)
            if is_mat(a) and is_mat(b):
                return MatVal(a.data + b.data)
            return a + b
        if name == "dotp":
            # tensor "dot product" is ELEMENTWISE (dotProductTwoTensors2
            # multiplies entry-by-entry, IR_TensorOperations.scala:1066)
            a = self.eval_expr(e.args[0], fr, loop)
            b = self.eval_expr(e.args[1], fr, loop)
            if is_mat(a) and is_mat(b):
                return MatVal(a.data * b.data)
            return a * b
        if name == "scalar":
            a = self.eval_expr(e.args[0], fr, loop)
            s = self.eval_expr(e.args[1], fr, loop)
            return MatVal(a.data * s) if is_mat(a) else a * s
        if name == "dyadic":
            # outer product: order(a)+order(b) result (dyadicProduct*)
            a = self.eval_expr(e.args[0], fr, loop)
            b = self.eval_expr(e.args[1], fr, loop)
            da = a.data[..., 0] if is_mat(a) and a.data.shape[-1] == 1 else a.data
            db = b.data[..., 0] if is_mat(b) and b.data.shape[-1] == 1 else b.data
            return MatVal(jnp.tensordot(da, db, axes=0,
                                         precision=lax.Precision.HIGHEST))
        if name == "deter":
            return MV.determinant(self.eval_expr(e.args[0], fr, loop))
        if name == "asTensor1":
            v = self.eval_expr(e.args[0], fr, loop)
            return MatVal(jnp.reshape(v.data, (-1, 1)))
        if name == "asTensor2":
            v = self.eval_expr(e.args[0], fr, loop)
            n = int(round(math.sqrt(v.data.size)))
            return MatVal(jnp.reshape(v.data, (n, n)))
        if name == "eigen":
            # eigen(t, res): eigenvalues of an order-2 tensor into a
            # Matrix<Real, dims, 1> (reference QR/Householder iteration,
            # IR_TensorOperations.scala:480-520; jnp.linalg is the
            # batched-XLA formulation)
            t = self.eval_expr(e.args[0], fr, loop)
            try:  # concrete tensors: host LAPACK (general eigvals has no
                # GPU lowering; these are compile-time constants anyway)
                w = jnp.asarray(np.sort(
                    np.real(np.linalg.eigvals(np.asarray(t.data)))
                )[::-1])
            except jax.errors.TracerArrayConversionError:
                w = jnp.sort(
                    jnp.real(jnp.linalg.eigvals(t.data.astype(self.complex_dtype)))
                )[::-1]
            self._mutate_matrix_var(
                e.args[1], fr, loop,
                lambda m: MatVal(w.reshape(m.data.shape).astype(m.data.dtype)))
            return None
        if name == "printTensor":
            v = self.eval_expr(e.args[0], fr, loop)
            self.emit(" ".join(
                _fmt(float(x), self._cout_precision)
                for x in np.asarray(v.data).ravel()))
            return None
        if name == "getElement":
            m = self.eval_expr(e.args[0], fr, loop)
            i = int(self.eval_expr(e.args[1], fr, loop))
            j = int(self.eval_expr(e.args[2], fr, loop))
            return m.data[..., i, j]
        if name == "setElement":
            self._mutate_matrix_var(
                e.args[0], fr, loop,
                lambda m: MatVal(m.data.at[
                    ..., int(self.eval_expr(e.args[1], fr, loop)),
                    int(self.eval_expr(e.args[2], fr, loop))
                ].set(self.eval_expr(e.args[3], fr, loop))))
            return None
        if name == "getSlice":
            args = [self.eval_expr(a, fr, loop) for a in e.args]
            return MV.get_slice(*args)
        if name == "setSlice":
            vals = [self.eval_expr(a, fr, loop) for a in e.args[1:]]
            self._mutate_matrix_var(
                e.args[0], fr, loop, lambda m: MV.set_slice(m, *vals))
            return None
        if name == "toMatrix":
            return self.eval_expr(e.args[0], fr, loop)
        if name == "compare":
            return self._builtin_compare(e, fr, loop)
        if name == "classifyMatShape":
            # compile-time matrix structure classifier (reference
            # IR_ClassifyMatShape.isSchurOrBlockdiag, printed via
            # IR_ResolveMatrices.scala:303-305)
            m = self.eval_expr(e.args[0], fr, loop)
            M = np.asarray(m.data) != 0
            self.emit("".join(_classify_mat_shape(M)))
            return None
        if name == "evalMOpRuntimeExe":
            # compiletime-vs-runtime execution report (reference
            # IR_EvalMOpRuntimeExe.scala:9-27; printed without newline)
            is_const = isinstance(e.args[0], N.MatrixLit) and all(
                isinstance(x, N.Num)
                or (isinstance(x, N.UnOp) and isinstance(x.operand, N.Num))
                for row in e.args[0].rows for x in row
            )
            m = self.eval_expr(e.args[0], fr, loop)
            if not self.k.experimental_evalMOpRuntimeExe:
                word = self.k.experimental_resolveLocalMatSys
            elif is_const:
                word = "Compiletime"
            else:
                word = "Compiletime" if m.rows <= self.k.experimental_MOpRTExeThreshold else "Runtime"
            self.emit(word, newline=False)
            return None
        # ---- complex builtins (reference ComplexNumbers/) ----
        if name in ("Re", "re", "real"):
            v = self.eval_expr(e.args[0], fr, loop)
            return jnp.real(v) if hasattr(v, "dtype") else complex(v).real
        if name in ("Im", "im", "imag"):
            v = self.eval_expr(e.args[0], fr, loop)
            return jnp.imag(v) if hasattr(v, "dtype") else complex(v).imag
        if name == "conj":
            return jnp.conj(self.eval_expr(e.args[0], fr, loop))
        if name == "arg":
            return jnp.angle(self.eval_expr(e.args[0], fr, loop))
        if name == "polar":
            r = self.eval_expr(e.args[0], fr, loop)
            th = self.eval_expr(e.args[1], fr, loop)
            return r * jnp.exp(1j * jnp.asarray(th))
        if name == "notEqual":
            # reference IR_ComplexNumberNotEqual: |d(re)| > 1e-12 or
            # |d(im)| > 1e-13 (IR_ComplexNumberAccess.scala:54)
            a = self.eval_expr(e.args[0], fr, loop)
            b = self.eval_expr(e.args[1], fr, loop)
            return jnp.logical_or(
                jnp.abs(jnp.real(a) - jnp.real(b)) > 1e-12,
                jnp.abs(jnp.imag(a) - jnp.imag(b)) > 1e-13,
            )
        if name == "getKnowledge":
            return self._get_knowledge(e.args)
        if name == "levels":
            return self._resolve_level(e.level, fr)
        if name == "print":
            vals = [self.eval_expr(a, fr, loop) for a in e.args]
            self.emit(" ".join(_fmt(v, self._cout_precision) for v in vals))
            return None
        if name == "buildString":
            # buildString(dest, parts...) concatenates into the string
            # variable (reference util/ir IR_BuildString)
            parts = [self.eval_expr(a, fr, loop) for a in e.args[1:]]
            dest = e.args[0].name
            txt = "".join(str(p) for p in parts)
            (fr.vars if dest in fr.vars else self.globals)[dest] = txt
            return None
        if name in ("printVtkNS", "printVtkNNF", "printVtkSWE"):
            # multi-field VTK dump of the application's primary fields
            # (visualization/ir/postprocessing IR_PrintVtkNS etc.): one
            # file per localization group, suffixed by field name
            from exastencils_jax.runtime.vtk import print_vtk

            path = str(self.eval_expr(e.args[0], fr, loop))
            lvl = int(self.eval_expr(e.args[1], fr, loop))
            for fname in ("u", "v", "w", "p"):
                if fname in self.fields and lvl in self.fields[fname].levels:
                    print_vtk(f"{path}.{fname}.vtk",
                              {fname: self.get_field(fname, lvl)},
                              self.grids[lvl], self.fields[fname].localization)
            return None
        if name in ("showMappedImage", "showMappedImageAndWaitWhen",
                    "writeMappedImage", "readImage"):
            return None  # CImg interactive visualization: no analog here
        if name == "berndist":
            # `berndist(gen_berndist)` (sumAlgos input generation): the
            # program declares std::bernoulli_distribution(0.25) via
            # native(); C++ RNG state cannot be reproduced, so a seeded
            # host RNG supplies the draw (output is self-checked, not
            # golden-diffed)
            shape = tuple(loop.shape) if loop is not None else ()
            return jnp.asarray(self._host_rng.random(shape) < 0.25)
        if name == "native":
            # emulate the generated std::cout stream-precision calls the
            # reference's old-style reduced-precision printing relies on
            # (util/ir/IR_ResolvePrintWithReducedPrec pre-refactor form)
            code = str(e.args[0].value) if e.args else ""
            if "std::rand()" in code:
                # `((double)std::rand()/RAND_MAX)` random field init
                # (Testing/Opts InitSolution): reproduce glibc's TYPE_3
                # additive-feedback rand() EXACTLY (seed 1, never
                # re-seeded) so the committed .results match digit for
                # digit.  The generated C++ loop nest iterates x
                # innermost; numpy boolean fill is last-axis-fastest, so
                # fill the [z,y,x]-transposed view.
                if loop is None:
                    return jnp.asarray(
                        next(self._glibc_rand) / 2147483647.0, self.dtype)
                mask = loop.mask
                shape = tuple(loop.shape)
                mT = (np.ones(shape[::-1], bool) if mask is None
                      else np.asarray(mask).T)
                n_draw = int(mT.sum())
                draws = np.fromiter(
                    (next(self._glibc_rand) for _ in range(n_draw)),
                    dtype=np.float64, count=n_draw) / 2147483647.0
                arrT = np.zeros(shape[::-1])
                arrT[mT] = draws
                return jnp.asarray(arrT.T, self.dtype)
            if "realdist(" in code:
                shape = tuple(loop.shape) if loop is not None else ()
                return jnp.asarray(self._host_rng.random(shape), self.dtype)
            if "setprecision" in code:
                # std::cout << setprecision(digits10+1) — long-double print
                self._cout_precision = 19
                return None
            if "= std::cout.precision()" in code:
                self._cout_saved = self._cout_precision
            elif "std::cout.precision(oldPrec)" in code:
                self._cout_precision = self._cout_saved
            elif "std::cout.precision(" in code:
                import re as _re

                m = _re.search(r"std::cout\.precision\((\d+)\)", code)
                if m:
                    self._cout_precision = int(m.group(1))
            return None
        if name == "printWithReducedPrec":
            v = float(self.eval_expr(e.args[0], fr, loop))
            self.emit(reduced_prec_str(v, self.k.testing_maxPrecision, self.k.testing_zeroThreshold))
            return None
        if name in ("startTimer", "benchmarkStart"):
            # benchmarkStart/Stop: the reference's likwid/talp marker
            # builtins (benchmark_backend, IR_CollectUnresolvedBenchmark-
            # Functions) — here they are named timers, visible via
            # printAllTimers and jax.profiler annotations
            self.timers.start(str(self.eval_expr(e.args[0], fr, loop)))
            return None
        if name in ("stopTimer", "benchmarkStop"):
            self.timers.stop(str(self.eval_expr(e.args[0], fr, loop)))
            return None
        if name in ("printAllTimers",):
            self.timers.print_all(self.out)
            return None
        if name in ("printAllTimersToFile",):
            return None
        if name == "printJSON":
            # printJSON("file", "key", expr, "key", expr, ...) — the
            # reference's benchmark-JSON writer consumed by its Grafana
            # uploader (util/ir/IR_ResolveJSONFunctions.scala:24-37)
            import json as _json

            path = str(self.eval_expr(e.args[0], fr, loop))
            obj = {}
            for i in range(1, len(e.args) - 1, 2):
                key_e = e.args[i]
                key = (key_e.value if isinstance(key_e, N.Str)
                       else getattr(key_e, "name", None)
                       or str(self.eval_expr(key_e, fr, loop)))
                val = self.eval_expr(e.args[i + 1], fr, loop)
                try:
                    val = float(val)
                except (TypeError, ValueError):
                    val = str(val)
                obj[str(key)] = val
            with open(path, "w") as f:
                _json.dump(obj, f, indent=1)
            return None
        if name in ("getTotalTime", "getTotalFromTimer"):
            return self.timers.get_total_time(str(self.eval_expr(e.args[0], fr, loop)))
        if name in ("getMeanTime", "getMeanFromTimer"):
            return self.timers.get_mean_time(str(self.eval_expr(e.args[0], fr, loop)))
        if name == "initFieldsWithZero":
            # reference: the zero-init loop is only generated under
            # data_initAllFieldsWithZero (IR_InitFieldsWithZero); state
            # allocation already zeroes, so this re-zeroing is elidable
            if self.k.data_initAllFieldsWithZero:
                self.init_fields_with_zero()
            return None
        if name == "initGlobals":
            self.init_globals()
            return None
        if name in (
            "initDomain", "initGeometry", "destroyGlobals", "initFragments",
        ):
            return None
        if name == "writeField":
            from exastencils_jax.runtime.fieldio import write_field

            path = str(self.eval_expr(e.args[0], fr, loop))
            acc = e.args[1]
            with self.timers.auto_scope("IO"):
                write_field(
                    path,
                    self.get_field(acc.name, self._resolve_level(acc.level, fr)))
            return None
        if name == "readField":
            from exastencils_jax.runtime.fieldio import read_field

            path = str(self.eval_expr(e.args[0], fr, loop))
            acc = e.args[1]
            lvl = self._resolve_level(acc.level, fr)
            cur = self.get_field(acc.name, lvl)
            with self.timers.auto_scope("IO"):
                self.set_field(acc.name, lvl, read_field(path, like=cur))
            return None
        if name.startswith(("writeField_", "readField_", "printField_")):
            with self.timers.auto_scope("IO"):
                return self._eval_io_backend_call(name, e, fr, loop)
        if name == "exit":
            code = int(self.eval_expr(e.args[0], fr, loop)) if e.args else 0
            raise _Exit(code)
        if name == "buildString":
            # buildString(target, parts...) — concatenate into the string
            # variable (reference util/ir string building; SWE filenames)
            target = e.args[0]
            parts = []
            for a in e.args[1:]:
                v = self.eval_expr(a, fr, loop)
                if isinstance(v, float) and v == int(v):
                    v = int(v)
                parts.append(str(v))
            env = fr.vars if target.name in fr.vars else self.globals
            env[target.name] = "".join(parts)
            return None
        if name == "levels":
            return self._resolve_level(e.level, fr)
        if name == "printField":
            from exastencils_jax.runtime.fieldio import print_field

            path = str(self.eval_expr(e.args[0], fr, loop))
            acc = e.args[1]
            with self.timers.auto_scope("IO"):
                print_field(
                    path,
                    self.get_field(acc.name, self._resolve_level(acc.level, fr)))
            return None
        if name == "printVtk":
            from exastencils_jax.runtime.vtk import print_vtk

            path = str(self.eval_expr(e.args[0], fr, loop))
            acc = e.args[1]
            lvl = self._resolve_level(acc.level, fr)
            print_vtk(path, {acc.name: self.get_field(acc.name, lvl)}, self.grids[lvl],
                      self.fields[acc.name].localization)
            return None
        # user function
        lvl = self._resolve_level(e.level, fr) if e.level is not None else fr.level
        fkey = (name, lvl) if (name, lvl) in self.functions else (name, None)
        if fkey in self.functions:
            args = [self.eval_expr(a, fr, loop) for a in e.args]
            return self.call_function(self.functions[fkey], lvl, args)
        raise ValueError(f"unknown function {name!r}")

    def _eval_io_backend_call(self, name: str, e: N.Call, fr: Frame, loop):
        """Per-backend field IO builtins (Testing/IOTest surface):
        writeField_lock/_fpp/_hdf5/_mpiio/_nc/_sion and the matching
        readField_* (runtime/fieldio backend functions)."""
        from exastencils_jax.runtime import fieldio as FIO

        op, backend = name.split("_", 1)
        path = str(self.eval_expr(e.args[0], fr, loop))
        # hdf5/nc carry (path, dataset/var, field, ...) in the IOTest
        # form, but the printField visualization form passes the field
        # directly: (path, field, useCanonicalLayout)
        # (Examples/IO/2D_PrintField_NonUniform_AA.exa4:134-164)
        if backend in ("hdf5", "nc") and not isinstance(e.args[1], N.Access):
            dataset = str(self.eval_expr(e.args[1], fr, loop))
            acc = e.args[2]
            extra = (dataset,)
        elif backend in ("hdf5", "nc") and isinstance(e.args[1], N.Access) \
                and e.args[1].name not in self.fields:
            dataset = str(self.eval_expr(e.args[1], fr, loop))
            acc = e.args[2]
            extra = (dataset,)
        elif backend in ("hdf5", "nc"):
            acc = e.args[1]
            extra = ("field",)  # default dataset name
        else:
            acc = e.args[1]
            extra = ()
        lvl = self._resolve_level(acc.level, fr)
        arr = self.get_field(acc.name, lvl)
        if op == "printField" and backend == "lock":
            # ascii visualization output carries positions + value
            # (reference printField; the non-uniform IO examples check
            # exactly this), binary stays raw values
            from exastencils_jax.runtime.fieldio import print_field_lock

            binary = (bool(self.eval_expr(e.args[3], fr, loop))
                      if len(e.args) > 3 else False)
            sep = (str(self.eval_expr(e.args[5], fr, loop))
                   if len(e.args) > 5 else ",")
            coords = self.grids[lvl].coord_mesh(
                self.fields[acc.name].localization)
            print_field_lock(path, arr, coords=coords, binary=binary,
                             sep=sep)
            return None
        if op == "printField":
            # visualization output of the same backend family: reuse the
            # write path (xdmf companions are runtime/vtk's job)
            op = "writeField"
        if op == "writeField":
            fn = getattr(FIO, f"write_field_{backend}")
            if backend == "lock":
                # (path, field, useGhost, useBinary, condition, separator)
                # — io/ir/IR_FileAccess_Locking.scala:19 `useBinary`
                binary = (bool(self.eval_expr(e.args[3], fr, loop))
                          if len(e.args) > 3 else False)
                if len(e.args) > 4:
                    # a per-point condition selects the written subset in
                    # the reference (io/ir/IR_AccessPattern.scala); we
                    # refuse non-trivial conditions rather than silently
                    # writing every point (advisor r4)
                    cond = self.eval_expr(e.args[4], fr, loop)
                    if getattr(cond, "shape", ()) or not bool(cond):
                        raise NotImplementedError(
                            "writeField with a non-trivial condition "
                            "argument is not supported"
                        )
                sep = (str(self.eval_expr(e.args[5], fr, loop))
                       if len(e.args) > 5 else ",")
                fn(path, arr, binary=binary, sep=sep)
            elif backend == "fpp":
                binary = (bool(self.eval_expr(e.args[3], fr, loop))
                          if len(e.args) > 3 else True)
                fn(path, arr, binary=binary)
            else:
                fn(path, *extra, arr)
            return None
        fn = getattr(FIO, f"read_field_{backend}")
        if backend == "lock":
            binary = (bool(self.eval_expr(e.args[3], fr, loop))
                      if len(e.args) > 3 else False)
            sep = (str(self.eval_expr(e.args[5], fr, loop))
                   if len(e.args) > 5 else ",")
            new = fn(path, arr, binary=binary, sep=sep)
        elif backend == "fpp":
            binary = (bool(self.eval_expr(e.args[3], fr, loop))
                      if len(e.args) > 3 else True)
            new = fn(path, arr, binary=binary)
        else:
            new = fn(path, *extra, arr)
        self.set_field(acc.name, lvl, new)
        return None

    def _mutate_matrix_var(self, target, fr: Frame, loop, fn):
        """In-place matrix mutation builtins (setElement/setSlice) write
        back through the variable/global/field the access names."""
        if not isinstance(target, N.Access):
            raise ValueError("matrix mutation target must be a named access")
        name = target.name
        if name in fr.vars:
            fr.vars[name] = fn(fr.vars[name])
            return
        if name in self.globals:
            self.globals[name] = fn(self.globals[name])
            return
        if name in self.fields:
            lvl = self._resolve_level(target.level, fr)
            arr = self.get_field(name, lvl, target.slot)
            self.set_field(name, lvl, fn(MatVal(arr)).data, target.slot)
            return
        raise ValueError(f"unknown matrix variable {name!r}")

    def _builtin_compare(self, e: N.Call, fr: Frame, loop):
        """`compare(a, b, prec[, abortOnMismatch])` (reference
        IR_GenerateBasicMatrixOperations compare): silent on match,
        prints a diagnostic line on mismatch — golden suites rely on the
        silence of passing stages."""
        a = self.eval_expr(e.args[0], fr, loop)
        b = self.eval_expr(e.args[1], fr, loop)
        prec = float(self.eval_expr(e.args[2], fr, loop)) if len(e.args) > 2 else 1e-6
        da = a.data if is_mat(a) else jnp.asarray(a)
        db = b.data if is_mat(b) else jnp.asarray(b)
        # jnp broadcasting covers 1x1-vs-scalar and grid-batched-vs-
        # constant comparisons
        adiff = jnp.abs(da - db)
        if loop is not None and loop.mask is not None and adiff.ndim >= len(loop.shape):
            # compare() inside a masked loop is a per-point statement:
            # only loop-visited points participate (the reference's
            # compare expands inside the loop nest)
            e_nd = adiff.ndim - len(loop.shape)
            m = loop.mask[(...,) + (None,) * e_nd] if e_nd else loop.mask
            adiff = jnp.where(m, adiff, 0.0)
        diff = jnp.max(adiff)
        if bool(diff > prec):
            self.emit(
                f"compare: mismatch (max |a-b| = {float(diff):.6g} > {prec:g})"
            )
        # tensor compare is also usable as a boolean expression
        # (`if (compare(t1, t2)) ...`, IR_TensorOperations compareTwoTensor*)
        return bool(diff <= prec)

