"""Shared base pieces of the L4 interpreter (split from the former
4k-line interpreter.py god class, VERDICT r4/r5 item: frames, loop
contexts, field-info records, control-flow exceptions, scalar helpers,
and the arithmetic appliers used across the interpreter mixins)."""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from exastencils_jax.core.field import DirichletBC, NeumannBC
from exastencils_jax.core.grid import CELL, FACES, NODE
from exastencils_jax.core import matval as MV
from exastencils_jax.core.matval import MatVal, is_mat
from exastencils_jax.core.stencil import BoundStencil, IntergridStencil
from exastencils_jax.dsl import nodes as N

_LOC_MAP = {
    "Node": NODE, "node": NODE, "Cell": CELL, "cell": CELL,
    "Face_x": FACES[0], "Face_y": FACES[1], "Face_z": FACES[2],
}

_MATH_FNS = {
    "sqrt": jnp.sqrt, "fabs": jnp.abs, "abs": jnp.abs, "sin": jnp.sin,
    "cos": jnp.cos, "tan": jnp.tan, "sinh": jnp.sinh, "cosh": jnp.cosh,
    "exp": jnp.exp, "ln": jnp.log, "log": jnp.log, "floor": jnp.floor,
    "ceil": jnp.ceil, "atan": jnp.arctan, "asin": jnp.arcsin, "acos": jnp.arccos,
}


def _dtype_info(dt: Optional[str]):
    """Interpret a canonical datatype string (dsl/parser.parse_datatype):
    returns (elem_shape, is_complex) — elem_shape () for scalars,
    (r, c) for the Matrix/Vector family (reference datatypes,
    L4_Parser.scala:175-205)."""
    if not dt:
        return (), False
    dt = dt.replace(" ", "")
    if "<" not in dt:
        m = re.fullmatch(r"Vec(\d+)", dt)  # Vec2/Vec3 shorthands
        if m:
            return (int(m.group(1)), 1), False
        return (), dt == "Complex"
    base, params = dt.split("<", 1)
    params = params.rstrip(">")
    is_c = params.startswith("Complex") or base == "Complex"
    # split ints off the tail
    ints = [p for p in params.split(",") if p.lstrip("-").isdigit()]
    if base == "Matrix":
        return (int(ints[-2]), int(ints[-1])), is_c
    if base in ("ColumnVector", "Vector", "Tensor1"):
        return (int(ints[-1]) if ints else 3, 1), is_c
    if base == "RowVector":
        return (1, int(ints[-1])), is_c
    if base == "Tensor2":
        n = int(ints[-1]) if ints else 3  # Tensor2<Real> defaults to dim 3
        return (n, n), is_c
    if base == "TensorN":
        # TensorN<T, dim, order> (reference IR_TensorDatatypeN); order-1
        # tensors share the column-vector layout so compare(tensN, tens1)
        # and compare(tensN-order-2, tens2) hold structurally
        d, o = int(ints[-2]), int(ints[-1])
        return ((d, 1) if o == 1 else (d,) * o), is_c
    if base == "Complex":
        return (), True
    return (), is_c


def _compensated_sum(vals, algo: str):
    """Kahan / Neumaier compensated summation via lax.scan (reference
    solver/l3 dot(..., "kahan"|"neumaier") summation-algorithm option,
    Testing/ComplexNumbers/sumAlgos).  Plain `jnp.sum` is pairwise and
    usually MORE accurate; these reproduce the sequential compensated
    semantics for API parity."""
    zero = jnp.zeros((), vals.dtype)

    if algo == "kahan":
        def step(carry, x):
            s, c = carry
            y = x - c
            t = s + y
            return (t, (t - s) - y), None
    elif algo == "neumaier":
        def step(carry, x):
            s, c = carry
            t = s + x
            big = jnp.abs(s) >= jnp.abs(x)
            return (t, c + jnp.where(big, (s - t) + x, (x - t) + s)), None
    else:
        return jnp.sum(vals)
    (s, c), _ = lax.scan(step, (zero, zero), vals)
    return s if algo == "kahan" else s + c


def _glibc_rand_stream(seed: int = 1):
    """glibc's default random() / rand(): the TYPE_3 additive-feedback
    generator (r[i] = r[i-3] + r[i-31] mod 2^32, output >> 1) seeded by
    the LCG warm-up, exactly as initstate_r does.  Needed to reproduce
    the reference's `native("((double)std::rand()/RAND_MAX)")` field
    initialization digit-for-digit (Testing/Opts)."""
    r = [seed]
    for i in range(1, 31):
        # r[i] = (16807 * r[i-1]) % 2147483647 using the signed-overflow-
        # free formulation glibc documents
        hi, lo = divmod(r[i - 1], 127773)
        word = 16807 * lo - 2836 * hi
        if word < 0:
            word += 2147483647
        r.append(word)
    for i in range(31, 34):
        r.append(r[i - 31])
    i = 34
    while True:
        v = (r[i - 3] + r[i - 31]) & 0xFFFFFFFF
        r.append(v)
        if i >= 344:  # glibc discards the first 310 outputs
            yield v >> 1
        i += 1


class _FunctionBC:
    """Field boundary handled by a user L4 function (reference
    field decl `Field x< dom, layout, fnName() >`; `apply bc` calls it)."""

    def __init__(self, fn_name: str, level_spec):
        self.fn_name = fn_name
        self.level_spec = level_spec


class _Return(Exception):
    def __init__(self, value):
        self.value = value


class _Break(Exception):
    pass


class _Exit(Exception):
    """DSL `exit(code)` — terminates Application (generated std::exit)."""

    def __init__(self, code: int):
        self.code = code


@dataclass
class _FieldInfo:
    name: str
    localization: str
    levels: List[int]
    bc_by_level: Dict[int, object] = dc_field(default_factory=dict)  # BC instances
    num_slots: int = 1
    ghost: int = 1
    elem_shape: Tuple[int, ...] = ()  # (r, c) for Matrix/Vector-valued fields
    is_complex: bool = False
    dup_layers: Optional[Tuple[int, ...]] = None  # None = default (1 per dim)


@dataclass
class Frame:
    vars: Dict[str, object]
    level: Optional[int]


@dataclass
class _LoopCtx:
    level: int
    localization: str
    shape: Tuple[int, ...]
    mask: Optional[jnp.ndarray] = None  # color/condition mask
    reduction: Optional[Tuple[str, str]] = None



def _classify_mat_shape(M) -> List[str]:
    """Port of the reference's compile-time structure analysis
    (baseExt/ir/IR_ClassifyMatShape.scala:174-300 isSchurOrBlockdiag):
    detects diagonal / blockdiagonal(block) / schur(block, A, Ablock)
    forms from the nonzero pattern M (2D bool array)."""
    size = M.shape[0]
    if size == 1 or M.shape[1] == 1:
        return ["shape=filled"]
    # blocksize of the leading (block)diagonal A
    bA = 1
    while bA < size:
        if not any(M[i, bA] or M[bA, i] for i in range(bA)):
            break
        bA += 1
    # blocksize of the trailing Schur block D
    bD = 0
    while bD < size:
        if not any(
            M[i, size - bD - 1] or M[size - bD - 1, i]
            for i in range(size - bD - bA)
        ):
            break
        bD += 1
    if bD == size:
        return ["shape=filled"]
    if bA >= (size - bD) // 2 + 1:
        return ["shape=filled"]
    border = size - bD
    for i in range(border):
        start = (i // bA) * bA + bA
        for j in range(start, border):
            if M[i, j] or M[j, i]:
                return ["shape=filled"]
    if bD == 0:
        if bA == 1:
            return ["shape=diagonal"]
        if bA == size:
            return ["shape=filled"]
        return ["shape=blockdiagonal", f"block={bA}"]
    if bA == 1:
        return ["shape=schur", f"block={size - bD}", "A=diagonal"]
    if bA == size:
        return ["shape=filled"]
    return ["shape=schur", f"block={size - bD}", "A=blockdiagonal", f"Ablock={bA}"]


def _is_stencil(v) -> bool:
    return isinstance(v, tuple) and len(v) == 3 and v[0] == "__stencil__"


def _scale_stencil(st, s):
    """Scalar * stencil (reference IR_StencilOps.scale)."""
    if isinstance(st, BoundStencil):
        return BoundStencil(st.name, st.offsets, tuple(c * s for c in st.coefs))
    if isinstance(st, IntergridStencil):
        kernels = None
        if st.kernels_1d is not None:
            kernels = (tuple(v * s for v in st.kernels_1d[0]),) + tuple(
                st.kernels_1d[1:]
            )
        return IntergridStencil(st.kind, st.weights * s, st.lo, kernels)
    raise TypeError(f"cannot scale {st!r}")


def _apply_binop(op, a, b):
    if is_mat(a) or is_mat(b):
        return MV.mat_binop(op, a, b)
    # elementwise-operator spellings degenerate to scalar ops off-matrix
    op = {".*": "*", "./": "/", ".^": "**", ".%": "**"}.get(op, op)
    if op == "+":
        return a + b
    if op == "-":
        return a - b
    if op == "*":
        return a * b
    if op == "/":
        return a / b
    if op == "%":
        return a % b
    if op == "**":
        return a ** b
    if op == "==":
        return a == b
    if op == "!=":
        return a != b
    if op == "<":
        return a < b
    if op == "<=":
        return a <= b
    if op == ">":
        return a > b
    if op == ">=":
        return a >= b
    if op == "&&":
        return jnp.logical_and(a, b) if hasattr(a, "shape") or hasattr(b, "shape") else (a and b)
    if op == "||":
        return jnp.logical_or(a, b) if hasattr(a, "shape") or hasattr(b, "shape") else (a or b)
    raise ValueError(f"unknown operator {op}")


def _apply_assign(op, cur, val):
    if op == "=":
        return val if not hasattr(cur, "shape") else jnp.broadcast_to(
            jnp.asarray(val, cur.dtype), cur.shape
        )
    if op == "+=":
        return cur + val
    if op == "-=":
        return cur - val
    if op == "*=":
        return cur * val
    if op == "/=":
        return cur / val
    raise ValueError(f"unknown assign op {op}")


def _shift(arr, offset):
    """Field access with constant offset: zero-padded shifted view.
    Only the leading len(offset) dims shift (trailing matrix-element
    dims pass through)."""
    r = max(abs(o) for o in offset)
    if r == 0:
        return arr
    extra = arr.ndim - len(offset)
    pads = ((r, r),) * len(offset) + ((0, 0),) * extra
    xp = jnp.pad(arr, pads)
    sl = tuple(slice(r + o, r + o + n) for o, n in zip(offset, arr.shape))
    return xp[sl]


def _fmt(v, precision: int = 6) -> str:
    """C++ `std::cout <<` default formatting at the current stream
    precision (%.Ng general form; std::complex prints `(re,im)`)."""
    if isinstance(v, str):
        return v
    if is_mat(v):
        flat = np.asarray(v.data).reshape(-1)
        return "[" + " ".join(_fmt(x, precision) for x in flat) + "]"
    if isinstance(v, complex) or (hasattr(v, "dtype") and np.iscomplexobj(v)):
        c = complex(v)
        return "(%s,%s)" % (
            "%.*g" % (precision, c.real), "%.*g" % (precision, c.imag)
        )
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    if isinstance(v, (bool, np.bool_)):
        return "1" if v else "0"
    f = float(v)
    return "%.*g" % (precision, f)
