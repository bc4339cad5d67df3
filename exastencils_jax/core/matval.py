"""Matrix/vector values for the ExaSlang Matrix<T,r,c> datatype family.

Reference: baseExt/ir/IR_MatrixExpression.scala:1-102 (fixed-size matrix
expressions), IR_MatOperations/IR_CompiletimeMatOps.scala (compile-time
add/mul/inverse/determinant/slicing), IR_RuntimeMatOps.scala (runtime LU
paths), IR_MatNodes/ (getElement/setElement/getSlice/setSlice/inverse/
det/trace/transpose/dot/cross/norm builtins).

JAX representation: a MatVal wraps one jnp array of shape
batch_shape + (rows, cols).  A plain Var is batch_shape = (); a
matrix-valued *field* carries the grid as batch dims, so every matrix
operation (including matmul and batched inverse/solve) is a single XLA
op over the whole grid — the batched rendering of the reference's
per-point unrolled matrix code.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
from jax import lax


@jax.tree_util.register_pytree_node_class
@dataclass
class MatVal:
    """data: jnp array, shape = batch + (rows, cols)."""

    data: jnp.ndarray

    def tree_flatten(self):
        return (self.data,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0])

    @property
    def rows(self) -> int:
        return self.data.shape[-2]

    @property
    def cols(self) -> int:
        return self.data.shape[-1]

    @property
    def batch(self):
        return self.data.shape[:-2]

    def map(self, fn) -> "MatVal":
        return MatVal(fn(self.data))

    # scalar scaling / elementwise sum (matrix-valued stencil
    # coefficients under stencil algebra, e.g.
    # `(alpha**2) * Laplace + gradContribution`)
    def __mul__(self, other):
        if isinstance(other, MatVal):
            return NotImplemented
        return MatVal(self.data * other)

    __rmul__ = __mul__

    def __add__(self, other):
        if isinstance(other, MatVal):
            return MatVal(self.data + other.data)
        return MatVal(self.data + other)

    __radd__ = __add__

    def __neg__(self):
        return MatVal(-self.data)

    def __repr__(self):
        return f"MatVal{self.data.shape}"


def is_mat(v) -> bool:
    return isinstance(v, MatVal)


def _lift(other, batch_ndim_hint=0):
    """Broadcast a non-matrix operand against MatVal data: scalars pass
    through; grid-shaped arrays (scalar fields) gain trailing element
    dims so they scale every matrix entry at their grid point."""
    if hasattr(other, "shape") and getattr(other, "shape", ()) != ():
        return other[..., None, None]
    return other


def mat_binop(op: str, a, b):
    """Elementwise/matmul semantics of the reference's matrix operators
    (IR_CompiletimeMatOps): `*` between two matrices is the matrix
    product; `+ - .* ./ .^` are elementwise; scalars broadcast."""
    if is_mat(a) and is_mat(b):
        x, y = a.data, b.data
        if op == "*":
            if a.rows == 1 and a.cols == 1:
                return MatVal(x[..., 0:1, 0:1] * y)
            if b.rows == 1 and b.cols == 1:
                return MatVal(x * y[..., 0:1, 0:1])
            return MatVal(jnp.matmul(x, y, precision=lax.Precision.HIGHEST))
        if op in ("+", ".+"):
            return MatVal(x + y)
        if op in ("-", ".-"):
            return MatVal(x - y)
        if op == ".*":
            return MatVal(x * y)
        if op == "./":
            return MatVal(x / y)
        if op in (".^", "**"):
            return MatVal(x ** y)
        raise ValueError(f"unsupported matrix-matrix operator {op!r}")
    if is_mat(a):
        s = _lift(b)
        if op in ("+", ".+"):
            return MatVal(a.data + s)
        if op in ("-", ".-"):
            return MatVal(a.data - s)
        if op in ("*", ".*"):
            return MatVal(a.data * s)
        if op in ("/", "./"):
            return MatVal(a.data / s)
        if op in ("**", ".^"):
            return MatVal(a.data ** s)
        raise ValueError(f"unsupported matrix-scalar operator {op!r}")
    if is_mat(b):
        s = _lift(a)
        if op in ("+", ".+"):
            return MatVal(s + b.data)
        if op in ("-", ".-"):
            return MatVal(s - b.data)
        if op in ("*", ".*"):
            return MatVal(s * b.data)
        if op in ("/", "./"):
            return MatVal(s / b.data)
        raise ValueError(f"unsupported scalar-matrix operator {op!r}")
    raise TypeError("mat_binop requires a MatVal operand")


# ---------------------------------------------------------------- builtins
# (reference IR_MatNodes/*.scala)


def transpose(m: MatVal) -> MatVal:
    return MatVal(jnp.swapaxes(m.data, -1, -2))


def trace(m: MatVal):
    return jnp.trace(m.data, axis1=-2, axis2=-1)


def determinant(m: MatVal):
    """det via LU (jnp.linalg.det) — the reference uses direct expansion
    up to 3x3, Laplace to 5x5, runtime LU beyond
    (IR_CompiletimeMatOps.scala det paths); one fused kernel here."""
    return jnp.linalg.det(m.data)


def inverse(m: MatVal) -> MatVal:
    """Batched dense inverse (IR_MatNodes/IR_Inverse.scala; runtime path
    IR_RuntimeMatOps LU) — batched over grid dims."""
    return MatVal(jnp.linalg.inv(m.data))


def frobenius_norm(m: MatVal):
    return jnp.sqrt(
        jnp.sum(jnp.abs(m.data) ** 2, axis=(-2, -1))
    )


def dot_product(a: MatVal, b: MatVal) -> MatVal:
    """Sum of elementwise products, as a 1x1 matrix (reference
    IR_MatNodes dotProduct: vectors or equal-shaped matrices)."""
    x, y = a.data, b.data
    if a.rows != b.rows or a.cols != b.cols:
        y = jnp.swapaxes(y, -1, -2)
    s = jnp.sum(x * y, axis=(-2, -1))
    return MatVal(s[..., None, None])


def cross(a: MatVal, b: MatVal) -> MatVal:
    """3-vector cross product (IR_MatNodes/IR_CrossProduct)."""
    x = a.data[..., :, 0] if a.cols == 1 else a.data[..., 0, :]
    y = b.data[..., :, 0] if b.cols == 1 else b.data[..., 0, :]
    c = jnp.cross(x, y)
    return MatVal(c[..., :, None])


def get_slice(m: MatVal, off_r, off_c, n_r, n_c) -> MatVal:
    import jax.lax as lax

    data = m.data
    # dynamic offsets supported via dynamic_slice over the last two dims
    if any(hasattr(v, "shape") for v in (off_r, off_c)):
        starts = [0] * (data.ndim - 2) + [off_r, off_c]
        sizes = list(data.shape[:-2]) + [int(n_r), int(n_c)]
        return MatVal(lax.dynamic_slice(data, starts, sizes))
    return MatVal(
        data[..., int(off_r):int(off_r) + int(n_r), int(off_c):int(off_c) + int(n_c)]
    )


def set_slice(m: MatVal, off_r, off_c, n_r, n_c, value) -> MatVal:
    sl = (..., slice(int(off_r), int(off_r) + int(n_r)),
          slice(int(off_c), int(off_c) + int(n_c)))
    v = value.data if is_mat(value) else value
    return MatVal(m.data.at[sl].set(jnp.broadcast_to(v, m.data[sl].shape)))
