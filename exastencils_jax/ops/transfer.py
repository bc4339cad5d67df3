"""Inter-grid transfers as banded-matrix contractions.

The reference emits strided gather/scatter loop nests for restriction /
prolongation (mapping stencils, stencil/ir/IR_StencilConvolution.scala;
see NodeRestriction in 2D_FD_Poisson_fromL4.exa4).  A *separable* 2:1
transfer can instead be written as one small banded matrix per dimension
applied as a dense contraction, which reads the data contiguously:

    coarse = R_x . R_y . R_z . fine      (tensordot per dim)
    fine   = P_x . P_y . P_z . coarse    (P = R^T pattern)

Matrices are built once per level pair (banded, 3 nonzeros per row) and
constant-folded into the jitted cycle.  Works identically on the dense
global representation (ghost = 0) and on fragment-local padded arrays
(ghost = g, zero rows for ghost outputs — neighbors provide them via
halo exchange), which is why the sharded backend uses this form.

Every contraction runs at `lax.Precision.HIGHEST`: an f32 matmul at the
default precision may run in TF32 on GPUs (10-bit mantissa), which costs
multigrid digits.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import jax.numpy as jnp
from jax import lax

from exastencils_jax.core.stencil import IntergridStencil


def restriction_matrix_1d(
    kernel: Sequence[float],
    lo: int,
    nodes_out: int,
    total_in: int,
    total_out: int,
    ghost_in: int = 0,
    ghost_out: int = 0,
) -> np.ndarray:
    """M[i_out, j_in]: coarse node i (array row ghost_out+i) takes
    kernel[k] from fine array column ghost_in + 2*i + lo + k.  Columns
    outside [0, total_in) are dropped (zero-ghost semantics)."""
    M = np.zeros((total_out, total_in))
    for i in range(nodes_out):
        for k, w in enumerate(kernel):
            j = ghost_in + 2 * i + lo + k
            if 0 <= j < total_in:
                M[ghost_out + i, j] += w
    return M


def prolongation_matrix_1d(
    kernel: Sequence[float],
    lo: int,
    nodes_out: int,
    total_in: int,
    total_out: int,
    ghost_in: int = 0,
    ghost_out: int = 0,
) -> np.ndarray:
    """M[j_out, c_in]: fine node j takes kernel[j - 2c - lo] from coarse
    node c (transpose pattern of the restriction)."""
    M = np.zeros((total_out, total_in))
    ws = len(kernel)
    for j in range(nodes_out):
        for k, w in enumerate(kernel):
            num = j - lo - k
            if num % 2:
                continue
            c = num // 2
            col = ghost_in + c
            if 0 <= col < total_in and 0 <= c:
                M[ghost_out + j, col] += w
    return M


def separable_kernels(ig: IntergridStencil) -> Tuple[np.ndarray, ...]:
    """Per-dim 1D kernels of the (tensor-product) weight window.  Uses
    the stored factorization when present, else recovers it by rank-1
    (HOSVD-style) factorization and verifies exactness."""
    if ig.kernels_1d is not None:
        return tuple(np.asarray(k, dtype=np.float64) for k in ig.kernels_1d)
    W = np.asarray(ig.weights, dtype=np.float64)
    nd = W.ndim
    # rank-1 factor: take the slice through the peak entry along each dim
    peak = np.unravel_index(np.argmax(np.abs(W)), W.shape)
    pv = W[peak]
    kernels = []
    for d in range(nd):
        idx = list(peak)
        idx[d] = slice(None)
        kernels.append(W[tuple(idx)].copy())
    # slice through the peak along d equals k_d * (pv / k_d[peak_d]);
    # the outer product of all slices is W * pv^(nd-1), so divide all
    # but the first slice by pv
    kernels = [k / (pv if i else 1.0) for i, k in enumerate(kernels)]
    rebuilt = kernels[0]
    for k in kernels[1:]:
        rebuilt = np.multiply.outer(rebuilt, k)
    if not np.allclose(rebuilt, W, atol=1e-12):
        raise ValueError("transfer window is not separable")
    return tuple(kernels)


def apply_separable(mats: Sequence[jnp.ndarray], x: jnp.ndarray) -> jnp.ndarray:
    """y = (M_0 x M_1 x ... ) . x — one full-precision contraction per dim."""
    for d, M in enumerate(mats):
        x = jnp.moveaxis(
            jnp.tensordot(M.astype(x.dtype), x, axes=([1], [d]),
                          precision=lax.Precision.HIGHEST), 0, d
        )
    return x


def build_restrict_mats(
    ig: IntergridStencil,
    coarse_nodes: Tuple[int, ...],
    fine_total: Tuple[int, ...],
    coarse_total: Tuple[int, ...],
    ghosts: Tuple[int, ...] = None,
):
    """Per-dim restriction matrices; `ghosts` (per dim, default 0) is the
    ghost width of both the fine input and the coarse output."""
    kernels = separable_kernels(ig)
    ghosts = ghosts or (0,) * ig.ndim
    # numpy (concrete) so cached matrices never capture a jit trace
    return [
        restriction_matrix_1d(
            kernels[d], ig.lo[d], coarse_nodes[d], fine_total[d],
            coarse_total[d], ghosts[d], ghosts[d],
        )
        for d in range(ig.ndim)
    ]


def build_prolong_mats(
    ig: IntergridStencil,
    fine_nodes: Tuple[int, ...],
    coarse_total: Tuple[int, ...],
    fine_total: Tuple[int, ...],
    ghosts: Tuple[int, ...] = None,
):
    """Per-dim prolongation matrices; `ghosts` as in build_restrict_mats."""
    kernels = separable_kernels(ig)
    ghosts = ghosts or (0,) * ig.ndim
    return [
        prolongation_matrix_1d(
            kernels[d], ig.lo[d], fine_nodes[d], coarse_total[d],
            fine_total[d], ghosts[d], ghosts[d],
        )
        for d in range(ig.ndim)
    ]
