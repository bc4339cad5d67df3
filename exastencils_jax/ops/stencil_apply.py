"""Stencil application and 2:1 inter-grid transfers on dense level arrays.

These are the reference's hot generated loop nests (stencil convolution,
stencil/ir/IR_StencilConvolution.scala:37; restriction/prolongation loops
of §3.3 in SURVEY.md) re-expressed as shifted-slice sums that XLA fuses
into a single memory-bound pass.  Zero padding reproduces the reference's
physical-boundary ghost semantics: ghost layers at the domain boundary
are allocated but never written, hence hold their initFieldsWithZero
value (field/ir/IR_InitFieldsWithZero.scala).

These plain jnp versions are what every dense level runs; XLA fuses
each into one pass.  They are also the reference any hand-written
kernel must match.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import jax.numpy as jnp

from exastencils_jax.core.stencil import BoundStencil, IntergridStencil


def apply_stencil(
    st: BoundStencil,
    x: jnp.ndarray,
    pad_value: float = 0.0,
    pad_mode: str = "constant",
    padded_radius: int = None,
    out_shape: Tuple[int, ...] = None,
) -> jnp.ndarray:
    """out[i] = sum_k c_k * x[i + off_k] over the full array.

    pad_mode encodes the virtual-ghost boundary treatment of the operand
    field: 'constant' (zero ghosts, the default node-field semantics) or
    'edge' (mirrored ghosts = zero-flux Neumann for cell fields,
    reference boundary/ir ghost extrapolation).  When the caller already
    supplies a ghost-padded operand (bc-aware folding), pass
    `padded_radius` and the unpadded `out_shape`."""
    if len(st.offsets) == 1 and st.radius == 0:
        return st.coefs[0] * (
            x if padded_radius is None else x[tuple(slice(padded_radius, padded_radius + n) for n in out_shape)]
        )
    r = st.radius
    if padded_radius is None:
        if pad_mode == "constant":
            xp = jnp.pad(x, r, constant_values=pad_value)
        else:
            xp = jnp.pad(x, r, mode=pad_mode)
        shape = x.shape
    else:
        assert padded_radius >= r
        xp, shape = x, tuple(out_shape)
        r = padded_radius
    out = None
    for off, c in st.items():
        sl = tuple(slice(r + o, r + o + n) for o, n in zip(off, shape))
        term = c * xp[sl]
        out = term if out is None else out + term
    return out


def _restriction_padding(ig: IntergridStencil, coarse_shape, fine_shape):
    pads = []
    for d in range(ig.ndim):
        lo = ig.lo[d]
        ws = ig.weights.shape[d]
        lo_pad = max(0, -lo)
        hi_pad = max(0, 2 * (coarse_shape[d] - 1) + lo + ws - 1 - (fine_shape[d] - 1))
        pads.append((lo_pad, hi_pad))
    return pads


def restrict(ig: IntergridStencil, fine: jnp.ndarray, coarse_shape: Tuple[int, ...]) -> jnp.ndarray:
    """coarse[i] = sum_d w[d] * fine[2*i + lo + d] with zero ghosts."""
    assert ig.kind == "restriction"
    pads = _restriction_padding(ig, coarse_shape, fine.shape)
    fp = jnp.pad(fine, pads)
    out = None
    for idx in np.ndindex(*ig.weights.shape):
        w = float(ig.weights[idx])
        if w == 0.0:
            continue
        sl = tuple(
            slice(p[0] + ig.lo[d] + idx[d], p[0] + ig.lo[d] + idx[d] + 2 * (coarse_shape[d] - 1) + 1, 2)
            for d, p in enumerate(pads)
        )
        term = w * fp[sl]
        out = term if out is None else out + term
    return out


def prolong(ig: IntergridStencil, coarse: jnp.ndarray, fine_shape: Tuple[int, ...]) -> jnp.ndarray:
    """fine[j] = sum_c w[j - 2*c - lo] * coarse[c]  (transpose of restrict).

    Implemented as zero-stuffing (U[2c] = coarse[c]) followed by a
    correlation with the weight window — both fuse in XLA."""
    assert ig.kind == "prolongation"
    nd = ig.ndim
    up_shape = tuple(2 * (coarse.shape[d] - 1) + 1 for d in range(nd))
    up = jnp.zeros(up_shape, coarse.dtype)
    up = up.at[tuple(slice(None, None, 2) for _ in range(nd))].set(coarse)

    # padding so that index j - (idx + lo) always lands inside
    pads = []
    for d in range(nd):
        lo = ig.lo[d]
        ws = ig.weights.shape[d]
        # index into up: j - idx - lo for idx in [0, ws-1], j in [0, fine_shape-1]
        min_ix = 0 - (ws - 1) - lo
        max_ix = (fine_shape[d] - 1) - 0 - lo
        pads.append((max(0, -min_ix), max(0, max_ix - (up_shape[d] - 1))))
    upp = jnp.pad(up, pads)
    out = None
    for idx in np.ndindex(*ig.weights.shape):
        w = float(ig.weights[idx])
        if w == 0.0:
            continue
        sl = tuple(
            slice(pads[d][0] - idx[d] - ig.lo[d], pads[d][0] - idx[d] - ig.lo[d] + fine_shape[d])
            for d in range(nd)
        )
        term = w * upp[sl]
        out = term if out is None else out + term
    return out
