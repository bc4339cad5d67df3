"""GSPMD-safe array writes for traced code on mesh-sharded fields.

XLA's SPMD partitioner (jax 0.9.0, CPU backend at minimum) miscompiles
chains of >= 3 dynamic-update-slice ops on an array with a sharded
dimension: e.g. building Dirichlet ghost planes with four sequential
``x.at[plane].set(v)`` writes inside one jitted computation returns
values as if cross-shard reads were zero (reproduced and regression-
tested in tests/test_shardsafe.py; single writes and 2-write chains
compile correctly).  Everything here therefore expresses "write a
hyperplane / embed a block" as *elementwise selects on iota masks* or
as ``jnp.pad`` — both of which partition trivially (masks and pads are
local to each shard), need no halo communication, and fuse into the
consuming stencil op.

This is also the better formulation independent of the bug: a select
on an iota mask fuses into the elementwise kernel, while a scatter/DUS
on a sharded dim forces XLA to materialize update buffers.

Reference analog: the generated per-neighbor boundary loops of
boundary/ir/IR_HandleBoundaries.scala become these masked selects.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import jax.numpy as jnp
from jax import lax


def plane_set(
    arr: jnp.ndarray,
    dim: int,
    idx: int,
    values,
    within: Optional[Dict[int, Tuple[int, int]]] = None,
    ndim_grid: Optional[int] = None,
) -> jnp.ndarray:
    """``arr[plane(dim, idx)] = values`` as an elementwise select.

    `idx` may be negative.  `values` is a scalar, or an array
    broadcastable to the plane (either with arr's rank and size-1 at
    `dim`, or with the plane's rank = arr.ndim-1); entries outside the
    plane are never consumed, so broadcasting along `dim` is free.
    `within` restricts the write to ``lo <= i < hi`` windows on other
    dims (negative bounds wrap like Python slices).  `ndim_grid` caps
    mask construction to the leading grid dims (trailing element dims
    of matrix-valued fields are written whole).
    """
    nd = arr.ndim if ndim_grid is None else ndim_grid
    n = arr.shape[dim]
    i = idx % n
    m = lax.broadcasted_iota(jnp.int32, arr.shape[:nd], dim) == i
    if within:
        for dd, (lo, hi) in within.items():
            lo = lo % arr.shape[dd] if lo < 0 else lo
            hi = hi % arr.shape[dd] if hi < 0 else hi
            j = lax.broadcasted_iota(jnp.int32, arr.shape[:nd], dd)
            m = jnp.logical_and(m, jnp.logical_and(j >= lo, j < hi))
    if nd < arr.ndim:
        m = m.reshape(m.shape + (1,) * (arr.ndim - nd))
    v = jnp.asarray(values, arr.dtype)
    if v.ndim == arr.ndim - 1:
        v = jnp.expand_dims(v, dim)
    v = jnp.broadcast_to(v, arr.shape)
    return jnp.where(m, v, arr)


def embed_block(
    core: jnp.ndarray,
    shape: Tuple[int, ...],
    offsets: Optional[Tuple[int, ...]] = None,
) -> jnp.ndarray:
    """Zero-embed `core` into an array of `shape` at `offsets`
    (default 0) — the pad-based replacement for
    ``zeros(shape).at[slices].set(core)``.  Trailing dims of `core`
    beyond len(shape)... must already match; `shape` covers the leading
    dims only when shorter than core.ndim."""
    nd = len(shape)
    offsets = offsets or (0,) * nd
    pads = [
        (offsets[d], shape[d] - offsets[d] - core.shape[d]) for d in range(nd)
    ] + [(0, 0)] * (core.ndim - nd)
    return jnp.pad(core, pads)


def embed_add(arr: jnp.ndarray, upd: jnp.ndarray, offsets: Tuple[int, ...]) -> jnp.ndarray:
    """``arr[off:off+n] += upd`` as pad + add (replaces .at[].add).
    When the shifted update overhangs the array (same-shape field
    updated at a block offset, e.g. solve-locally 2x2x2 blocks), the
    overhang is cropped — those DOFs do not exist."""
    nd = upd.ndim
    pads = [
        (offsets[d], max(0, arr.shape[d] - offsets[d] - upd.shape[d]))
        for d in range(nd)
    ]
    x = jnp.pad(upd, pads)
    if x.shape != arr.shape:
        x = x[tuple(slice(0, n) for n in arr.shape)]
    return arr + x
