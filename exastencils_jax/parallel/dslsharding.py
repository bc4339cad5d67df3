"""Device-mesh placement for DSL (ExaSlang) execution — GSPMD route.

Design (SURVEY §7 design mapping): the DSL execution path
scales by XLA's automatic SPMD partitioning.  Field state lives as
dense *global* ``jax.Array``s placed on a device mesh with
``NamedSharding``; every staged (jitted) statement run is partitioned
by XLA, which inserts the halo collectives (collective-permute at
stencil offsets, all-reduce at reductions) that the reference
synthesizes as MPI pack/Isend/Irecv/unpack functions
(reference: communication/ir/IR_SetupCommunication.scala:41-147,
parallelization/api/mpi/MPI_Communication.scala:28-36).

`communicate field` statements therefore lower to *placement*: a
sharding constraint pinning the field to its mesh layout (eager:
``jax.device_put``; staged: ``jax.lax.with_sharding_constraint``).
The data motion the reference performs at a `communicate` happens
inside the partitioned stencil ops themselves — there is nothing
else to do, and hand-packing ghost buffers would only hide
the halo from XLA's fusion/overlap machinery.

The hand-optimized Python API (models/poisson.py over
parallel/backend.py) keeps the explicit shard_map + ppermute route
with fragment-stacked layouts for peak control; the DSL route trades
that for full generality over the ExaSlang surface.

Mesh shape: derived from the reference's decomposition flags
(domain_rect_numBlocks_* × domain_rect_numFragsPerBlock_*,
config/Knowledge.scala:96-132) and fitted to the available device
count; the numerics are decoupled from the physical mesh because the
interpreter already emulates fragment semantics (frozen-halo sweeps,
per-fragment ghost copies) on the dense representation.

Coarse-level strategy (SURVEY §7 "coarse multigrid levels"): a level
stops being sharded along an axis once its per-shard extent falls
below ``coarse_replicate_threshold`` — below that, halo traffic
dominates and the level is cheaper replicated.  The reference
sidesteps the same cliff by running the coarsest-grid CG with tiny
per-rank loop bounds.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def decomposition_from_knowledge(k, ndim: int) -> List[int]:
    """Desired shards per spatial dim: the reference's blocks × frags
    (domain/ir/IR_InitGeneratedDomain.scala:40-48), overridable by
    mesh_shape."""
    if k.mesh_shape:
        want = list(k.mesh_shape) + [1] * (ndim - len(k.mesh_shape))
        return want[:ndim]
    return [k.frags_total(d) for d in range(ndim)]


def fit_to_devices(want: List[int], n_devices: int) -> List[int]:
    """Fit a desired decomposition to the device count: among the
    factorizations of the largest feasible device count whose per-axis
    shard counts do not exceed the desired decomposition, pick the one
    closest to the desired aspect ratio.  (The naive decrement-largest
    approach left devices idle: want [4,4] on 8 devices gave [2,3]=6
    used; this gives [2,4]=8.)"""
    nd = len(want)
    cap = [max(1, int(w)) for w in want]

    def factorizations(n, dims):
        if dims == 1:
            yield (n,)
            return
        for f in range(1, n + 1):
            if n % f == 0:
                for rest in factorizations(n // f, dims - 1):
                    yield (f,) + rest

    for n in range(min(n_devices, math.prod(cap)), 0, -1):
        cands = [
            s for s in factorizations(n, nd)
            if all(s[d] <= cap[d] for d in range(nd))
        ]
        if cands:
            return list(min(
                cands,
                key=lambda s: (
                    sum(abs(math.log(s[d] / cap[d])) for d in range(nd)),
                    max(s),  # tie-break toward balanced (square) meshes
                ),
            ))
    return [1] * nd


def build_dsl_mesh(k, ndim: int, devices=None) -> Optional[Mesh]:
    """Mesh over the spatial axes ('bx', 'by', 'bz'); None when the
    config or the machine is single-device."""
    devices = list(devices if devices is not None else jax.devices())
    want = decomposition_from_knowledge(k, ndim)
    if math.prod(want) <= 1 or len(devices) <= 1:
        return None
    shape = fit_to_devices(want, len(devices))
    n = math.prod(shape)
    if n <= 1:
        return None
    names = tuple(k.mesh_axis_names[:ndim])
    devs = np.array(devices[:n]).reshape(tuple(shape))
    return Mesh(devs, names)


def field_spec(
    mesh: Mesh,
    grid_shape: Tuple[int, ...],
    threshold: int,
    lead_dims: int = 0,
    trail_dims: int = 0,
) -> P:
    """PartitionSpec for one field instance: spatial dim d is sharded
    over its mesh axis iff the per-shard extent stays >= threshold
    (coarse-level replication switch); slot (lead) and matrix-element
    (trail) dims are never sharded."""
    names = mesh.axis_names
    spec: list = [None] * lead_dims
    for d, n in enumerate(grid_shape):
        if d < len(names) and mesh.shape[names[d]] > 1 and (
            n // mesh.shape[names[d]] >= max(1, threshold)
        ):
            spec.append(names[d])
        else:
            spec.append(None)
    spec += [None] * trail_dims
    return P(*spec)


def field_sharding(mesh, grid_shape, threshold, lead_dims=0, trail_dims=0):
    return NamedSharding(
        mesh, field_spec(mesh, grid_shape, threshold, lead_dims, trail_dims)
    )


def store_shape(mesh: Mesh, spec: P, grid_shape: Tuple[int, ...],
                lead_dims: int = 0) -> Tuple[int, ...]:
    """Storage extents: each sharded dim padded up to a multiple of its
    mesh axis (jax.Array requires even shards; node grids are 2^l+1, so
    sharded node dims carry a zero pad tail that every loop mask
    excludes — the analog of the reference's layout padding,
    field/ir/IR_FieldLayout.scala `pad` segments)."""
    out = []
    for d, n in enumerate(grid_shape):
        name = spec[lead_dims + d] if lead_dims + d < len(spec) else None
        if name is None:
            out.append(n)
        else:
            p = mesh.shape[name]
            out.append(-(-n // p) * p)
    return tuple(out)
