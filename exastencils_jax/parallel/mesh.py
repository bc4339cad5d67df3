"""Device meshes for spatial domain decomposition.

Reference: the block/fragment decomposition (config/Knowledge.scala:96-132,
domain/ir/IR_InitGeneratedDomain.scala) where 1 MPI rank = 1 block of
fragments.  Here: one mesh axis per sharded spatial dimension and one
fragment per device; neighbor shifts are `ppermute`s between devices
(SURVEY.md §2.4 mapping table).  The mesh follows the decomposition:
GPUs of one host are joined all to all, so no device order is
preferred.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


AXIS_NAMES = ("bx", "by", "bz")


def make_domain_mesh(
    shape: Sequence[int],
    devices: Optional[Sequence] = None,
    axis_names: Tuple[str, ...] = None,
) -> Mesh:
    """Build an N-d spatial mesh; `shape[d]` shards along spatial dim d."""
    shape = tuple(int(s) for s in shape)
    names = tuple(axis_names or AXIS_NAMES[: len(shape)])
    if devices is None:
        try:
            return jax.make_mesh(shape, names)
        except (TypeError, ValueError):
            devices = jax.devices()
    devs = np.asarray(devices)[: int(np.prod(shape))].reshape(shape)
    return Mesh(devs, names)


def mesh_from_knowledge(knowledge, devices=None) -> Mesh:
    """Mesh shape from Knowledge: explicit `mesh_shape`, else the
    rectangular block counts (domain_rect_numBlocks_*) over spatial dims."""
    if knowledge.mesh_shape:
        shape = tuple(knowledge.mesh_shape)
    else:
        shape = tuple(
            getattr(knowledge, f"domain_rect_numBlocks_{'xyz'[d]}")
            for d in range(knowledge.dimensionality)
        )
    return make_domain_mesh(shape, devices=devices)


def fragment_spec(mesh: Mesh) -> P:
    """PartitionSpec for a fragment-stacked field: axis d of the array is
    sharded by mesh axis d."""
    return P(*mesh.axis_names)


def fragment_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, fragment_spec(mesh))
