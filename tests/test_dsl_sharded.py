"""Sharded execution of DSL programs (VERDICT r1 item 1).

The full ExaSlang path — `.settings/.knowledge` triples through the L4
interpreter — runs with field state distributed over an explicit device
mesh (2x2 and 4x2 virtual CPU devices, the analog of the reference's
`mpirun --oversubscribe` CommBasic rig) and still matches the
reference's committed `.results` digit-for-digit.  `communicate`
statements pin mesh placement; XLA's SPMD partitioner inserts the halo
collectives inside the staged runs (reference equivalent:
communication/ir/IR_SetupCommunication.scala:41-147 +
Testing/CommBasic/PureMPI.knowledge).
"""

import os

import numpy as np
import pytest

pytestmark = pytest.mark.slow  # full-tier only (ci.sh quick gate skips)

import jax
from jax.sharding import Mesh

from exastencils_jax.config import Knowledge
from exastencils_jax.config.parser import parse_config_file
from exastencils_jax.dsl.driver import build_program
from exastencils_jax.dsl.interpreter import L4Executable
from exastencils_jax.dsl.parser import parse_l4


def _program(base, k):
    if os.path.exists(base + ".settings"):
        return build_program(base + ".settings", k)
    return parse_l4(base + ".exa4")

CASES = [
    ("Poisson", "2D_FD_Poisson_fromL4"),
    ("Poisson", "2D_FD_Poisson_fromL2"),
    ("BC", "2D_Polynomial"),
    ("CellBased", "2D_Basic"),
]
MESHES = [(2, 2), (4, 2)]


def _mesh(shape):
    n = int(np.prod(shape))
    if len(jax.devices()) < n:
        pytest.skip(f"need {n} devices")
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), ("bx", "by"))


@pytest.mark.parametrize("mesh_shape", MESHES, ids=["2x2", "4x2"])
@pytest.mark.parametrize("suite,name", CASES, ids=[f"{s}/{n}" for s, n in CASES])
def test_sharded_dsl_golden(suite, name, mesh_shape, reference_root):
    base = os.path.join(reference_root, "Testing", suite, name)
    k = Knowledge()
    parse_config_file(base + ".knowledge", k)
    # shard even the small test grids (default threshold targets
    # production sizes)
    k.coarse_replicate_threshold = 4
    k.update()
    prog = _program(base, k)
    lines = []
    ex = L4Executable(prog, k, out=lines.append, mesh=_mesh(mesh_shape))
    assert ex.mesh is not None
    # fields are genuinely distributed (not just logically annotated)
    n_dev = int(np.prod(mesh_shape))
    distributed = [
        key for key, arr in ex.state.items()
        if len(arr.sharding.device_set) == n_dev
    ]
    assert distributed, "no field placed across the full mesh"
    ex.run()
    with open(base + ".results") as f:
        golden = [l.strip() for l in f]
    assert [l.strip() for l in lines] == golden
    # after the solve the state is still mesh-placed
    fine = max(lvl for (_, lvl) in ex.state)
    still = [
        key for key, arr in ex.state.items()
        if key[1] == fine and len(arr.sharding.device_set) == n_dev
    ]
    assert still, "finest-level fields lost their mesh placement"


# mesh-invariance law (round-2 VERDICT item 1): the numerics must be
# IDENTICAL on every mesh shape, including the shapes where node grids
# (2^l+1) pick up a mesh-pad tail (1x8, 8x1) and where dup/ghost bugs
# live.  Reference analog: pad segments are never iterated
# (field/ir/IR_FieldLayout.scala:51-73) and goldens are decomposition-
# independent (Testing/CommBasic).
BITWISE_MESHES = [(2, 2), (4, 2), (1, 8), (8, 1)]


@pytest.mark.parametrize("suite,name", CASES, ids=[f"{s}/{n}" for s, n in CASES])
def test_sharded_vs_dense_bitwise(suite, name, reference_root):
    """The mesh never changes the numerics: dense and sharded runs
    produce identical output byte-for-byte (full precision compare,
    stricter than the reduced-precision goldens) on every mesh shape."""
    base = os.path.join(reference_root, "Testing", suite, name)

    def run(mesh):
        k = Knowledge()
        parse_config_file(base + ".knowledge", k)
        k.coarse_replicate_threshold = 4
        if mesh is None:
            k.shard_dsl = False
        k.update()
        prog = _program(base, k)
        lines = []
        L4Executable(prog, k, out=lines.append, mesh=mesh).run()
        return lines

    dense = run(None)
    for shape in BITWISE_MESHES:
        sharded = run(_mesh(shape))
        assert sharded == dense, f"mesh {shape} changed the numerics"
