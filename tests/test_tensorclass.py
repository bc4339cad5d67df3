"""TensorClass — the reference's tensor-datatype suite
(Testing/TensorClass/{Access,Arithmetic,Constructors,Eigenvalues}).

All committed reference .results are EMPTY (0 bytes), and run_test.py's
check_results zips generated output against expected lines — an empty
golden makes these generate+compile+run gates, not output diffs
(Testing/run_test.py:24 `zip` stops at the shorter sequence).  The
executable semantics implemented here follow
baseExt/ir/IR_TensorOperations.scala: tensor literals tens1/tens2/tensN,
elementwise add/dotp (dotProductTwoTensors2 multiplies entry-by-entry),
dyadic outer products, asTensor1/asTensor2 reshapes, compare as a
boolean expression, and eigen() writing sorted eigenvalues of an
order-2 tensor into a Matrix<Real, d, 1>.
"""

import glob
import os

import numpy as np
import pytest

pytestmark = pytest.mark.slow  # full-tier only (ci.sh quick gate skips)

from exastencils_jax.config import Knowledge
from exastencils_jax.config.parser import parse_config_file
from exastencils_jax.dsl.interpreter import L4Executable
from exastencils_jax.dsl.parser import parse_l4


def _run(exa_path):
    kn = glob.glob(os.path.join(os.path.dirname(exa_path), "*.knowledge"))[0]
    k = Knowledge()
    parse_config_file(kn, k)
    k.update()
    prog = parse_l4(exa_path)
    lines = []
    ex = L4Executable(prog, k, out=lines.append)
    ex.run()
    return ex, lines


def _cases(reference_root):
    return sorted(
        glob.glob(
            os.path.join(reference_root, "Testing", "TensorClass", "*", "*.exa4")
        )
    )


def test_tensorclass_all_programs_run(reference_root):
    cases = _cases(reference_root)
    assert len(cases) == 6
    for exa in cases:
        _run(exa)  # no exception = the reference's pass criterion


def test_tensor_constructors_compare_success(reference_root):
    base = os.path.join(reference_root, "Testing", "TensorClass")
    _, lines = _run(os.path.join(base, "Constructors", "Tensor1_constructors.exa4"))
    assert "sucess m2 == m1" in lines and "sucess m2 == m3" in lines
    _, lines = _run(os.path.join(base, "Constructors", "TensorN_constructors.exa4"))
    assert "sucess m2 == m2t" in lines  # TensorN order-2 == Tensor2 layout
    _, lines = _run(os.path.join(base, "Constructors", "Tensor2_constructors.exa4"))
    assert "sucess t1 == t4" in lines
    assert "success: converted TensorN to Tensor2" in lines
    # the dyadic-vs-literal compare is genuinely FALSE under the
    # reference's own index convention (set(x,y) -> linear y*d+x,
    # IR_TensorAccess.scala:296; dyadic tmp(x,y)=m[x]*n[y]) — the
    # "success: build correct Tensor2" line must NOT appear
    assert not any("dyadic" in l for l in lines)


def test_tensor_eigenvalues(reference_root):
    """eigen(t, res) on the all-ones 3x3 tensor: eigenvalues {3, 0, 0}
    written into the Matrix variable (QR-iteration analog,
    IR_TensorOperations.scala:480-520)."""
    exa = os.path.join(
        reference_root, "Testing", "TensorClass", "Eigenvalues",
        "Tensor2_eigenvalues.exa4",
    )
    kn = glob.glob(os.path.join(os.path.dirname(exa), "*.knowledge"))[0]
    k = Knowledge()
    parse_config_file(kn, k)
    k.update()
    src = open(exa).read().replace(
        "eigen(t1, res)", "eigen(t1, res)\n    print(res[0], res[1], res[2])"
    )
    prog = parse_l4(src)
    lines = []
    L4Executable(prog, k, out=lines.append).run()
    vals = [float(x) for x in lines[-1].split()]
    assert np.allclose(sorted(vals), [0.0, 0.0, 3.0], atol=1e-10)
