"""Tests that need the GPU; they skip elsewhere.  `chip_smoke.py` runs
them on the card (pytest -m gpu with JAX_PLATFORMS=cuda)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from exastencils_jax.config import Knowledge
from exastencils_jax.core.stencil import node_prolongation, node_restriction
from exastencils_jax.models.poisson import PoissonMGSolver
from exastencils_jax.ops.stencil_apply import prolong, restrict
from exastencils_jax.ops.transfer import (
    apply_separable,
    build_prolong_mats,
    build_restrict_mats,
)
from exastencils_jax.runtime.performance import device_spec

pytestmark = pytest.mark.gpu


def test_device_table_has_this_card(gpu):
    assert device_spec(gpu).hbm_bytes_per_s > 0


@pytest.mark.parametrize("kind", ["restrict", "prolong"])
def test_f32_transfers_run_at_full_precision(gpu, kind):
    """Banded-matrix transfers in f32 agree with the strided-slice form
    to f32 rounding; a TF32 contraction (10-bit mantissa) would miss by
    ~1e-3."""
    n, nc = 129, 65
    fine, coarse = (n,) * 3, (nc,) * 3
    rng = np.random.default_rng(0)
    if kind == "restrict":
        op = node_restriction(3)
        x = jnp.asarray(rng.standard_normal(fine), jnp.float32)
        mm = apply_separable(build_restrict_mats(op, coarse, fine, coarse), x)
        sl = restrict(op, x, coarse)
    else:
        op = node_prolongation(3)
        x = jnp.asarray(rng.standard_normal(coarse), jnp.float32)
        mm = apply_separable(build_prolong_mats(op, fine, coarse, fine), x)
        sl = prolong(op, x, fine)
    err = float(jnp.max(jnp.abs(mm - sl)) / jnp.max(jnp.abs(sl)))
    assert err < 1e-6, err


def test_f32_cycle_contracts(gpu):
    k = Knowledge(dimensionality=3, minLevel=0, maxLevel=6,
                  useDblPrecision=False).update()
    s = PoissonMGSolver(k)
    sol, rhs = s.init_state()
    r0 = float(s._res_norm(sol, rhs))
    sol = s._cycle(jnp.copy(sol), rhs)
    r1 = float(s._res_norm(sol, rhs))
    assert r1 < 0.1 * r0
    assert jax.devices()[0].platform == "gpu"
