"""Regression tests for the XLA SPMD dynamic-update-slice miscompile and
the shardsafe workaround (ops/shardsafe.py).

Observed on jax 0.9.0 / CPU backend with 8 virtual devices: jitting a
chain of >= 3 ``x.at[plane].set(v)`` writes on an array with a sharded
dim returns wrong values near the shard boundary (as if cross-shard
reads were zero), while eager execution and ``jax.disable_jit()`` are
correct.  This broke the CellBased/2D_Basic sharded golden on the 4x2
mesh (round-2 VERDICT Weak #1): the Dirichlet-cell ghost construction in
the staged smoother used exactly that pattern.

These tests (a) pin the workaround's correctness, and (b) detect if a
future jax upgrade fixes — or worsens — the underlying bug (the xfail
will start XPASSing when fixed upstream).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from exastencils_jax.ops.shardsafe import embed_add, embed_block, plane_set


@pytest.fixture(scope="module")
def mesh42():
    if len(jax.devices()) < 8:
        pytest.skip("need 8 devices")
    return Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("bx", "by"))


def _ghost_chain_at_set(a):
    """The buggy pattern: 4 chained DUS writes building ghost planes."""
    xp = jnp.pad(a, 1, mode="edge")
    xp = xp.at[0, 1:9].set(-a[0])
    xp = xp.at[9, 1:9].set(-a[-1])
    xp = xp.at[1:9, 0].set(-a[:, 0])
    xp = xp.at[1:9, 9].set(-a[:, -1])
    return (4 * xp[1:-1, 1:-1] - xp[:-2, 1:-1] - xp[2:, 1:-1]
            - xp[1:-1, :-2] - xp[1:-1, 2:])


def _ghost_chain_plane_set(a):
    """The shardsafe formulation of the same computation."""
    xp = jnp.pad(a, 1, mode="edge")
    within = {1: (1, 9)}
    xp = plane_set(xp, 0, 0, jnp.pad(-a[0], 1), within=within)
    xp = plane_set(xp, 0, 9, jnp.pad(-a[-1], 1), within=within)
    within = {0: (1, 9)}
    xp = plane_set(xp, 1, 0, jnp.pad(-a[:, 0], 1), within=within)
    xp = plane_set(xp, 1, 9, jnp.pad(-a[:, -1], 1), within=within)
    return (4 * xp[1:-1, 1:-1] - xp[:-2, 1:-1] - xp[2:, 1:-1]
            - xp[1:-1, :-2] - xp[1:-1, 2:])


def test_plane_set_chain_correct_sharded(mesh42):
    a = jax.random.normal(jax.random.PRNGKey(1), (8, 8), jnp.float64)
    a_s = jax.device_put(a, NamedSharding(mesh42, P(None, "by")))
    dense = _ghost_chain_plane_set(a)
    jitted = jax.jit(_ghost_chain_plane_set)(a_s)
    np.testing.assert_allclose(np.asarray(jitted), np.asarray(dense), atol=1e-14)


@pytest.mark.xfail(
    reason="XLA SPMD miscompiles >=3 chained dynamic-update-slices on a "
    "sharded array (jax 0.9.0 CPU); XPASS means the upstream bug is fixed",
    strict=False,
)
def test_at_set_chain_xla_spmd_bug(mesh42):
    a = jax.random.normal(jax.random.PRNGKey(1), (8, 8), jnp.float64)
    a_s = jax.device_put(a, NamedSharding(mesh42, P(None, "by")))
    dense = _ghost_chain_at_set(a)
    jitted = jax.jit(_ghost_chain_at_set)(a_s)
    np.testing.assert_allclose(np.asarray(jitted), np.asarray(dense), atol=1e-12)


def test_plane_set_semantics_match_at_set():
    """Dense semantic equivalence of plane_set vs .at[].set."""
    a = jax.random.normal(jax.random.PRNGKey(2), (6, 7), jnp.float64)
    row = jnp.arange(7, dtype=jnp.float64)
    np.testing.assert_array_equal(
        np.asarray(plane_set(a, 0, 2, row)), np.asarray(a.at[2, :].set(row)))
    np.testing.assert_array_equal(
        np.asarray(plane_set(a, 0, -1, 3.5)), np.asarray(a.at[-1, :].set(3.5)))
    col = jnp.arange(6, dtype=jnp.float64)
    np.testing.assert_array_equal(
        np.asarray(plane_set(a, 1, 0, col, within={0: (2, 5)})),
        np.asarray(a.at[2:5, 0].set(col[2:5])))
    # trailing element dims written whole (matrix-valued fields)
    m = jax.random.normal(jax.random.PRNGKey(3), (4, 5, 2, 2), jnp.float64)
    v = jnp.ones((5, 2, 2))
    np.testing.assert_array_equal(
        np.asarray(plane_set(m, 0, 1, v[None], ndim_grid=2)),
        np.asarray(m.at[1].set(v)))


def test_embed_block_and_add():
    core = jnp.arange(6.0).reshape(2, 3)
    out = embed_block(core, (4, 5), offsets=(1, 2))
    expect = np.zeros((4, 5))
    expect[1:3, 2:5] = np.arange(6.0).reshape(2, 3)
    np.testing.assert_array_equal(np.asarray(out), expect)
    base = jnp.ones((4, 5))
    out2 = embed_add(base, core, (1, 2))
    np.testing.assert_array_equal(np.asarray(out2), 1.0 + expect)
