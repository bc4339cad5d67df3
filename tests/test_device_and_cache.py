"""Device table, compile-cache location and contraction precision."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from exastencils_jax.core.stencil import node_restriction
from exastencils_jax.ops.transfer import apply_separable, build_restrict_mats
from exastencils_jax.runtime import compile_cache
from exastencils_jax.runtime.performance import DEVICE_SPECS, device_spec


def test_apply_separable_lowers_with_highest_precision():
    fine, coarse = (9, 9, 9), (5, 5, 5)
    mats = build_restrict_mats(node_restriction(3), coarse, fine, coarse)
    x = jnp.zeros(fine, jnp.float32)
    hlo = jax.jit(lambda v: apply_separable(mats, v)).lower(x).as_text()
    assert hlo.count("dot_general") == 3
    assert "DEFAULT" not in hlo
    assert hlo.count("HIGHEST") >= 3


@pytest.mark.parametrize("environ,want", [
    ({"JAX_COMPILATION_CACHE_DIR": "/somewhere/cache"}, "/somewhere/cache"),
    ({}, compile_cache.DEFAULT_DIR),
    ({"JAX_COMPILATION_CACHE_DIR": ""}, compile_cache.DEFAULT_DIR),
])
def test_compile_cache_dir(environ, want):
    assert compile_cache.compile_cache_dir(environ) == want


def test_default_cache_dir_is_in_the_checkout():
    import os

    import exastencils_jax

    checkout = os.path.dirname(os.path.dirname(exastencils_jax.__file__))
    assert compile_cache.DEFAULT_DIR == os.path.join(checkout, ".jax_cache")


def test_enable_compile_cache_sets_jax_config(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/tmp/exa-test-cache")
    try:
        assert compile_cache.enable_compile_cache() == "/tmp/exa-test-cache"
        assert jax.config.jax_compilation_cache_dir == "/tmp/exa-test-cache"
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("kind,bw", [
    ("NVIDIA H100 80GB HBM3", 3.35e12),
    ("NVIDIA H100 PCIe", 2.0e12),
])
def test_device_table_resolves_h100(kind, bw):
    dev = types.SimpleNamespace(device_kind=kind, platform="gpu")
    spec = device_spec(dev)
    assert spec.hbm_bytes_per_s == bw
    assert "data sheet" in spec.source


def test_device_table_rejects_unknown_device():
    # the CPU test backend has no entry: nothing is assumed for it
    with pytest.raises(KeyError, match="no device table entry"):
        device_spec(jax.devices()[0])
    assert all(np.isfinite(s.hbm_bytes_per_s) for s in DEVICE_SPECS.values())


def test_perf_estimate_without_a_table_entry(caplog):
    """performance_printEstimation on a device the table lacks logs that
    there is no estimate; solver generation goes on."""
    from exastencils_jax.config import Knowledge
    from exastencils_jax.models.poisson import PoissonMGSolver

    k = Knowledge(dimensionality=2, minLevel=0, maxLevel=3,
                  performance_printEstimation=True).update()
    with caplog.at_level("INFO", logger="exastencils_jax"):
        PoissonMGSolver(k)
    assert "perf estimate: none (" in caplog.text
