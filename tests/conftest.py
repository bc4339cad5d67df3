"""Test env: the CPU backend with 8 virtual devices by default (the analog
of the reference's `mpirun --oversubscribe` single-node multi-rank
testing, Utilities/run_exastencils.py:49-58) and float64 enabled for
golden-parity residual sequences.

A `JAX_PLATFORMS` that is already set is respected: `chip_smoke.py` runs
the `gpu`-marked tests with `JAX_PLATFORMS=cuda`.  Whether a GPU or
enough devices are present is decided inside fixtures, never while a
module is imported, so every xdist worker collects the same tests."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402

REFERENCE = "/root/reference"


@pytest.fixture(scope="session")
def reference_root():
    if not os.path.isdir(REFERENCE):
        pytest.skip("reference tree not mounted")
    return REFERENCE


@pytest.fixture(scope="session")
def gpu():
    """The first GPU device; skips where JAX finds none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX platform is {dev.platform!r}); "
                    "run on the card with `python chip_smoke.py`")
    return dev


@pytest.fixture(scope="session")
def four_devices():
    """Four devices for a (2, 2) mesh (virtual CPU devices here)."""
    devs = jax.devices()
    if len(devs) < 4:
        pytest.skip(f"needs >= 4 devices, have {len(devs)}")
    return devs[:4]


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running suite — the quick gate (ci.sh) deselects these; "
        "the full tier (ci.sh full / nightly) runs everything",
    )
    config.addinivalue_line(
        "markers",
        "huge: 576^3-scale goldens (~20 min each) — nightly tier only "
        "(ci.sh nightly)",
    )
    config.addinivalue_line(
        "markers",
        "gpu: needs a GPU — skips elsewhere; run on the card by "
        "`python chip_smoke.py` (pytest -m gpu with JAX_PLATFORMS=cuda)",
    )
