"""Shared fixtures. NOTE: no XLA_FLAGS here — smoke tests must see the
real (single) device; multi-device tests spawn subprocesses that set
--xla_force_host_platform_device_count themselves."""
import os
import sys

import jax
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    # CI runs a fast tier-1 job with `-m "not slow"` and a separate
    # `-m slow` job for the multi-step mesh parity sweeps (subprocess
    # compiles dominate); a plain `pytest` run still collects everything.
    config.addinivalue_line(
        "markers",
        "slow: multi-step virtual-mesh parity tests (subprocess compiles;"
        " run via `pytest -m slow` / excluded from the fast CI job)")
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA device (the port's kernels); skips without one")


@pytest.fixture
def key():
    return jax.random.PRNGKey(0)


SUBPROCESS_ENV_8DEV = {
    **os.environ,
    "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
    "PYTHONPATH": os.path.join(os.path.dirname(__file__), "..", "src"),
}
