"""Shared fixtures.  NOTE: no XLA device-count flags here — smoke tests and
benches must see the host's single real device; only launch/dryrun.py (and
the subprocess-based tests) force placeholder devices."""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long model-forward tests excluded from the CI budget "
        "(run with -m slow or no -m filter)")
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA GPU; skips inside the test without one")


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)
