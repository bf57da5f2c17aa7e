"""Shared fixtures.  NOTE: no XLA_FLAGS here — smoke tests and benches must
see the real single device; only launch/dryrun.py forces 512 host devices.
Tests that need a small multi-device mesh run in a subprocess
(tests/test_distributed.py) so they don't poison this process's jax init.
"""
import os
import sys

import numpy as np
import pytest

# tools/ (reprolint + the dynamic trace audit) lives at the repo root,
# which isn't on sys.path when pytest runs with PYTHONPATH=src.
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO_ROOT not in sys.path:
    sys.path.insert(0, _REPO_ROOT)

from tools.reprolint.trace_audit import trace_audit  # noqa: E402,F401


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (the port's kernels); skips without one")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def small_corpus(rng):
    """(2000, 64) unit-ish vectors with a planted mean component."""
    x = rng.normal(size=(2000, 64)).astype(np.float32)
    x += 0.5 * rng.normal(size=(1, 64)).astype(np.float32)
    return x
