"""Test config: single-device CPU (the 512-device flag is dry-run-only).

`hypothesis` is optional: property-based test modules importorskip it, and
the profile is only registered when the package is present, so tier-1
collection never hard-fails on a missing test dependency.
"""
import numpy as np
import pytest

try:
    from hypothesis import settings
except ImportError:
    settings = None

if settings is not None:
    settings.register_profile("repro", max_examples=12, deadline=None)
    settings.load_profile("repro")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA card (CUDA); skips where none is")
