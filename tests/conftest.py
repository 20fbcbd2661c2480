"""Shared test config. NOTE: no XLA_FLAGS here — smoke tests and benches
must see the real single CPU device (the 512-device override belongs to
the dry-run only).

``hypothesis`` is optional: in minimal environments the property-based
tests auto-skip instead of killing the whole suite at collection. The
shim below installs a stub ``hypothesis`` module whose ``@given`` turns
the test into a zero-argument skipper, so test modules import cleanly.
"""
import sys
import types

import numpy as np
import pytest

try:
    from hypothesis import HealthCheck, settings

    HAVE_HYPOTHESIS = True
except ModuleNotFoundError:
    HAVE_HYPOTHESIS = False

if HAVE_HYPOTHESIS:
    # jit compilation makes single examples slow; disable deadlines globally.
    settings.register_profile(
        "repro",
        deadline=None,
        max_examples=15,
        suppress_health_check=[HealthCheck.too_slow,
                               HealthCheck.data_too_large],
    )
    settings.load_profile("repro")
else:
    def _given(*_args, **_kwargs):
        def deco(fn):
            def skipper():
                pytest.skip("hypothesis not installed")
            skipper.__name__ = fn.__name__
            skipper.__doc__ = fn.__doc__
            skipper.__module__ = fn.__module__
            return skipper
        return deco

    class _Settings:
        """Stub for ``hypothesis.settings``: decorator factory + profiles."""
        def __init__(self, *_args, **_kwargs):
            pass

        def __call__(self, fn):
            return fn

        @staticmethod
        def register_profile(*_args, **_kwargs):
            pass

        @staticmethod
        def load_profile(*_args, **_kwargs):
            pass

    _strategies = types.ModuleType("hypothesis.strategies")
    # any strategy constructor (integers, floats, sampled_from, ...) is
    # accepted and returns an inert placeholder — @given never runs them.
    _strategies.__getattr__ = lambda name: (lambda *a, **k: None)

    _hyp = types.ModuleType("hypothesis")
    _hyp.given = _given
    _hyp.settings = _Settings
    _hyp.strategies = _strategies
    _hyp.HealthCheck = types.SimpleNamespace(
        too_slow=None, data_too_large=None, filter_too_much=None,
        function_scoped_fixture=None)
    _hyp.assume = lambda *a, **k: True
    _hyp.example = lambda *a, **k: (lambda fn: fn)
    sys.modules["hypothesis"] = _hyp
    sys.modules["hypothesis.strategies"] = _strategies


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips inside the test "
        "without one (run on the card with `pytest -m cuda`)")
