"""Shared test fixtures.

NOTE: no XLA_FLAGS here on purpose -- unit tests must see the 1 real CPU
device. Multi-device tests spawn subprocesses that set
--xla_force_host_platform_device_count themselves (test_distributed.py).

If ``hypothesis`` is not installed (it is a ``[test]`` extra, not a
runtime dependency), a minimal stand-in module is registered so that
test modules importing it still *collect* cleanly; every ``@given``
property test then skips with a clear reason instead of erroring the
whole session.
"""
import os
import sys
import types

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

try:
    import hypothesis  # noqa: F401
    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

    def _given(*_a, **_k):
        def deco(fn):
            # Deliberately no functools.wraps: the stand-in must NOT expose
            # the strategy parameters, or pytest would treat them as
            # fixtures. Zero-arg skipper + copied name/doc only.
            def skipper():
                pytest.skip("hypothesis not installed (pip install -e "
                            "'.[test]'); property test skipped")
            skipper.__name__ = fn.__name__
            skipper.__doc__ = fn.__doc__
            return skipper
        return deco

    def _settings(*_a, **_k):
        return lambda fn: fn

    class _Strategy:
        """Placeholder: accepted by the stub ``given``, never drawn from."""
        def __call__(self, *a, **k):
            return self

        def __getattr__(self, name):
            return self

    _hyp = types.ModuleType("hypothesis")
    _hyp.given = _given
    _hyp.settings = _settings
    _hyp.assume = lambda *a, **k: True
    _hyp.note = lambda *a, **k: None
    # Any other hypothesis name (HealthCheck, example, ...) resolves to a
    # benign placeholder so collection can never hard-fail on the stub.
    _hyp.__getattr__ = lambda name: _Strategy()
    _st = types.ModuleType("hypothesis.strategies")
    _st.__getattr__ = lambda name: _Strategy()
    _hyp.strategies = _st
    sys.modules["hypothesis"] = _hyp
    sys.modules["hypothesis.strategies"] = _st

import jax  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc (skips without one)")


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)
