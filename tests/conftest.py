import os

# Tests run on the single host device (the dry-run sets its own 512-device
# flag in its own subprocesses; never globally — see the assignment brief).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import sys
import types

import jax
import pytest

jax.config.update("jax_enable_x64", False)

# ---------------------------------------------------------------------------
# hypothesis compat shim: when hypothesis is absent (minimal containers),
# install a stub so property-based test modules still collect; every
# @given-decorated test then skips instead of erroring at import.
# ---------------------------------------------------------------------------
try:
    import hypothesis  # noqa: F401
except ImportError:
    def _given(*_a, **_k):
        def deco(fn):
            def skipper(*args, **kwargs):
                pytest.skip("hypothesis not installed (property test)")
            skipper.__name__ = fn.__name__
            skipper.__qualname__ = getattr(fn, "__qualname__", fn.__name__)
            skipper.__doc__ = fn.__doc__
            skipper.__module__ = fn.__module__
            return skipper
        return deco

    def _settings(*_a, **_k):
        def deco(fn):
            return fn
        return deco

    class _Strategy:
        """Inert stand-in: supports chaining (.map/.filter) and call."""

        def __call__(self, *a, **k):
            return self

        def __getattr__(self, name):
            return self

    _st = types.ModuleType("hypothesis.strategies")
    _st.__getattr__ = lambda name: _Strategy()   # PEP 562: any strategy name

    _hyp = types.ModuleType("hypothesis")
    _hyp.given = _given
    _hyp.settings = _settings
    _hyp.strategies = _st
    _hyp.assume = lambda *a, **k: True
    _hyp.note = lambda *a, **k: None
    _hyp.HealthCheck = _Strategy()
    _hyp.__getattr__ = lambda name: _Strategy()
    sys.modules["hypothesis"] = _hyp
    sys.modules["hypothesis.strategies"] = _st


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips where there is none")


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)
