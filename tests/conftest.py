"""Shared test setup: put ``src/`` on ``sys.path`` and install a tiny
deterministic ``hypothesis`` fallback when the real package is missing.

Four test modules import ``hypothesis`` at module scope; in offline
environments without the package that used to abort *collection* of the
whole suite.  The shim keeps the property tests runnable everywhere: each
``@given`` test is executed ``max_examples`` times with values drawn from
a ``random.Random`` seeded by the test's qualified name, so runs are
reproducible (no shrinking, no database — it is a fallback, not a
replacement; the real package wins whenever it is importable).
"""
import functools
import inspect
import os
import random
import sys
import types

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

try:
    import hypothesis  # noqa: F401
except ImportError:

    class _Strategy:
        def __init__(self, draw):
            self._draw = draw

        def draw(self, rng):
            return self._draw(rng)

    def _integers(min_value, max_value):
        return _Strategy(lambda rng: rng.randint(min_value, max_value))

    def _booleans():
        return _Strategy(lambda rng: rng.random() < 0.5)

    def _sampled_from(elements):
        elems = list(elements)
        return _Strategy(lambda rng: elems[rng.randrange(len(elems))])

    def _floats(min_value=0.0, max_value=1.0, **_kw):
        return _Strategy(lambda rng: rng.uniform(min_value, max_value))

    class _HealthCheckMeta(type):
        def __iter__(cls):  # list(HealthCheck) -> [] (nothing to suppress)
            return iter(())

    class _HealthCheck(metaclass=_HealthCheckMeta):
        pass

    def _settings(**kwargs):
        def deco(fn):
            fn._shim_max_examples = kwargs.get("max_examples", 10)
            return fn
        return deco

    def _given(**strategies):
        def deco(fn):
            @functools.wraps(fn)
            def wrapper(*args, **kwargs):
                n = getattr(wrapper, "_shim_max_examples", 10)
                rng = random.Random(f"{fn.__module__}.{fn.__qualname__}")
                for _ in range(n):
                    drawn = {k: s.draw(rng) for k, s in strategies.items()}
                    fn(*args, **kwargs, **drawn)
            # hide the drawn parameters from pytest's fixture resolution
            # (functools.wraps exposes the original signature otherwise)
            del wrapper.__wrapped__
            params = [p for name, p in
                      inspect.signature(fn).parameters.items()
                      if name not in strategies]
            wrapper.__signature__ = inspect.Signature(params)
            return wrapper
        return deco

    _st = types.ModuleType("hypothesis.strategies")
    _st.integers = _integers
    _st.booleans = _booleans
    _st.sampled_from = _sampled_from
    _st.floats = _floats

    _hyp = types.ModuleType("hypothesis")
    _hyp.HealthCheck = _HealthCheck
    _hyp.given = _given
    _hyp.settings = _settings
    _hyp.strategies = _st
    _hyp.__is_shim__ = True

    sys.modules["hypothesis"] = _hyp
    sys.modules["hypothesis.strategies"] = _st


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA GPU; skips itself without one")
