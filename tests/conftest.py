"""Shared fixtures.  NOTE: no XLA_FLAGS here — tests run on the single real
CPU device (the 512-device override belongs to launch/dryrun.py only).

Also hosts the ``hypothesis`` fallback: clean containers don't ship
hypothesis, and a hard module-level import would error the WHOLE test module
at collection.  Test modules import ``given / settings / st`` from here; when
hypothesis is missing they degrade to a deterministic mini property-runner
(bounded cross-product of strategy samples) so every non-property test — and
a fixed-sample version of each property test — still runs.
"""

import itertools

import jax
import pytest


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)


try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False
    _MAX_COMBOS = 12

    class _Strategy:
        def __init__(self, samples):
            self.samples = list(samples)

    class st:  # noqa: N801 — mirrors `strategies as st`
        @staticmethod
        def integers(min_value, max_value):
            span = max_value - min_value
            vals = [min_value, max_value,
                    min_value + span // 3,
                    min_value + (2 * span) // 3,
                    min_value + span // 7]
            return _Strategy(dict.fromkeys(vals))

        @staticmethod
        def sampled_from(seq):
            return _Strategy(seq)

        @staticmethod
        def floats(min_value, max_value):
            mid = 0.5 * (min_value + max_value)
            return _Strategy(dict.fromkeys([min_value, mid, max_value]))

        @staticmethod
        def booleans():
            return _Strategy([False, True])

    def given(*strategies):
        def deco(fn):
            combos = list(itertools.product(*(s.samples for s in strategies)))
            # ceil stride so the kept combos span the whole cross-product
            # (a floor stride would only ever run the head of it).
            stride = -(-len(combos) // _MAX_COMBOS)
            combos = combos[::stride][:_MAX_COMBOS]

            def runner():
                for combo in combos:
                    fn(*combo)

            runner.__name__ = fn.__name__
            runner.__doc__ = fn.__doc__
            return runner
        return deco

    def settings(**_kwargs):
        return lambda fn: fn


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card (PyTorch port kernels); skipped without "
        "one")
