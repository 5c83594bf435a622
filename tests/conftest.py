"""Shared test harness knobs: the quick lane and the ``slow`` marker.

The tier-1 suite is jit-compile bound (>7 minutes full length).  Two levers
keep iteration fast without losing coverage:

  * ``REPRO_TEST_TICKS=<n>`` caps the simulated horizon of the heavy engine
    tests that are robust to shrinking: they scale their sim duration *and*
    measurement windows by :func:`quick_scale`.  Unset means full length.
  * ``@pytest.mark.slow`` marks tests whose assertions need the full
    horizon (tight fairness ratios, λ-sync timing, exhaustive sweep
    bit-identity).  The quick lane runs ``-m "not slow"``; CI runs both
    lanes, so the full-length tests still gate every commit.

Quick lane, locally::

    REPRO_TEST_TICKS=2000 PYTHONPATH=src python -m pytest -q -m "not slow"
"""
import os

QUICK_TICKS = int(os.environ.get("REPRO_TEST_TICKS", "0"))

#: Engine tick length the heavy tests assume when converting REPRO_TEST_TICKS
#: (the engine default; tests overriding dt do their own math).
DT = 1e-3


def quick_scale(full_seconds: float) -> float:
    """Factor the heavy engine tests multiply sim durations and measurement
    windows by.  1.0 when REPRO_TEST_TICKS is unset or already satisfied."""
    if QUICK_TICKS <= 0:
        return 1.0
    return min(1.0, QUICK_TICKS * DT / full_seconds)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: full-length engine runs; excluded from the quick lane "
        "(-m 'not slow'), still run by the CI full lane")
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card (the PyTorch port's kernels); skipped "
        "without one")
