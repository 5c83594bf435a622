"""The named scenario library, expressed as combinator trees.

Each preset is a :class:`~repro_torch.scenario.ir.ScenarioNode` built from
small fragments — the checkpoint loop is a ``repeat``, the staggered
second app is a ``shift`` of the same loop, the bursty interferer's idle
middle third is two ``mask`` windows over one steady job merged by
``overlay``.  The trees lower bit-identically (at the ``[J, P]`` array
level) to the flat job-dict presets they replaced — pinned by
``tests/data/lowering_pins.json``.

Every call builds fresh trees and fresh :class:`Scenario` objects, and
tree expansion materializes new job/phase dicts, so callers can mutate a
preset's jobs (at any depth) without poisoning the library.
"""
from __future__ import annotations

from .base import Scenario
from .ir import ScenarioNode, leaf, mask, overlay, repeat, shift

#: Horizon the presets are shaped for (phase windows are fractions of it);
#: run them at this ``seconds`` — or scale, they only pin the *shape*.
PRESET_SECONDS = 24.0


def _preset_trees() -> dict[str, ScenarioNode]:
    t = PRESET_SECONDS
    period = t / 6
    # WRF-style: an app checkpoints 40% of each period; the second app is
    # the same loop staggered a half-period; a steady background writer.
    ckpt = lambda user, n: repeat(  # noqa: E731
        leaf(dict(user=user, size=4, procs=64, req_mb=8,
                  phases=[dict(start_s=0.0, duration_s=0.4 * period)])),
        n, period_s=period)
    steady = lambda user, procs, req_mb, **kw: leaf(  # noqa: E731
        dict(user=user, procs=procs, req_mb=req_mb, end_s=t, **kw))
    burster = steady(1, 224, 10, size=1)
    return {
        "checkpoint-heavy": overlay(
            ckpt(0, 6),
            shift(ckpt(1, 5), 0.5 * period),
            steady(9, 112, 10, size=1)),
        # training-ingest readers: steady open-loop prefetch at a fixed
        # request rate per rank, small requests, against one bulk writer.
        "ml-ingest": overlay(
            steady(0, 112, 1, size=2, arrival="interval", interval_s=0.02),
            steady(1, 112, 1, size=2, arrival="interval", interval_s=0.02),
            steady(2, 56, 16, size=1)),
        # post-hoc analytics: one wide closed-loop scan of large requests
        # plus a latency-sensitive small-request interactive user.
        "analytics-scan": overlay(
            steady(0, 448, 64, size=8),
            steady(1, 28, 1, size=1, arrival="interval", interval_s=0.05)),
        # the Fig. 12 antagonist: a steady victim app vs a heavy burster
        # that goes idle in the middle third (opportunity-fairness probe):
        # two masks over ONE steady job — overlay merges them back into a
        # single two-phase job because the identity is the same.
        "bursty-interferer": overlay(
            steady(0, 56, 10, size=1),
            mask(burster, end_s=t / 3) | mask(burster, start_s=2 * t / 3,
                                              end_s=t)),
    }


def presets() -> dict[str, Scenario]:
    """The named scenario library — fresh, validated :class:`Scenario`
    copies on every call (mutating one never corrupts the library).  Use
    with ``Experiment.from_scenario(preset("ml-ingest"), ...)`` or sweep
    them in :mod:`repro_torch.bench.scenarios`."""
    return {name: Scenario(tree=tree, name=name)
            for name, tree in _preset_trees().items()}


def preset(name: str) -> Scenario:
    """One preset by name; unknown names list the library."""
    lib = _preset_trees()
    if name not in lib:
        raise KeyError(
            f"unknown preset {name!r}; available: {sorted(lib)}")
    return Scenario(tree=lib[name], name=name)
