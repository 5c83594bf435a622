"""Scenarios for the port: the reference's scenario layer, module for module.

- :mod:`repro_torch.scenario.lowering` — the canonical pipeline (job-spec
  vocabulary, ``normalize_phases``, ``lower()`` -> ``[J, P]`` arrays); the
  engine and the service plane are its consumers.
- :mod:`repro_torch.scenario.ir` — the combinator algebra (``leaf`` /
  ``repeat`` / ``concat`` / ``overlay`` / ``shift`` / ``scale`` / ``mask``
  / ``mix``) over :class:`ScenarioNode` trees.
- :mod:`repro_torch.scenario.base` — the serializable :class:`Scenario`
  (JSON v1 job lists, v2 combinator trees, trace ingestion).
- :mod:`repro_torch.scenario.presets` — the named library, as combinator
  trees.

Pure Python and numpy: the same trees, JSON text and arrays as the
reference's.
"""
from .base import SCENARIO_VERSION, Scenario
from .ir import (NODE_OPS, ScenarioNode, concat, leaf, mask, mix,
                 node_from_doc, node_to_doc, overlay, repeat, scale, shift,
                 to_jobs)
from .lowering import (ARRIVAL_MODES, JOB_SPEC_KEYS, PHASE_SPEC_KEYS,
                       LoweredScenario, lower, lower_for_config,
                       normalize_phases, validate_job_spec)
from .presets import PRESET_SECONDS, preset, presets
from .trace import TRACE_FIELDS, parse_trace

__all__ = [
    "ARRIVAL_MODES", "JOB_SPEC_KEYS", "LoweredScenario", "NODE_OPS",
    "PHASE_SPEC_KEYS", "PRESET_SECONDS", "SCENARIO_VERSION", "Scenario",
    "ScenarioNode", "TRACE_FIELDS", "concat", "leaf", "lower",
    "lower_for_config", "mask", "mix", "node_from_doc", "node_to_doc",
    "normalize_phases", "overlay", "parse_trace", "preset", "presets",
    "repeat", "scale", "shift", "to_jobs", "validate_job_spec",
]
