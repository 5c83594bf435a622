"""Scheduler-owned parameter schemas, as plain frozen dataclasses.

The class names and fields are the reference's (``repro.core.params``), so
``params_hash`` stamps the same hash for the same schema.  Only the schemas
of the ported schedulers (``themis``, ``fifo``) exist here.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import List


@dataclasses.dataclass(frozen=True)
class SchedulerParams:
    """Base schema: no knobs."""

    @classmethod
    def numeric_fields(cls) -> List[str]:
        return [f.name for f in dataclasses.fields(cls)]

    @classmethod
    def resolve(cls, cfg) -> "SchedulerParams":
        """Explicit ``cfg.scheduler_params`` wins; else the schema defaults.
        The type check is exact, as in the reference."""
        p = getattr(cfg, "scheduler_params", None)
        if p is None:
            return cls()
        if type(p) is not cls:
            raise TypeError(
                f"scheduler_params is {type(p).__name__}, but the configured "
                f"scheduler expects exactly {cls.__name__}")
        return p

    def params_hash(self) -> str:
        """Stable short hash of (schema type, every field value)."""
        doc = {"schema": type(self).__name__}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            doc[f.name] = v.item() if hasattr(v, "item") else v
        blob = json.dumps(doc, sort_keys=True, default=repr).encode()
        return hashlib.sha256(blob).hexdigest()[:12]


@dataclasses.dataclass(frozen=True)
class ThemisParams(SchedulerParams):
    """Statistical tokens have no per-scheduler tunables."""


@dataclasses.dataclass(frozen=True)
class FifoParams(SchedulerParams):
    """Arrival order needs no knobs."""
