"""The port's workspace: a buffered, resumable experiment data space, the
reference's ``repro.workspace`` module for module (pure Python and numpy).

* :mod:`.store`: content-addressed run records, atomic writes, one
  JSON-lines journal per campaign, bit-identical ndarray round-trips; the
  same keys, hashes and bytes as the reference, so a directory written by
  either package reads back in the other;
* :mod:`.buffer`: a context-managed write buffer that coalesces flushes
  (mtime/size integrity checked, discarded on an exception);
* :mod:`.campaign`: resumable sweeps (:func:`run_sweep`) and cached runs
  (:func:`run_cached`) over the port's engine.

Entry points: ``Experiment.sweep(..., workspace=...)`` and
``Experiment.solo(..., workspace=...)``.
"""
from .buffer import WriteBuffer
from .campaign import CampaignInterrupted, run_cached, run_sweep, spec_hash
from .store import (RunKey, RunRecord, WorkspaceConflictError,
                    WorkspaceStore, atomic_write_json, atomic_write_text,
                    canonical_json, content_hash, decode_payload,
                    encode_payload, env_fingerprint)

__all__ = [
    "WorkspaceStore", "RunKey", "RunRecord", "WriteBuffer",
    "WorkspaceConflictError", "CampaignInterrupted",
    "run_sweep", "run_cached", "spec_hash",
    "atomic_write_json", "atomic_write_text", "canonical_json",
    "content_hash", "encode_payload", "decode_payload", "env_fingerprint",
]
