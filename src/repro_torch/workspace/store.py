"""Content-addressed experiment record store (the workspace's bottom layer),
the port's copy of the reference's ``repro.workspace.store``: the same keys,
hashes and bytes on disk, so a directory written by either package reads
back in the other.

A :class:`WorkspaceStore` is a directory-backed data space for run records —
the signac idea (a queryable store of parameter-keyed results) shrunk to the
two shapes this repo produces: swept grid points and benchmark rows.  Every
record is keyed on the five coordinates that make a number comparable:

    (section, name,  scheduler, params_hash, scenario_hash, env)
     └── what was measured ──┘  └────── exact configuration ──────┘

``params_hash`` is the scheduler-schema hash (:mod:`repro_torch.core.params`),
``scenario_hash`` the canonical hash of the workload spec + horizon, and
``env`` the ``BENCH_*`` shrink fingerprint (the same convention the trend
gate keys its series on) — so a CI smoke record can never shadow a
full-length local one.  The key's content hash is the record's address.

On-disk layout (everything human-readable JSON)::

    root/
      workspace.json          # format marker + version
      records/<h2>/<hash>.json  # loose records: one atomic file per put()
      campaigns/<name>.jsonl    # journals: one appended line per record

Two write paths share one invariant — a reader never observes a torn
record:

  * **loose puts** go through :func:`atomic_write_text` (write a temp file
    in the same directory, fsync, ``os.replace``), so a crash mid-write
    leaves at most an orphaned ``*.tmp-*`` file, never a half record;
  * **journal appends** write whole lines and fsync; a crash mid-append can
    leave one torn *final* line, which the reader skips with a warning —
    every earlier record stays intact (this is what makes campaign resume
    after ``SIGKILL`` safe).

When one key appears multiple times (a re-run, a journal compacted later),
the *last* occurrence wins, with loose records taking precedence over
journal lines (an explicit ``put`` is always the newest statement).

ndarrays round-trip **bit-identically**: they are serialized as base64 of
the raw buffer plus dtype/shape (``{"__ndarray__": ...}``), not as decimal
floats — the campaign layer's bit-identical-resume contract rests on this.

In a ``torch.distributed`` world only rank 0 writes (the marker here, the
records in :mod:`.campaign`); the other ranks read what it wrote.
"""
from __future__ import annotations

import base64
import dataclasses
import hashlib
import json
import os
import sys
import tempfile
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

from ..core.shard import is_writer

WORKSPACE_VERSION = 1

#: Environment knobs that change what a measurement means; folded into the
#: record key the same way benchmarks/trend.py folds them into series keys.
_ENV_PREFIX = "BENCH_"


class WorkspaceConflictError(RuntimeError):
    """A buffered flush found the journal changed under it (another writer
    appended since the buffer opened) — the signac mtime-integrity check."""


# -- canonical JSON + hashing -------------------------------------------------

def canonical_json(obj) -> str:
    """Deterministic JSON: sorted keys, no whitespace — the hashing form."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def content_hash(obj) -> str:
    """16-hex-char blake2b of an object's canonical JSON."""
    return hashlib.blake2b(canonical_json(obj).encode(),
                           digest_size=8).hexdigest()


def env_fingerprint() -> str:
    """The ``BENCH_*`` shrink fingerprint, trend-style: ``s=5/k=2/...`` —
    records produced under CI smoke shrink never collide with full runs."""
    env = os.environ
    key = (f"s={env.get('BENCH_SECONDS', 'full')}"
           f"/k={env.get('BENCH_SEEDS', 'full')}")
    extra = sorted(f"{k.removeprefix(_ENV_PREFIX).lower()}={env[k]}"
                   for k in env if k.startswith(_ENV_PREFIX)
                   and k not in ("BENCH_SECONDS", "BENCH_SEEDS"))
    return key + ("/" + "/".join(extra) if extra else "")


# -- bit-identical ndarray <-> JSON codec -------------------------------------

def encode_payload(obj):
    """JSON-safe deep copy; ndarrays become base64 raw-buffer envelopes."""
    if isinstance(obj, np.ndarray):
        buf = np.ascontiguousarray(obj)
        return {"__ndarray__": {
            "dtype": str(buf.dtype), "shape": list(buf.shape),
            "data": base64.b64encode(buf.tobytes()).decode("ascii")}}
    if isinstance(obj, np.generic):          # numpy scalar: keep exact bits
        return encode_payload(np.asarray(obj))
    if isinstance(obj, dict):
        return {str(k): encode_payload(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [encode_payload(v) for v in obj]
    return obj


def decode_payload(obj):
    """Inverse of :func:`encode_payload` (bit-identical arrays back)."""
    if isinstance(obj, dict):
        if set(obj) == {"__ndarray__"}:
            nd = obj["__ndarray__"]
            arr = np.frombuffer(base64.b64decode(nd["data"]),
                                dtype=np.dtype(nd["dtype"]))
            return arr.reshape(nd["shape"]).copy()
        return {k: decode_payload(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [decode_payload(v) for v in obj]
    return obj


# -- atomic persistence helpers ----------------------------------------------

def atomic_write_text(path, text: str) -> None:
    """Write-temp-then-rename: readers see the old file or the new file,
    never a truncated one.  The temp file lives in the target directory so
    ``os.replace`` stays on one filesystem."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=str(path.parent),
                               prefix=path.name + ".tmp-")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_write_json(path, obj, indent: Optional[int] = 2) -> None:
    """Atomic JSON dump (an interrupted writer leaves the old file or the
    new one, never a truncated one)."""
    atomic_write_text(path, json.dumps(obj, indent=indent) + "\n")


# -- records ------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RunKey:
    """The five comparability coordinates of one stored result."""

    section: str            # "sweep", "run", or a bench section ("fig12")
    name: str               # row / campaign-point name
    scheduler: str = ""
    params_hash: str = ""
    scenario_hash: str = ""
    env: str = ""

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @property
    def key_hash(self) -> str:
        """Content address: the record's filename / identity."""
        return content_hash(self.to_dict())

    @classmethod
    def from_dict(cls, doc: dict) -> "RunKey":
        return cls(**{f.name: doc.get(f.name, "")
                      for f in dataclasses.fields(cls)})


@dataclasses.dataclass(frozen=True)
class RunRecord:
    """One content-addressed result: a key plus an arbitrary JSON/ndarray
    payload (decoded — arrays are real ``np.ndarray``\\ s)."""

    key: RunKey
    payload: dict

    def to_doc(self) -> dict:
        return {"key": self.key.to_dict(),
                "payload": encode_payload(self.payload)}

    @classmethod
    def from_doc(cls, doc: dict) -> "RunRecord":
        return cls(key=RunKey.from_dict(doc["key"]),
                   payload=decode_payload(doc.get("payload", {})))


class WorkspaceStore:
    """Directory-backed record store with loose files + per-campaign
    journals.  ``io_writes`` counts filesystem write operations (atomic
    writes and journal appends) — the observable the buffered layer's O(1)
    claim is tested against."""

    def __init__(self, root):
        self.root = Path(root)
        self.records_dir = self.root / "records"
        self.campaigns_dir = self.root / "campaigns"
        self.io_writes = 0
        marker = self.root / "workspace.json"
        if not marker.exists() and is_writer():
            self.root.mkdir(parents=True, exist_ok=True)
            # The reference's marker: one on-disk format for both packages.
            atomic_write_json(marker, {"format": "repro.workspace",
                                       "version": WORKSPACE_VERSION})
        elif marker.exists():
            doc = json.loads(marker.read_text())
            if doc.get("version", 0) > WORKSPACE_VERSION:
                raise ValueError(
                    f"workspace {self.root} has version {doc.get('version')}"
                    f" newer than this reader (supports"
                    f" <= {WORKSPACE_VERSION})")
        self._index: Optional[dict[str, RunRecord]] = None

    # -- index ----------------------------------------------------------------
    def _journal_records(self, path: Path) -> Iterator[RunRecord]:
        """Parse one journal; a torn final line (crash mid-append) is
        skipped with a warning, never a hard failure."""
        lines = path.read_text().splitlines()
        for i, line in enumerate(lines):
            if not line.strip():
                continue
            try:
                yield RunRecord.from_doc(json.loads(line))
            except (json.JSONDecodeError, KeyError, TypeError, ValueError):
                tail = " (torn final line)" if i == len(lines) - 1 else ""
                print(f"workspace: skipping malformed record at "
                      f"{path.name}:{i + 1}{tail}", file=sys.stderr)

    def _build_index(self) -> dict[str, RunRecord]:
        index: dict[str, RunRecord] = {}
        # journals first, loose records after: an explicit put() wins
        if self.campaigns_dir.is_dir():
            for journal in sorted(self.campaigns_dir.glob("*.jsonl")):
                for rec in self._journal_records(journal):
                    index[rec.key.key_hash] = rec
        if self.records_dir.is_dir():
            for f in sorted(self.records_dir.glob("*/*.json")):
                try:
                    rec = RunRecord.from_doc(json.loads(f.read_text()))
                except (json.JSONDecodeError, KeyError, TypeError, ValueError):
                    print(f"workspace: skipping corrupt record {f.name}",
                          file=sys.stderr)
                    continue
                index[rec.key.key_hash] = rec
        return index

    def _ensure_index(self) -> dict[str, RunRecord]:
        if self._index is None:
            self._index = self._build_index()
        return self._index

    def refresh(self) -> None:
        """Drop the in-memory index (another process may have written)."""
        self._index = None

    # -- write paths ----------------------------------------------------------
    def _loose_path(self, key: RunKey) -> Path:
        h = key.key_hash
        return self.records_dir / h[:2] / f"{h}.json"

    def put(self, record: RunRecord) -> RunKey:
        """Unbuffered single-record write: one atomic loose file."""
        atomic_write_text(self._loose_path(record.key),
                          canonical_json(record.to_doc()) + "\n")
        self.io_writes += 1
        self._ensure_index()[record.key.key_hash] = record
        return record.key

    def journal_path(self, campaign: str) -> Path:
        if not campaign or "/" in campaign or campaign.startswith("."):
            raise ValueError(f"bad campaign name {campaign!r}")
        return self.campaigns_dir / f"{campaign}.jsonl"

    def journal_append(self, campaign: str, records: list[RunRecord]) -> None:
        """One append (one filesystem write) for any number of records —
        the coalesced flush the buffering layer counts on."""
        if not records:
            return
        path = self.journal_path(campaign)
        path.parent.mkdir(parents=True, exist_ok=True)
        blob = "".join(canonical_json(r.to_doc()) + "\n" for r in records)
        with open(path, "a") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        self.io_writes += 1
        index = self._ensure_index()
        for rec in records:
            index[rec.key.key_hash] = rec

    def buffered(self, campaign: str = "default"):
        """Context-managed write buffer (see :mod:`.buffer`): ``put`` calls
        inside defer and coalesce into one journal append."""
        from .buffer import WriteBuffer
        return WriteBuffer(self, campaign)

    # -- read paths -----------------------------------------------------------
    def get(self, key: RunKey) -> Optional[RunRecord]:
        return self._ensure_index().get(key.key_hash)

    def __contains__(self, key: RunKey) -> bool:
        return key.key_hash in self._ensure_index()

    def __len__(self) -> int:
        return len(self._ensure_index())

    def records(self) -> list[RunRecord]:
        return list(self._ensure_index().values())

    def query(self, *, section: Optional[str] = None,
              scheduler: Optional[str] = None,
              name: Optional[str] = None,
              scenario_hash: Optional[str] = None,
              env: Optional[str] = None) -> list[RunRecord]:
        """Records whose key matches every given filter (``name`` is a
        substring match; the rest are exact)."""
        out = []
        for rec in self._ensure_index().values():
            k = rec.key
            if section is not None and k.section != section:
                continue
            if scheduler is not None and k.scheduler != scheduler:
                continue
            if name is not None and name not in k.name:
                continue
            if scenario_hash is not None and k.scenario_hash != scenario_hash:
                continue
            if env is not None and k.env != env:
                continue
            out.append(rec)
        return out

    # -- maintenance ----------------------------------------------------------
    def campaigns(self) -> dict[str, int]:
        """Campaign name -> distinct record count in its journal."""
        out = {}
        if self.campaigns_dir.is_dir():
            for journal in sorted(self.campaigns_dir.glob("*.jsonl")):
                keys = {r.key.key_hash for r in self._journal_records(journal)}
                out[journal.stem] = len(keys)
        return out

    def loose_count(self) -> int:
        if not self.records_dir.is_dir():
            return 0
        return sum(1 for _ in self.records_dir.glob("*/*.json"))

    def drop_campaign(self, campaign: str) -> bool:
        path = self.journal_path(campaign)
        if path.exists():
            path.unlink()
            self.refresh()
            return True
        return False

    def gc(self) -> dict:
        """Compact the store: delete orphaned ``*.tmp-*`` files (crashed
        atomic writes) and rewrite journals keeping only the last line per
        key.  Returns ``{"tmp_removed", "journal_lines_dropped"}``."""
        tmp_removed = 0
        for tmp in self.root.rglob("*.tmp-*"):
            tmp.unlink()
            tmp_removed += 1
        dropped = 0
        if self.campaigns_dir.is_dir():
            for journal in sorted(self.campaigns_dir.glob("*.jsonl")):
                recs = list(self._journal_records(journal))
                last: dict[str, RunRecord] = {}
                for rec in recs:
                    last[rec.key.key_hash] = rec
                if len(last) < len(recs):
                    dropped += len(recs) - len(last)
                    atomic_write_text(
                        journal,
                        "".join(canonical_json(r.to_doc()) + "\n"
                                for r in last.values()))
                    self.io_writes += 1
        self.refresh()
        return {"tmp_removed": tmp_removed,
                "journal_lines_dropped": dropped}
