"""Deterministic sharded data pipeline with burst-buffer-backed shard reads.

The port's own copy of ``repro.data.pipeline`` (numpy only; the port
imports nothing of the reference).  A synthetic corpus (a zipf-distributed
token stream from a fixed PRNG) is written once as fixed-size shards,
optionally through the port's ``BBClient`` so that data I/O competes
under the cluster's sharing policy like any other job.  The loader is:
  * deterministic and *checkpointable*: its state is (epoch, shard_idx,
    offset), saved with the model checkpoint, so a restore resumes the
    exact batch stream (bit-identical training after a restart).
  * host-sharded: each data-parallel rank reads a disjoint shard slice.
  * double-buffered: the next shard is fetched while the current one is
    consumed.
Batches are numpy ``int32``, bit for bit the reference's; the train step
moves them to the device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab: int
    seq_len: int
    batch_size: int            # per-host
    shard_tokens: int = 1 << 16
    n_shards: int = 8
    seed: int = 1234


@dataclasses.dataclass
class LoaderState:
    epoch: int = 0
    shard_idx: int = 0
    offset: int = 0            # tokens consumed within shard


def _shard_tokens(cfg: DataConfig, epoch: int, shard: int) -> np.ndarray:
    rng = np.random.default_rng(cfg.seed + epoch * 1_000_003 + shard)
    # zipf-ish over the vocab, clipped — cheap stand-in for natural text
    z = rng.zipf(1.3, size=cfg.shard_tokens)
    return (z % cfg.vocab).astype(np.int32)


class ShardWriter:
    """Materialize the synthetic corpus into a filesystem (BB or local)."""

    def __init__(self, cfg: DataConfig, client=None, root: str = "/data"):
        self.cfg = cfg
        self.client = client
        self.root = root

    def write_epoch(self, epoch: int):
        if self.client is None:
            return  # generated on the fly
        try:
            self.client.mkdir(self.root)
        except Exception:
            pass
        for s in range(self.cfg.n_shards):
            tokens = _shard_tokens(self.cfg, epoch, s)
            with self.client.open(f"{self.root}/e{epoch}_s{s}.bin", "w") as f:
                f.write(tokens.tobytes())


class DataLoader:
    def __init__(self, cfg: DataConfig, *, rank: int = 0, world: int = 1,
                 client=None, root: str = "/data",
                 state: Optional[LoaderState] = None):
        assert cfg.n_shards % world == 0, "shards must split over hosts"
        self.cfg = cfg
        self.rank = rank
        self.world = world
        self.client = client
        self.root = root
        self.state = state or LoaderState(shard_idx=rank)
        self._cur: Optional[np.ndarray] = None
        self._next: Optional[np.ndarray] = None

    def _my_shards(self, epoch: int) -> list[int]:
        return list(range(self.rank, self.cfg.n_shards, self.world))

    def _fetch(self, epoch: int, shard: int) -> np.ndarray:
        if self.client is None:
            return _shard_tokens(self.cfg, epoch, shard)
        with self.client.open(f"{self.root}/e{epoch}_s{shard}.bin") as f:
            return np.frombuffer(f.read(), dtype=np.int32).copy()

    def _ensure(self):
        if self._cur is None:
            self._cur = self._fetch(self.state.epoch, self.state.shard_idx)
            nxt = self._peek_next()
            self._next = None if nxt is None else self._fetch(*nxt)

    def _peek_next(self):
        shards = self._my_shards(self.state.epoch)
        i = shards.index(self.state.shard_idx)
        if i + 1 < len(shards):
            return self.state.epoch, shards[i + 1]
        return self.state.epoch + 1, self._my_shards(self.state.epoch + 1)[0]

    def next_batch(self) -> dict:
        """Returns {"tokens": [B,S], "labels": [B,S]} int32 (next-token)."""
        cfg = self.cfg
        need = cfg.batch_size * (cfg.seq_len + 1)
        self._ensure()
        while len(self._cur) - self.state.offset < need:
            # advance to next shard (double buffer swap)
            ep, sh = self._peek_next()
            self._cur = self._next if self._next is not None else self._fetch(ep, sh)
            self.state = LoaderState(epoch=ep, shard_idx=sh, offset=0)
            nxt = self._peek_next()
            self._next = self._fetch(*nxt) if nxt else None
        o = self.state.offset
        chunk = self._cur[o:o + need].reshape(cfg.batch_size, cfg.seq_len + 1)
        self.state.offset += need
        return {"tokens": chunk[:, :-1].copy(), "labels": chunk[:, 1:].copy()}

    # checkpointing
    def state_dict(self) -> dict:
        return dataclasses.asdict(self.state)

    def load_state(self, d: dict):
        self.state = LoaderState(**d)
        self._cur = None
        self._next = None
