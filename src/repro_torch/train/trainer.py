"""Training driver: checkpoint/restart, heartbeats, straggler detection.

The port of ``repro.train.trainer``:
  * the trainer heartbeats to the burst-buffer job monitor (paper §4.1), the
    mechanism the I/O plane uses to expire dead jobs; a supervisor
    (:func:`run_with_restarts`) restarts from the latest committed
    checkpoint.
  * checkpoints are atomic (two-phase commit in ``ckpt.manager``) and hold
    the data loader's state, so a restart resumes the exact batch stream
    and is bit-identical to an uninterrupted run.
  * straggler mitigation: per-step host timings feed an EWMA detector; the
    hook is called on a straggling step.
The trainer runs on the card unless the caller asks for the CPU.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np

from .._device import resolve_device
from ..ckpt.manager import CheckpointManager
from ..data.pipeline import DataLoader
from . import optimizer as O
from .train_step import TrainState, init_state, make_train_step


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    log_every: int = 10
    seed: int = 0
    straggler_factor: float = 3.0   # step > factor * EWMA -> straggler
    ewma: float = 0.9


class StragglerDetector:
    def __init__(self, factor: float, ewma: float):
        self.factor = factor
        self.alpha = ewma
        self.mean: Optional[float] = None
        self.events: list[tuple[int, float]] = []

    def observe(self, step: int, dt: float) -> bool:
        if self.mean is None:
            self.mean = dt
            return False
        is_straggler = dt > self.factor * self.mean
        if is_straggler:
            self.events.append((step, dt))
        else:
            self.mean = self.alpha * self.mean + (1 - self.alpha) * dt
        return is_straggler


class Trainer:
    def __init__(self, cfg, opt_cfg: O.OptConfig, tcfg: TrainerConfig,
                 loader: DataLoader, ckpt: Optional[CheckpointManager] = None,
                 bb_client=None,
                 on_straggler: Optional[Callable[[int, float], None]] = None,
                 device="cuda"):
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.tcfg = tcfg
        self.loader = loader
        self.ckpt = ckpt
        self.bb_client = bb_client
        self.device = resolve_device(device)
        self.detector = StragglerDetector(tcfg.straggler_factor, tcfg.ewma)
        self.on_straggler = on_straggler
        self.step_fn = make_train_step(cfg, opt_cfg)
        self.state: Optional[TrainState] = None
        self.start_step = 0
        self.history: list[dict] = []

    def init_or_restore(self):
        self.state = init_state(self.cfg, self.tcfg.seed, self.device)
        if self.ckpt is not None:
            latest = self.ckpt.latest_step()
            if latest is not None:
                payload = {"state": self.state,
                           "loader": _loader_placeholder(self.loader)}
                restored, step = self.ckpt.restore(payload)
                self.state = restored["state"]
                self.loader.load_state(
                    {k: int(v) for k, v in zip(
                        ("epoch", "shard_idx", "offset"),
                        np.asarray(restored["loader"]["state"]))})
                self.start_step = step
        return self.start_step

    def _save(self, step: int):
        if self.ckpt is None:
            return
        payload = {"state": self.state,
                   "loader": _loader_placeholder(self.loader)}
        self.ckpt.save(step, payload)

    def run(self, steps: Optional[int] = None,
            die_at: Optional[int] = None) -> list[dict]:
        """Run to the absolute step count; ``die_at`` simulates a node
        failure at that step (test hook).  Raises RuntimeError("node
        failure"): a supervisor catches it, constructs a fresh Trainer and
        resumes from the checkpoint (run_with_restarts)."""
        assert self.state is not None, "call init_or_restore() first"
        end = steps if steps is not None else self.tcfg.total_steps
        for step in range(self.start_step, end):
            if self.bb_client is not None:
                self.bb_client.heartbeat(float(step))
            batch = self.loader.next_batch()
            t0 = time.perf_counter()
            self.state, metrics = self.step_fn(self.state, batch)
            loss = float(metrics["loss"])     # waits for the device
            dt = time.perf_counter() - t0
            if self.detector.observe(step, dt) and self.on_straggler:
                self.on_straggler(step, dt)
            self.history.append({"step": step, "loss": loss, "dt": dt})
            if (step + 1) % self.tcfg.ckpt_every == 0:
                self._save(step + 1)
            if die_at is not None and step + 1 == die_at:
                raise RuntimeError("node failure (injected)")
        return self.history


def _loader_placeholder(loader: DataLoader) -> dict:
    st = loader.state_dict()
    return {"state": np.asarray([st["epoch"], st["shard_idx"], st["offset"]],
                                np.int64)}


def run_with_restarts(make_trainer: Callable[[], Trainer],
                      max_restarts: int = 3, **run_kw) -> list[dict]:
    """Supervisor loop: restart from the latest checkpoint on failure."""
    history: list[dict] = []
    for attempt in range(max_restarts + 1):
        tr = make_trainer()
        tr.init_or_restore()
        try:
            history += tr.run(**run_kw)
            return history
        except RuntimeError:
            run_kw.pop("die_at", None)  # fail only once in tests
            continue
    raise RuntimeError("too many restarts")
