"""The port's batch plane: HPC batch scheduling with burst-buffer
reservations, the reference's ``repro.batch`` module for module.

Upstream of the serving planes: a queue of jobs carrying (nodes, walltime,
burst-buffer reservation) demands, a cluster reusing the engine's server
geometry, and three admission policies — FCFS, EASY backfilling and
Kopanski & Rzadca's plan-based scheduling with simulated annealing — on
the waiting-time and bounded-slowdown objectives.  The list schedule and
the annealer are plain PyTorch on the queue's device (``device="cuda"`` by
default) and equal the reference's bit for bit on the CPU; the bridge
lowers an admitted timeline into :mod:`repro_torch.scenario` and runs it on
the port's engine.
"""
from ..core.params import PlanOptParams
from .api import BATCH_POLICIES, BatchExperiment, BatchResult
from .bridge import DEFAULT_HORIZON_S, timeline_to_tree, to_experiment, to_scenario
from .campaign import batch_point_key, run_batch_campaign
from .plan import plan_schedule
from .queue import (BatchJob, BatchQueue, ClusterSpec, make_queue, queue_preset,
                    queue_presets)
from .sim import (BSLD_TAU_S, schedule_order, simulate_easy, simulate_fcfs,
                  validate_schedule, wait_metrics)

__all__ = [
    "BatchExperiment", "BatchResult", "BatchJob", "BatchQueue",
    "ClusterSpec", "PlanOptParams", "BATCH_POLICIES", "BSLD_TAU_S",
    "DEFAULT_HORIZON_S",
    "make_queue", "queue_preset", "queue_presets",
    "schedule_order", "simulate_fcfs", "simulate_easy", "plan_schedule",
    "wait_metrics", "validate_schedule",
    "timeline_to_tree", "to_scenario", "to_experiment",
    "batch_point_key", "run_batch_campaign",
]
