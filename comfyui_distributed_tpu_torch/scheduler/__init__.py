"""Scheduler control plane: admission, fair-share queueing, placement.

The port's own copy of comfyui_distributed_tpu/scheduler/ without its
shard router and autoscaler (`router.py`, `autoscale.py`: failover and
regions, ROADMAP.md Queue 1 step 7). The layer between the HTTP API and the job store that turns the
passive first-come-first-served pipeline into an actively managed one:

- `queue.AdmissionQueue` — multi-lane admission with priority classes,
  per-tenant deficit-round-robin fair share, bounded depth with
  explicit backpressure, and pause/resume/drain controls;
- `placement.PlacementPolicy` — cost-aware work assignment: per-worker
  throughput weights (EWMA over the store's pull→submit latencies)
  plus analytic tile-FLOP estimates size each worker's pull batch and
  trim the job tail away from suspect/slow workers;
- `brownout.BrownoutController` — load shedding of the lowest lanes
  when the queue-wait p95 stays over its target;
- `preempt.PreemptionCoordinator` — lane-ranked preemption flags on
  running jobs (a flagged job's pulls read as drained until the flags
  lift);
- `control.SchedulerControl` — the state machine the
  `/distributed/scheduler/*` routes drive, and the single object a
  `DistributedServer` owns.

Determinism invariant: placement may change WHO computes a tile, never
the blended result: a tile's noise is drawn from its global index.
"""

from .brownout import BrownoutController
from .control import SchedulerControl, SchedulerState
from .placement import PlacementPolicy
from .queue import (
    AdmissionClosed,
    AdmissionQueue,
    DeadlineUnmeetable,
    SchedulerOverloaded,
    SchedulerSaturated,
    Ticket,
)
from .preempt import PreemptionCoordinator

__all__ = [
    "AdmissionClosed",
    "AdmissionQueue",
    "BrownoutController",
    "DeadlineUnmeetable",
    "PlacementPolicy",
    "PreemptionCoordinator",
    "SchedulerControl",
    "SchedulerOverloaded",
    "SchedulerSaturated",
    "SchedulerState",
    "Ticket",
]
