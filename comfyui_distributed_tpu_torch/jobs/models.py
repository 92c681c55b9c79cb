"""Job state dataclasses (the port's own copy of the fields of
comfyui_distributed_tpu/jobs/models.py that its store keeps).

Left out with the store operations that use them: fencing epochs (ROADMAP
Queue 1 step 7g), preemption checkpoints and the cross-job tier. A job
recovered from the journal is built here by durability/state.py::
materialize.
"""

from __future__ import annotations

import asyncio
import dataclasses
import time
from typing import Any


@dataclasses.dataclass
class CollectorJob:
    """Per-job image gathering state (seed-parallel generation). The
    orchestration creates one per distributed node before dispatch, so a
    worker's job-status poll finds the job known; workers' image
    envelopes queue here for the master's DistributedCollector."""

    job_id: str
    queue: asyncio.Queue = dataclasses.field(default_factory=asyncio.Queue)
    created_at: float = dataclasses.field(default_factory=time.monotonic)
    # worker_id → number of items received
    received: dict[str, int] = dataclasses.field(default_factory=dict)
    # workers whose is_last item arrived
    finished_workers: set[str] = dataclasses.field(default_factory=set)
    # bytes of image data URLs received
    received_bytes: int = 0


@dataclasses.dataclass
class TileJob:
    """Static-mode USDU: a queue of tile indices for one upscale job."""

    job_id: str
    total_tasks: int
    pending: asyncio.Queue = dataclasses.field(default_factory=asyncio.Queue)
    results: asyncio.Queue = dataclasses.field(default_factory=asyncio.Queue)
    # global tile index → result payload (master-side dedup/blend input)
    completed: dict[int, Any] = dataclasses.field(default_factory=dict)
    # every accepted completion in order, (task id, worker id): the
    # record of which participant produced each tile (duplicates are
    # dropped before they get here)
    completions: list[tuple[int, str]] = dataclasses.field(default_factory=list)
    # duplicate submissions dropped (first result wins)
    duplicates: int = 0
    # bytes of tile payloads received over HTTP
    received_bytes: int = 0
    # worker_id → last heartbeat monotonic time
    worker_status: dict[str, float] = dataclasses.field(default_factory=dict)
    # worker_id → task ids currently assigned (for requeue)
    assigned: dict[str, set[int]] = dataclasses.field(default_factory=dict)
    # (worker_id, task_id) → assignment monotonic time: the pull-to-submit
    # latency the watchdog and the placement policy consume
    assigned_at: dict[tuple[str, int], float] = dataclasses.field(default_factory=dict)
    # worker_id → monotonic time of its last submit to this job: bounds
    # the service time of tiles pulled in one grant
    last_submit: dict[str, float] = dataclasses.field(default_factory=dict)
    # task ids the stall watchdog speculatively re-enqueued (once each)
    speculated: set[int] = dataclasses.field(default_factory=set)
    finished_workers: set[str] = dataclasses.field(default_factory=set)
    created_at: float = dataclasses.field(default_factory=time.monotonic)
    # batched static mode: one task id covers the whole image batch
    batched: bool = True
    # end-to-end deadline: seconds granted at init and the monotonic
    # cutoff derived from it (None = none)
    deadline_s: float | None = None
    deadline_at: float | None = None
    # terminal cancellation: pulls read as drained, submissions drop
    cancelled: bool = False
    cancel_reason: str = ""
    # task id → failed delivery attempts (timeout requeues); a task at
    # the attempt budget is quarantined out of the pull set
    attempts: dict[int, int] = dataclasses.field(default_factory=dict)
    # task id → workers whose crash charged an attempt: pardoned when
    # the tile turns out to be poison
    attempt_workers: dict[int, list[str]] = dataclasses.field(default_factory=dict)
    quarantined_tiles: set[int] = dataclasses.field(default_factory=set)
    # tiles settled from the content-addressed tile cache (cache/): done
    # without ever entering the pull set
    cached_tiles: set[int] = dataclasses.field(default_factory=set)
    # the resolved adapter plan in wire form ([{"name", "strength",
    # "content_hash"}], adapters/registry.py::specs_to_wire), served by
    # job_status to pulling workers; [] = the base model
    adapters: list = dataclasses.field(default_factory=list)
    # the admission lane and tenant the job was queued under: the
    # preemption coordinator ranks jobs by lane, the usage meter
    # attributes them by tenant and lane
    lane: str = ""
    tenant: str = "default"
    # a preemption request of the scheduler's coordinator: pulls read as
    # drained and pull/heartbeat answers carry `preempt` until it lifts
    preempt_requested: bool = False
    preempt_reason: str = ""

    def heartbeat(self, worker_id: str) -> None:
        self.worker_status[worker_id] = time.monotonic()

    def deadline_expired(self, now: float | None = None) -> bool:
        if self.deadline_at is None:
            return False
        return (now if now is not None else time.monotonic()) > self.deadline_at

    def deadline_remaining(self, now: float | None = None) -> float | None:
        if self.deadline_at is None:
            return None
        now = now if now is not None else time.monotonic()
        return max(0.0, self.deadline_at - now)


@dataclasses.dataclass
class ImageJob(TileJob):
    """Dynamic-mode USDU: a queue of whole-frame indices (an image batch
    processed a frame per pull). The lifecycle is TileJob's; `batched`
    means nothing here."""

    batched: bool = False
