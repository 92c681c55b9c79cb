"""Retry and backoff of the cross-host RPCs (resilience/policy.py), the
per-worker circuit breaker (resilience/health.py) and its binding to the
job store: a quarantined worker's in-flight tiles go back on the queue
at once (`bind_quarantine_requeue`); the seeded fault injector scripted
by CDT_FAULT_PLAN, consulted by the HTTP transport and the JobStore
(resilience/faults.py); and the in-process chaos harness that runs the
elastic tier under a fault plan (resilience/chaos.py, imported on use).
"""

from __future__ import annotations

import asyncio
from typing import Callable

from ..utils.logging import debug_log, log
from .faults import (
    FaultInjected,
    FaultInjector,
    get_fault_injector,
    reset_fault_injector,
    set_fault_injector,
)
from .health import HealthRegistry, WorkerState, get_health_registry, reset_health_registry
from .policy import RetryPolicy, http_policy, retry_async, work_pull_policy

__all__ = [
    "FaultInjected",
    "FaultInjector",
    "HealthRegistry",
    "RetryPolicy",
    "WorkerState",
    "bind_quarantine_requeue",
    "get_fault_injector",
    "get_health_registry",
    "http_policy",
    "reset_fault_injector",
    "reset_health_registry",
    "retry_async",
    "set_fault_injector",
    "work_pull_policy",
]


def bind_quarantine_requeue(registry: HealthRegistry, store) -> Callable[[], None]:
    """Wire the breaker to the JobStore: the moment a worker is
    quarantined, its in-flight tiles of every active job go back on the
    pending queue (`store.requeue_worker_tasks`), with no wait for its
    heartbeat to go stale. On the loop the requeue runs as a task, held
    by a strong reference until it ends (the loop keeps tasks weakly);
    off it (a compute thread) it hops to the server loop and waits.
    Returns the unbind callable the server calls on stop, so a stopped
    server's store is not kept alive by the process-global registry."""
    pending_tasks: set = set()

    def on_transition(worker_id: str, old: WorkerState, new: WorkerState) -> None:
        if new is not WorkerState.QUARANTINED:
            return

        async def requeue() -> None:
            moved = await store.requeue_worker_tasks(worker_id)
            if moved:
                log(f"quarantine of {worker_id}: requeued "
                    + ", ".join(f"{len(v)} task(s) of job {k}" for k, v in moved.items()))

        def done(task) -> None:
            pending_tasks.discard(task)
            exc = task.exception() if not task.cancelled() else None
            if exc is not None:
                debug_log(f"quarantine requeue for {worker_id} failed: {exc}")

        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            loop = None
        if loop is not None:
            task = loop.create_task(requeue())
            pending_tasks.add(task)
            task.add_done_callback(done)
            return
        from ..utils.async_helpers import run_async_in_server_loop

        try:
            run_async_in_server_loop(requeue(), timeout=30)
        except Exception as exc:  # noqa: BLE001 - the requeue is best effort
            debug_log(f"quarantine requeue for {worker_id} failed: {exc}")

    registry.add_listener(on_transition)
    return lambda: registry.remove_listener(on_transition)
