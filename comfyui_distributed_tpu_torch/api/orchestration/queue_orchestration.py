"""The distributed queue pipeline: one request → every participant running.

The port's own copy of comfyui_distributed_tpu/api/orchestration/
queue_orchestration.py: load the config → resolve and probe the
requested workers → with `load_balance` in the request's extras, place
the whole prompt on the least busy worker and stop there → else a job id
per distributed node (and its collector, which makes a worker's
job-status poll read ready) → per worker, prune the prompt, apply its
participant overrides and sync the media it names → dispatch in
parallel (over the websocket unless settings.websocket_orchestration is
off) → queue the master's own prompt, naming the workers that took
theirs; a delegate-only master (settings.master_delegate_only) keeps
only its collectors and what follows them, unless no worker took a
prompt.

A request's resolved adapter plan, and its admission lane (resolved by
the scheduler) and tenant, are noted in the store per job
(`note_job_adapters`, `note_job_priority`); a load-balanced prompt runs
whole on one worker and carries no adapters, as in the JAX package.

The execution is one trace: its id is the caller's `trace_id`, else the
one the queue route fixed for its admission (`sched.wait`, the root of
the tree), else a fresh `exec_*` id (utils/trace_logger.py). Under it
the `queue_orchestration` span, with `probe_workers`, one `media_sync`
and one `dispatch` span per worker (the dispatch carries the id in the
X-CDT-Trace-Id header, so each worker's execution joins it), and the
master's own execution. Every orchestration counts in
cdt_orchestrations_total by mode.
"""

from __future__ import annotations

import asyncio
from typing import Any

from ...adapters.registry import specs_to_wire
from ...graph.prompt import (
    ParticipantInfo,
    PromptIndex,
    apply_participant_overrides,
    generate_job_id_map,
    prepare_delegate_master_prompt,
    prune_prompt_for_worker,
)
from ...resilience.health import get_health_registry
from ...telemetry import get_tracer
from ...telemetry.instruments import orchestrations_total
from ...utils import config as config_mod
from ...utils.exceptions import WorkerNotAvailableError
from ...utils.logging import log
from ...utils.network import build_master_callback_url
from ...utils.trace_logger import generate_trace_id, trace_info
from ..queue_request import QueueRequestPayload
from .dispatch import dispatch_worker_prompt, select_active_workers, select_least_busy_worker
from .media_sync import sync_worker_media


async def orchestrate_distributed_execution(server, payload: QueueRequestPayload
                                            ) -> dict[str, Any]:
    trace_id = payload.trace_id or generate_trace_id()
    # the root span of the whole distributed execution: dispatches,
    # worker executions (joined via the header), tile pulls and
    # collector ingestion all parent into this tree
    with get_tracer().span("queue_orchestration", trace_id=trace_id,
                           client_id=payload.client_id):
        return await _orchestrate(server, payload, trace_id)


async def _orchestrate(server, payload: QueueRequestPayload, trace_id: str) -> dict[str, Any]:
    tracer = get_tracer()
    config = config_mod.load_config(server.config_path)
    settings = config.get("settings", {})
    use_ws = settings.get("websocket_orchestration", True)
    configured = {str(w.get("id")): w for w in config.get("workers", [])}
    requested = [configured[w] for w in payload.worker_ids if w in configured]
    index = PromptIndex(payload.prompt)
    trace_info(trace_id, f"orchestrating: {len(requested)} worker(s) requested")
    with tracer.span("probe_workers", requested=len(requested)):
        active = await select_active_workers(requested, settings.get("probe_concurrency", 8))

    # --- load-balanced single placement ---
    if payload.extra.get("load_balance") and active:
        target = await select_least_busy_worker(active)
        if target is not None:
            participant = ParticipantInfo(
                is_worker=True, worker_index=0, worker_id=str(target.get("id")),
                master_url=_callback_url(server, target, config),
                job_ids=generate_job_id_map(payload.prompt, index),
                enabled_worker_ids=[str(target.get("id"))],
            )
            worker_prompt = apply_participant_overrides(
                prune_prompt_for_worker(payload.prompt, index), participant)
            await dispatch_worker_prompt(target, worker_prompt, f"{trace_id}_lb", use_ws)
            trace_info(trace_id, f"load-balanced to worker {target.get('id')}")
            orchestrations_total().inc(mode="load_balance")
            return {"status": "dispatched", "trace_id": trace_id, "mode": "load_balance",
                    "worker": target.get("id")}

    # --- full fan-out ---
    job_ids = generate_job_id_map(payload.prompt, index)
    for job_id in job_ids.values():
        await server.job_store.ensure_collector(job_id)
        if payload.deadline_s is not None:
            server.job_store.note_job_deadline(job_id, payload.deadline_s)
        # the resolved lane, not the raw field: a request without one
        # lands on the default lane, and '' would rank it below every
        # lane for preemption
        scheduler = getattr(server, "scheduler", None)
        lane = scheduler.resolve_lane(payload.lane) if scheduler is not None else payload.lane
        server.job_store.note_job_priority(job_id, lane, payload.tenant)
        if payload.adapters:
            # the resolved plan parks in the store until the master's
            # init_tile_job stamps it onto the job, from where job_status
            # serves it to pulling workers
            server.job_store.note_job_adapters(job_id, specs_to_wire(payload.adapters))

    enabled_ids = [str(w.get("id")) for w in active]
    prep_sem = asyncio.Semaphore(settings.get("prep_concurrency", 4))
    media_sem = asyncio.Semaphore(settings.get("media_sync_concurrency", 2))
    input_dir = server.input_dir()

    async def prepare_and_dispatch(position: int, worker: dict[str, Any]) -> None:
        async with prep_sem:
            participant = ParticipantInfo(
                is_worker=True, worker_index=position, worker_id=str(worker.get("id")),
                master_url=_callback_url(server, worker, config), job_ids=job_ids,
                enabled_worker_ids=enabled_ids,
            )
            worker_prompt = apply_participant_overrides(
                prune_prompt_for_worker(payload.prompt, index), participant)
            async with media_sem:
                with tracer.span("media_sync", trace_id=trace_id,
                                 worker_id=str(worker.get("id"))) as sync_span:
                    try:
                        await sync_worker_media(worker, worker_prompt, input_dir)
                    except Exception as exc:  # noqa: BLE001 - sync is best effort
                        # swallowed (dispatch proceeds), but the trace
                        # still shows the sync failed
                        sync_span.status = "error"
                        sync_span.attrs["error"] = f"{type(exc).__name__}: {exc}"
                        log(f"media sync to {worker.get('id')} failed: {exc}")
        await dispatch_worker_prompt(worker, worker_prompt, f"{trace_id}_w{position}", use_ws)

    results = await asyncio.gather(
        *(prepare_and_dispatch(i, w) for i, w in enumerate(active)), return_exceptions=True)
    dispatched = []
    for worker, result in zip(active, results):
        if isinstance(result, Exception):
            log(f"dispatch to {worker.get('id')} failed: {result}")
            # the dispatch layer recorded its own outcomes (a rejection is
            # no failure); a crash of the preparation is recorded here
            if not isinstance(result, WorkerNotAvailableError):
                get_health_registry().record_failure(str(worker.get("id")))
        else:
            dispatched.append(str(worker.get("id")))

    # --- the master's own prompt ---
    master_prompt = apply_participant_overrides(
        payload.prompt,
        ParticipantInfo(is_worker=False, job_ids=job_ids, enabled_worker_ids=dispatched))
    delegate = settings.get("master_delegate_only", False)
    if delegate and dispatched:
        master_prompt = prepare_delegate_master_prompt(master_prompt)
        trace_info(trace_id, "delegate mode: master pruned to its collectors and what follows "
                             "them")
    elif delegate:
        trace_info(trace_id, "delegate mode requested but no worker took a prompt; the master "
                             "participates")
    job = server.queue_prompt(master_prompt, f"{trace_id}_master", trace_id=trace_id)
    trace_info(trace_id, f"dispatched to {dispatched}; master queued {job.prompt_id}")
    orchestrations_total().inc(mode="fan_out")
    return {"status": "queued", "trace_id": trace_id, "prompt_id": job.prompt_id,
            "workers": dispatched, "job_ids": job_ids}


def _callback_url(server, worker: dict[str, Any], config: dict[str, Any]) -> str:
    return build_master_callback_url(worker, config.get("master", {}).get("host", ""),
                                     server.port)
