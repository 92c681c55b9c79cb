"""The distributed queue pipeline: one request → every participant running.

The port's own copy of the full fan-out of comfyui_distributed_tpu/
api/orchestration/queue_orchestration.py: load the config → resolve and
probe the requested workers → a job id per distributed node (and its
collector, which makes a worker's job-status poll read ready) → per
worker, prune the prompt and apply its participant overrides →
dispatch in parallel → queue the master's own prompt, naming the
workers that took theirs.

Not ported yet: load-balanced single placement, media sync (the one-host
runs share the input directory), delegate-only masters and the
scheduler's admission.
"""

from __future__ import annotations

import asyncio
import uuid
from typing import Any

from ...graph.prompt import (
    ParticipantInfo,
    PromptIndex,
    apply_participant_overrides,
    generate_job_id_map,
    prune_prompt_for_worker,
)
from ...utils import config as config_mod
from ...utils.logging import log
from ...utils.network import build_master_callback_url
from ..queue_request import QueueRequestPayload
from .dispatch import dispatch_worker_prompt, select_active_workers


async def orchestrate_distributed_execution(server, payload: QueueRequestPayload
                                            ) -> dict[str, Any]:
    config = config_mod.load_config(server.config_path)
    settings = config.get("settings", {})
    configured = {str(w.get("id")): w for w in config.get("workers", [])}
    requested = [configured[w] for w in payload.worker_ids if w in configured]
    index = PromptIndex(payload.prompt)
    active = await select_active_workers(requested, settings.get("probe_concurrency", 8))

    job_ids = generate_job_id_map(payload.prompt, index)
    for job_id in job_ids.values():
        await server.job_store.ensure_collector(job_id)
        if payload.deadline_s is not None:
            server.job_store.note_job_deadline(job_id, payload.deadline_s)

    enabled_ids = [str(w.get("id")) for w in active]
    prep_sem = asyncio.Semaphore(settings.get("prep_concurrency", 4))
    # names this execution's prompts on every participant
    trace_id = f"exec_{uuid.uuid4().hex[:12]}"

    async def prepare_and_dispatch(position: int, worker: dict[str, Any]) -> None:
        async with prep_sem:
            participant = ParticipantInfo(
                is_worker=True, worker_index=position, worker_id=str(worker.get("id")),
                master_url=_callback_url(server, worker, config), job_ids=job_ids,
                enabled_worker_ids=enabled_ids,
            )
            worker_prompt = apply_participant_overrides(
                prune_prompt_for_worker(payload.prompt, index), participant
            )
        await dispatch_worker_prompt(worker, worker_prompt, f"{trace_id}_w{position}")

    results = await asyncio.gather(
        *(prepare_and_dispatch(i, w) for i, w in enumerate(active)), return_exceptions=True
    )
    dispatched = []
    for worker, result in zip(active, results):
        if isinstance(result, BaseException):
            log(f"dispatch to {worker.get('id')} failed: {result}")
        else:
            dispatched.append(str(worker.get("id")))

    master_prompt = apply_participant_overrides(
        payload.prompt,
        ParticipantInfo(is_worker=False, job_ids=job_ids, enabled_worker_ids=dispatched),
    )
    job = server.queue_prompt(master_prompt, f"{trace_id}_master")
    log(f"dispatched to {dispatched}; master queued {job.prompt_id}")
    return {"status": "queued", "trace_id": trace_id, "prompt_id": job.prompt_id,
            "workers": dispatched, "job_ids": job_ids}


def _callback_url(server, worker: dict[str, Any], config: dict[str, Any]) -> str:
    return build_master_callback_url(worker, config.get("master", {}).get("host", ""),
                                     server.port)
