"""Worker probing, selection and prompt dispatch.

The port's own copy of the HTTP path of comfyui_distributed_tpu/api/
orchestration/dispatch.py: concurrent bounded probes that drop offline
workers, and dispatch over the plain POST /prompt API, retrying
connection-level failures only (a worker that answered with a rejection
is never re-sent the prompt). The websocket dispatch, the circuit
breaker and load-balanced placement are not ported yet.
"""

from __future__ import annotations

import asyncio
from typing import Any

from ...resilience.policy import http_policy, retry_async, transport_errors
from ...utils.constants import DISPATCH_TIMEOUT_SECONDS, PROBE_CONCURRENCY
from ...utils.exceptions import WorkerNotAvailableError, WorkerUnreachableError
from ...utils.logging import log
from ...utils.network import build_worker_url, probe_worker, request_json_async


async def probe_workers(workers: list[dict[str, Any]], concurrency: int = PROBE_CONCURRENCY
                        ) -> list[tuple[dict[str, Any], dict[str, Any]]]:
    """Probe all workers concurrently (bounded); [(worker, probe)] in
    input order."""
    sem = asyncio.Semaphore(concurrency)

    async def one(worker):
        async with sem:
            return worker, await probe_worker(build_worker_url(worker))

    return list(await asyncio.gather(*(one(w) for w in workers)))


async def select_active_workers(workers: list[dict[str, Any]],
                                concurrency: int = PROBE_CONCURRENCY) -> list[dict[str, Any]]:
    """Enabled workers that answered the probe; offline ones are logged
    and skipped."""
    results = await probe_workers([w for w in workers if w.get("enabled")], concurrency)
    active = []
    for worker, probe in results:
        if probe["online"]:
            active.append(worker)
        else:
            log(f"worker {worker.get('id')} offline; skipping")
    return active


async def dispatch_worker_prompt(worker: dict[str, Any], prompt: dict[str, Any],
                                 prompt_id: str) -> None:
    """POST a rewritten prompt to one worker's /prompt. Raises
    WorkerUnreachableError when it never arrived, WorkerNotAvailableError
    when the worker answered with an error status."""
    url = build_worker_url(worker, "/prompt")
    payload = {"prompt": prompt, "prompt_id": prompt_id}

    async def attempt():
        status, body = await request_json_async("POST", url, payload,
                                                timeout=DISPATCH_TIMEOUT_SECONDS)
        if status != 200:
            raise WorkerNotAvailableError(
                f"dispatch to {worker.get('id')} failed: HTTP {status} {str(body)[:200]}",
                worker.get("id"),
            )

    try:
        await retry_async(attempt, http_policy(deadline=DISPATCH_TIMEOUT_SECONDS),
                          retryable=transport_errors(), label=f"dispatch:{worker.get('id')}")
    except transport_errors() as exc:
        raise WorkerUnreachableError(f"dispatch to {worker.get('id')} failed: {exc}",
                                     worker.get("id")) from exc
