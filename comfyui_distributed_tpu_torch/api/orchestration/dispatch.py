"""Worker probing, selection and prompt dispatch.

The port's own copy of comfyui_distributed_tpu/api/orchestration/
dispatch.py, on utils/network.py and utils/websocket.py instead of
aiohttp:

- concurrent bounded probes that drop offline workers;
- least-busy placement (`select_least_busy_worker`): an idle worker
  round-robin (a module counter), else the least queue depth;
- dispatch over the worker's websocket (`/distributed/worker_ws`,
  dispatch_prompt answered by dispatch_ack), falling back to the plain
  POST /prompt only on a transport failure. A worker that answered with
  a rejection, over either, is never sent the prompt again;
- the circuit breaker (resilience/health.py): every probe and dispatch
  outcome is recorded, a quarantined worker is neither probed nor sent
  anything until its cooldown ends, and then one half-open probe decides.
"""

from __future__ import annotations

import asyncio
import itertools
import json
from typing import Any, Optional

from ...resilience.health import get_health_registry
from ...resilience.policy import http_policy, retry_async, transport_errors
from ...utils.constants import DISPATCH_TIMEOUT_SECONDS, PROBE_CONCURRENCY
from ...utils.exceptions import WorkerNotAvailableError, WorkerUnreachableError
from ...utils.logging import debug_log, log
from ...utils.network import build_worker_url, probe_worker, request_json_async
from ...utils.websocket import connect_websocket

# round-robin cursor over idle workers
_least_busy_rr = itertools.count()


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
    """Enabled workers that answered the probe. A quarantined worker is
    not probed unless its cooldown ended: then this probe is its
    half-open probe. Every outcome feeds the breaker."""
    registry = get_health_registry()
    probeable = []
    for worker in workers:
        if not worker.get("enabled"):
            continue
        wid = str(worker.get("id"))
        if registry.allow(wid) or registry.try_half_open(wid):
            probeable.append(worker)
        else:
            log(f"worker {wid} quarantined (circuit open); skipping")
    active = []
    for worker, probe in await probe_workers(probeable, concurrency):
        wid = str(worker.get("id"))
        if probe["online"]:
            registry.record_success(wid)
            active.append(worker)
        else:
            registry.record_failure(wid)
            log(f"worker {wid} offline; skipping")
    return active


async def select_least_busy_worker(workers: list[dict[str, Any]]) -> Optional[dict[str, Any]]:
    """Load-balanced single placement: an idle worker round-robin, else
    the least queue depth; None when none is online. Quarantined workers
    are left out."""
    registry = get_health_registry()
    candidates = [w for w in workers if registry.allow(str(w.get("id")))]
    online = [(w, p) for w, p in await probe_workers(candidates) if p["online"]]
    if not online:
        return None
    idle = [(w, p) for w, p in online if (p["queue_remaining"] or 0) == 0]
    if idle:
        return idle[next(_least_busy_rr) % len(idle)][0]
    return min(online, key=lambda wp: wp[1]["queue_remaining"] or 0)[0]


async def dispatch_worker_prompt(worker: dict[str, Any], prompt: dict[str, Any], prompt_id: str,
                                 use_websocket: bool = True,
                                 extra_data: dict[str, Any] | None = None) -> None:
    """Send a rewritten prompt to one worker. Raises
    WorkerUnreachableError when it never arrived, WorkerNotAvailableError
    when the worker answered with a rejection or is quarantined."""
    registry = get_health_registry()
    wid = str(worker.get("id"))
    if not registry.allow(wid):
        raise WorkerNotAvailableError(f"worker {wid} is quarantined (circuit open); "
                                      "not dispatching", wid)
    try:
        if use_websocket:
            try:
                await _dispatch_ws(worker, prompt, prompt_id, extra_data)
                registry.record_success(wid)
                return
            except WorkerNotAvailableError as exc:
                if not isinstance(exc, WorkerUnreachableError):
                    raise  # the worker's answer: never sent again over HTTP
                debug_log(f"websocket dispatch to {wid} unreachable ({exc}); trying HTTP")
            except Exception as exc:  # noqa: BLE001 - falls back to HTTP
                debug_log(f"websocket dispatch to {wid} failed ({type(exc).__name__}: {exc}); "
                          "trying HTTP")
        await _dispatch_http(worker, prompt, prompt_id, extra_data)
    except WorkerUnreachableError:
        registry.record_failure(wid)
        raise
    except WorkerNotAvailableError:
        # a rejection: the worker is alive, its failure chain resets
        registry.record_success(wid)
        raise
    registry.record_success(wid)


async def _dispatch_http(worker, prompt, prompt_id, extra_data) -> None:
    url = build_worker_url(worker, "/prompt")
    payload = {"prompt": prompt, "prompt_id": prompt_id}
    if extra_data:
        payload["extra_data"] = extra_data

    async def attempt():
        status, body = await request_json_async("POST", url, payload,
                                                timeout=DISPATCH_TIMEOUT_SECONDS)
        if status != 200:
            raise WorkerNotAvailableError(
                f"dispatch to {worker.get('id')} failed: HTTP {status} {str(body)[:200]}",
                worker.get("id"))

    try:
        await retry_async(attempt, http_policy(deadline=DISPATCH_TIMEOUT_SECONDS),
                          retryable=transport_errors(), label=f"dispatch:{worker.get('id')}")
    except WorkerNotAvailableError:
        raise
    except Exception as exc:
        raise WorkerUnreachableError(f"dispatch to {worker.get('id')} failed: {exc}",
                                     worker.get("id")) from exc


async def _dispatch_ws(worker, prompt, prompt_id, extra_data) -> None:
    url = build_worker_url(worker, "/distributed/worker_ws").replace(
        "http://", "ws://", 1).replace("https://", "wss://", 1)
    async with connect_websocket(url, timeout=DISPATCH_TIMEOUT_SECONDS) as ws:
        await ws.send_json({"type": "dispatch_prompt", "prompt": prompt, "prompt_id": prompt_id,
                            "extra_data": extra_data or {}})

        async def await_ack() -> bool:
            async for text in ws:
                data = json.loads(text)
                if data.get("type") == "dispatch_ack" and data.get("prompt_id") == prompt_id:
                    if not data.get("ok"):
                        raise WorkerNotAvailableError(
                            f"worker rejected prompt: {data.get('error')}", worker.get("id"))
                    return True
            return False

        try:
            acked = await asyncio.wait_for(await_ack(), DISPATCH_TIMEOUT_SECONDS)
        except asyncio.TimeoutError:
            acked = False
        if not acked:
            # connected but never answered: the HTTP fallback may get through
            raise WorkerUnreachableError("no dispatch_ack received", worker.get("id"))
