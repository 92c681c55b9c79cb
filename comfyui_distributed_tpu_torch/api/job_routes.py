"""Job routes: the orchestration entry point, the collector's results,
cancellation and the media sync's targets.

The port's own copy of comfyui_distributed_tpu/api/job_routes.py,
without the scheduler's admission lanes:

    POST /distributed/queue         {prompt, client_id, workers, deadline_s?,
                                    adapters?, load_balance?, ...} →
                                    400 for an adapter the master's catalog
                                    cannot resolve (no job is created), else
                                    {status, prompt_id,
                                    workers, job_ids}, or {status:
                                    "dispatched", mode: "load_balance",
                                    worker} when one worker took it all
    POST /distributed/cancel/{job_id} {reason?} → the store's refund
                                    accounting with status "cancelled" and
                                    cancel_latency_ms; 404 for an unknown job
    POST /distributed/job_complete  {job_id, worker_id, batch_idx, image
                                    (base64 PNG data URL), is_last, empty?}
                                    → {status}: "ok", or "late" for a job
                                    the master's collector has already
                                    drained and cleaned up (the envelope is
                                    dropped); 400 on a bad envelope or an
                                    undecodable image
    POST /distributed/prepare_job   {job_id} → {status}: announce a collector job
    POST /distributed/clear_memory  → {status}: the loaded pipelines and
                                    the node cache dropped, gc.collect()
                                    and torch.cuda.empty_cache()
    POST /distributed/check_file    {filename, md5?} → {exists, md5?, matches?}
    GET  /distributed/load_image?filename= → the input file's bytes
    POST /upload/image              multipart "image" or "file" parts →
                                    {name, saved}, written into the input
                                    directory under their base names

The input directory is the server's (settings.input_dir of its config,
or CDT_INPUT_DIR): where its LoadImage reads. (The JAX routes read the
environment's or the default directory and ignore the config's; ROADMAP
Queue 3.)

The deadline may also come as the X-CDT-Deadline header. An envelope
with `audio` answers 501: audio payloads are not ported (ROADMAP.md,
Queue 1 step 6b).
"""

from __future__ import annotations

import asyncio
import gc
import os
import time
from typing import Any

import torch

from ..adapters.registry import AdapterError, get_adapter_catalog
from ..graph.io_dirs import resolve_input_path
from ..utils import image as img_utils
from ..utils.constants import JOB_INIT_GRACE_SECONDS
from ..utils.exceptions import PromptValidationError
from ..utils.logging import log
from .httpd import Request, Response, Router, json_response, parse_multipart
from .orchestration.media_sync import file_md5
from .orchestration.queue_orchestration import orchestrate_distributed_execution
from .queue_request import QueueRequestError, parse_deadline_seconds, parse_queue_request_payload


def register(router: Router, server) -> None:
    routes = JobRoutes(server)
    router.add_post("/distributed/queue", routes.queue)
    router.add_post("/distributed/cancel/{job_id}", routes.cancel_job)
    router.add_post("/distributed/job_complete", routes.job_complete)
    router.add_post("/distributed/prepare_job", routes.prepare_job)
    router.add_post("/distributed/clear_memory", routes.clear_memory)
    router.add_post("/distributed/check_file", routes.check_file)
    router.add_get("/distributed/load_image", routes.load_image)
    router.add_post("/upload/image", routes.upload_image)


def validate_envelope(body: Any) -> list[str]:
    """What is wrong with a job_complete body (empty when nothing is)."""
    if not isinstance(body, dict):
        return ["body must be an object"]
    errors = [f"missing {field!r}" for field in ("job_id", "worker_id", "batch_idx", "image")
              if field not in body]
    if "batch_idx" in body:
        try:
            int(body["batch_idx"])
        except (TypeError, ValueError):
            errors.append("batch_idx must be an int")
    if "image" in body and not isinstance(body["image"], str):
        errors.append("image must be a base64 data-URL string")
    return errors


class JobRoutes:
    def __init__(self, server):
        self.server = server

    async def queue(self, request: Request) -> Response:
        body = request.json()
        if body is None:
            return json_response({"error": "invalid json"}, 400)
        try:
            payload = parse_queue_request_payload(body)
            if payload.deadline_s is None:
                payload.deadline_s = parse_deadline_seconds(request.headers.get("x-cdt-deadline"))
        except QueueRequestError as exc:
            return json_response({"error": str(exc)}, 400)
        if payload.adapters:
            # names → content hashes against the master's catalog, now: an
            # unknown adapter is the client's error at admission, never a
            # worker's mid-job failure
            try:
                payload.adapters = await asyncio.to_thread(
                    get_adapter_catalog().resolve_request, payload.adapters)
            except AdapterError as exc:
                return json_response({"error": str(exc)}, 400)
        try:
            result = await orchestrate_distributed_execution(self.server, payload)
        except PromptValidationError as exc:
            return json_response({"error": str(exc), "node_errors": exc.node_errors}, 400)
        return json_response(result)

    async def cancel_job(self, request: Request) -> Response:
        """Cancel a running tile job: every pending and in-flight tile is
        refunded, the workers' pulls come back empty and the master's
        loop ends cancelled. Idempotent; 404 for an unknown job."""
        job_id = request.match_info["job_id"]
        body = request.json()
        reason = str(body["reason"]) if isinstance(body, dict) and body.get("reason") else "client"
        started = time.monotonic()
        accounting = await self.server.job_store.cancel_job(job_id, reason=reason)
        if accounting is None:
            return json_response({"error": "no such job"}, 404)
        accounting["status"] = "cancelled"
        accounting["cancel_latency_ms"] = round((time.monotonic() - started) * 1000.0, 3)
        return json_response(accounting)

    async def job_complete(self, request: Request) -> Response:
        """One worker image for the master's collector."""
        body = request.json()
        errors = validate_envelope(body)
        if errors:
            return json_response({"error": "; ".join(errors)}, 400)
        try:
            tensor = img_utils.decode_image_data_url(body["image"])
        except Exception as exc:  # noqa: BLE001 - boundary validation
            return json_response({"error": f"undecodable image: {exc}"}, 400)
        if body.get("audio") is not None:
            return json_response({"error": "audio payloads are not ported (ROADMAP.md, Queue 1 "
                                           "step 6b)"}, 501)
        job_id = str(body["job_id"])
        store = self.server.job_store
        await store.wait_for_collector(job_id, JOB_INIT_GRACE_SECONDS)
        queued = await store.put_collector_result(job_id, {
            "tensor": tensor,
            "worker_id": str(body["worker_id"]),
            "batch_idx": int(body["batch_idx"]),
            "is_last": bool(body.get("is_last", False)),
            "empty": bool(body.get("empty", False)),
        }, received_bytes=len(body["image"]))
        return json_response({"status": "ok" if queued else "late"})

    async def prepare_job(self, request: Request) -> Response:
        body = request.json()
        if not isinstance(body, dict) or not body.get("job_id"):
            return json_response({"error": "missing job_id"}, 400)
        await self.server.job_store.ensure_collector(str(body["job_id"]))
        return json_response({"status": "ok"})

    async def clear_memory(self, request: Request) -> Response:
        """Drop the loaded pipelines and the node cache, then free the
        card's cached blocks (the next prompt loads its model again)."""
        self.server.execution_context.pipelines.clear()
        self.server.execution_context.extras.pop("node_cache", None)
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        log("cleared the loaded pipelines and the node cache")
        return json_response({"status": "ok"})

    async def check_file(self, request: Request) -> Response:
        """{filename, md5?} → whether the input file exists (and its md5
        matches): the media sync's question."""
        body = request.json()
        if not isinstance(body, dict):
            return json_response({"error": "invalid json"}, 400)
        name = body.get("filename")
        if not name:
            return json_response({"error": "missing filename"}, 400)
        try:
            path = resolve_input_path(str(name), self.server.media_context())
        except Exception:  # noqa: BLE001 - an escaping name is no file here
            return json_response({"exists": False})
        if not os.path.isfile(path):
            return json_response({"exists": False})
        response: dict[str, Any] = {"exists": True}
        expected = body.get("md5")
        if expected:
            response["md5"] = await asyncio.to_thread(file_md5, path)
            response["matches"] = response["md5"] == expected
        return json_response(response)

    async def load_image(self, request: Request) -> Response:
        name = request.query.get("filename", "")
        try:
            path = resolve_input_path(name, self.server.media_context())
        except Exception:  # noqa: BLE001 - a path that escapes the directory
            return json_response({"error": "bad path"}, 400)
        if not os.path.isfile(path):
            return json_response({"error": "not found"}, 404)

        def read() -> bytes:
            with open(path, "rb") as fh:
                return fh.read()

        return Response.raw(await asyncio.to_thread(read), "application/octet-stream")

    async def upload_image(self, request: Request) -> Response:
        """Multipart upload into the input directory (the media sync's
        target, ComfyUI's /upload/image): each "image" or "file" part is
        written under its base name, so no name leaves the directory."""
        try:
            parts = parse_multipart(request.body, request.headers.get("content-type", ""))
        except ValueError as exc:
            return json_response({"error": f"bad multipart body: {exc}"}, 400)
        target_dir = self.server.input_dir()
        saved = []
        for part in parts:
            if part.name not in ("image", "file"):
                continue
            filename = os.path.basename((part.filename or "upload.bin").replace("\\", "/"))
            if filename in ("", ".", ".."):
                return json_response({"error": f"bad file name {part.filename!r}"}, 400)

            def write(data=part.data, name=filename) -> None:
                os.makedirs(target_dir, exist_ok=True)
                with open(os.path.join(target_dir, name), "wb") as fh:
                    fh.write(data)

            await asyncio.to_thread(write)
            saved.append(filename)
        return json_response({"name": saved[0] if saved else None, "saved": saved})
