"""Job routes: the orchestration entry point and the collector's results.

The port's own copy of these routes of comfyui_distributed_tpu/api/
job_routes.py, without the scheduler's admission lanes and adapters:

    POST /distributed/queue         {prompt, client_id, workers, deadline_s?}
                                    → {status, prompt_id, workers, job_ids}
    POST /distributed/job_complete  {job_id, worker_id, batch_idx, image
                                    (base64 PNG data URL), is_last, empty?}
                                    → {status}: "ok", or "late" for a job
                                    the master's collector has already
                                    drained and cleaned up (the envelope is
                                    dropped); 400 on a bad envelope or an
                                    undecodable image
    POST /distributed/prepare_job   {job_id} → {status}: announce a collector job

The deadline may also come as the X-CDT-Deadline header. An envelope
with `audio` answers 501: audio payloads are not ported (ROADMAP.md,
Queue 1 item 5).
"""

from __future__ import annotations

from typing import Any

from ..utils import image as img_utils
from ..utils.constants import JOB_INIT_GRACE_SECONDS
from ..utils.exceptions import PromptValidationError
from .httpd import Request, Response, Router, json_response
from .orchestration.queue_orchestration import orchestrate_distributed_execution
from .queue_request import QueueRequestError, parse_deadline_seconds, parse_queue_request_payload


def register(router: Router, server) -> None:
    routes = JobRoutes(server)
    router.add_post("/distributed/queue", routes.queue)
    router.add_post("/distributed/job_complete", routes.job_complete)
    router.add_post("/distributed/prepare_job", routes.prepare_job)


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
        try:
            result = await orchestrate_distributed_execution(self.server, payload)
        except PromptValidationError as exc:
            return json_response({"error": str(exc), "node_errors": exc.node_errors}, 400)
        return json_response(result)

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
                                           "item 5)"}, 501)
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
