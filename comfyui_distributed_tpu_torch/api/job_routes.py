"""Job routes: the orchestration entry point.

The port's own copy of POST /distributed/queue from
comfyui_distributed_tpu/api/job_routes.py, without the scheduler's
admission lanes, adapters and the collector's result routes:

    POST /distributed/queue   {prompt, client_id, workers, deadline_s?}
                              → {status, prompt_id, workers, job_ids}

The deadline may also come as the X-CDT-Deadline header.
"""

from __future__ import annotations

from ..utils.exceptions import PromptValidationError
from .httpd import Request, Response, Router, json_response
from .orchestration.queue_orchestration import orchestrate_distributed_execution
from .queue_request import QueueRequestError, parse_deadline_seconds, parse_queue_request_payload


def register(router: Router, server) -> None:
    routes = JobRoutes(server)
    router.add_post("/distributed/queue", routes.queue)


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
