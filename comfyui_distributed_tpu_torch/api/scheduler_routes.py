"""Scheduler control-plane routes.

The port's own copy of comfyui_distributed_tpu/api/scheduler_routes.py,
on api/httpd.py:

    GET    /distributed/scheduler/status        lanes, deficits, weights
    POST   /distributed/scheduler/pause         withhold grants
    POST   /distributed/scheduler/resume        reopen grants and admission
    POST   /distributed/scheduler/drain         close admission
    POST   /distributed/scheduler/reprioritize  move a ticket / retune a
                                                tenant weight
    DELETE /distributed/queue/{ticket_id}       withdraw a queued ticket

The admission gate itself lives in the queue route
(job_routes.JobRoutes.queue): a full lane answers 429 + Retry-After
there, a draining scheduler 503; these routes only drive the state
machine and expose it.
"""

from __future__ import annotations

from .httpd import Request, Response, Router, json_response


def register(router: Router, server) -> None:
    routes = SchedulerRoutes(server)
    router.add_get("/distributed/scheduler/status", routes.status)
    router.add_post("/distributed/scheduler/pause", routes.pause)
    router.add_post("/distributed/scheduler/resume", routes.resume)
    router.add_post("/distributed/scheduler/drain", routes.drain)
    router.add_post("/distributed/scheduler/reprioritize", routes.reprioritize)
    # pre-admission ticket cancel: abandon a QUEUED request without
    # waiting out the grant timeout
    router.add_delete("/distributed/queue/{ticket_id}", routes.cancel_ticket)


class SchedulerRoutes:
    def __init__(self, server):
        self.server = server

    @property
    def scheduler(self):
        return self.server.scheduler

    async def status(self, request: Request) -> Response:
        return json_response(self.scheduler.status())

    async def pause(self, request: Request) -> Response:
        return json_response({"state": self.scheduler.pause().value})

    async def resume(self, request: Request) -> Response:
        return json_response({"state": self.scheduler.resume().value})

    async def drain(self, request: Request) -> Response:
        return json_response({"state": self.scheduler.drain().value})

    async def cancel_ticket(self, request: Request) -> Response:
        """Withdraw one QUEUED admission ticket: the parked queue request
        wakes and answers 409; 404 when the ticket is unknown, already
        granted (cancel the job instead) or gone."""
        ticket_id = str(request.match_info["ticket_id"])
        if not self.scheduler.queue.cancel_ticket(ticket_id):
            return json_response({
                "error": "no such queued ticket",
                "detail": "unknown id, or the ticket was already granted (use POST "
                          "/distributed/cancel/{job_id}) or released",
            }, 404)
        return json_response({"status": "cancelled", "ticket_id": ticket_id})

    async def reprioritize(self, request: Request) -> Response:
        body = request.json()
        if body is None:
            return json_response({"error": "invalid json"}, 400)
        if not isinstance(body, dict):
            return json_response({"error": "body must be an object"}, 400)
        if not any(k in body for k in ("ticket_id", "tenant")):
            return json_response({"error": "need 'ticket_id'+'lane' and/or 'tenant'+'weight'"},
                                 400)
        try:
            result = self.scheduler.reprioritize(
                ticket_id=body.get("ticket_id"), lane=body.get("lane"),
                tenant=body.get("tenant"), weight=body.get("weight"))
        except (TypeError, ValueError) as exc:
            return json_response({"error": str(exc)}, 400)
        if body.get("ticket_id") is not None and not result["moved"]:
            return json_response(dict(result, error="no such queued ticket"), 404)
        return json_response(result)
