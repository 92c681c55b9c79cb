"""Profiler-capture routes and the transfer ledger's surface.

The port's own copy of comfyui_distributed_tpu/api/profile_routes.py,
on api/httpd.py:

    GET  /distributed/profile        the ledger's totals, the capture
                                     status and the retained captures
    POST /distributed/profile/start  begin a bounded torch.profiler
                                     capture (single flight, duration
                                     capped, auto-stops); 409 when it
                                     does not start
    POST /distributed/profile/stop   stop the active capture and write
                                     its trace

The capture routes are on when ``CDT_PROFILE_DIR`` is set; otherwise
they answer ``enabled: false`` with a hint, with the JAX routes'
statuses. The ledger block is served either way. A capture records the
device the server was built for (the card, or the CPU alone when the
caller asked for the CPU). Start and stop touch the filesystem and the
profiler, so they run off the event loop (`asyncio.to_thread`).
"""

from __future__ import annotations

import asyncio

from ..telemetry.profiling import get_profiler_capture, peek_transfer_ledger
from .httpd import Request, Response, Router, json_response

DISABLED_HINT = {
    "enabled": False,
    "hint": "set CDT_PROFILE_DIR to enable device trace capture",
}


def register(router: Router, server) -> None:
    routes = ProfileRoutes(server)
    router.add_get("/distributed/profile", routes.status)
    router.add_post("/distributed/profile/start", routes.start)
    router.add_post("/distributed/profile/stop", routes.stop)


class ProfileRoutes:
    def __init__(self, server):
        self.server = server

    async def status(self, request: Request) -> Response:
        ledger = peek_transfer_ledger()
        capture = get_profiler_capture()
        role = "worker" if getattr(self.server, "is_worker", False) else "master"
        payload: dict = {"ledger": ledger.totals(role) if ledger is not None else None}
        if capture is None:
            payload.update(DISABLED_HINT)
        else:
            payload["enabled"] = True
            payload["capture"] = await asyncio.to_thread(capture.status)
            payload["captures"] = await asyncio.to_thread(capture.captures)
        return json_response(payload)

    async def start(self, request: Request) -> Response:
        """Begin a capture. Optional JSON body: ``{"duration_s": <float>,
        "tag": <str>}``; the duration is clamped to
        CDT_PROFILE_MAX_SECONDS and the capture auto-stops."""
        capture = get_profiler_capture()
        if capture is None:
            return json_response(DISABLED_HINT, 400)
        duration = None
        tag = "manual"
        body = request.json()
        if isinstance(body, dict):
            try:
                if body.get("duration_s") is not None:
                    duration = float(body["duration_s"])
            except (TypeError, ValueError):
                return json_response({"error": "duration_s must be a number"}, 400)
            if body.get("tag"):
                tag = str(body["tag"])
        result = await asyncio.to_thread(capture.start, duration_s=duration, tag=tag,
                                         device=self.server.device)
        return json_response(result, 200 if result.get("started") else 409)

    async def stop(self, request: Request) -> Response:
        capture = get_profiler_capture()
        if capture is None:
            return json_response(DISABLED_HINT, 400)
        return json_response(await asyncio.to_thread(capture.stop))
