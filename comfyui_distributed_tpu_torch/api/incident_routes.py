"""Incident-bundle routes: list, fetch, manual capture.

The port's own copy of comfyui_distributed_tpu/api/incident_routes.py,
on api/httpd.py:

    GET  /distributed/incidents           newest-first bundle listing and
                                          the manager's and the flight
                                          recorder's accounting
    GET  /distributed/incidents/{id}      one whole bundle (JSON)
    POST /distributed/incidents/capture   manual capture (bypasses the
                                          debounce, still single-flight)

A master with ``CDT_INCIDENT_DIR`` has the incident manager; elsewhere
every route answers ``enabled: false`` with a hint, with the JAX
routes' statuses. File reads and the synchronous capture run off the
event loop (`asyncio.to_thread`): a bundle of megabytes must not stall
serving.
"""

from __future__ import annotations

import asyncio

from .httpd import Request, Response, Router, json_response

DISABLED_HINT = {
    "enabled": False,
    "hint": "set CDT_INCIDENT_DIR on a master to enable incident capture",
}


def register(router: Router, server) -> None:
    routes = IncidentRoutes(server)
    router.add_get("/distributed/incidents", routes.list_incidents)
    router.add_post("/distributed/incidents/capture", routes.capture)
    router.add_get("/distributed/incidents/{incident_id}", routes.get_incident)


class IncidentRoutes:
    def __init__(self, server):
        self.server = server

    @property
    def manager(self):
        return getattr(self.server, "incidents", None)

    async def list_incidents(self, request: Request) -> Response:
        manager = self.manager
        if manager is None:
            return json_response(DISABLED_HINT)
        from ..telemetry.flight import peek_flight_recorder

        listing = await asyncio.to_thread(manager.list_bundles)
        recorder = peek_flight_recorder()
        return json_response({
            "enabled": True,
            "incidents": listing,
            "manager": manager.status(),
            "flight": recorder.status() if recorder is not None else None,
        })

    async def get_incident(self, request: Request) -> Response:
        manager = self.manager
        if manager is None:
            return json_response(DISABLED_HINT, 404)
        incident_id = request.match_info["incident_id"]
        bundle = await asyncio.to_thread(manager.read_bundle, incident_id)
        if bundle is None:
            return json_response({"error": f"no such incident: {incident_id}"}, 404)
        return json_response(bundle)

    async def capture(self, request: Request) -> Response:
        """Operator-initiated capture. Optional JSON body:
        ``{"key": ..., "context": {...}}`` rides into the bundle's
        trigger section (a ``trace_id`` in the context names the
        execution whose spans the bundle takes). Runs the capture off
        the loop and answers with the written bundle's id."""
        manager = self.manager
        if manager is None:
            return json_response(DISABLED_HINT, 400)
        key = ""
        context: dict = {}
        body = request.json()
        if isinstance(body, dict):
            key = str(body.get("key", ""))
            if isinstance(body.get("context"), dict):
                context = body["context"]
        try:
            result = await asyncio.to_thread(manager.capture_now, key=key, context=context)
        except Exception as exc:  # noqa: BLE001 - reported to the operator
            return json_response({"error": f"{type(exc).__name__}: {exc}"}, 500)
        return json_response({"captured": True, **result})
