"""Telemetry routes: the Prometheus scrape, span trees, the tile cache.

The port's own copy of the observability routes of
comfyui_distributed_tpu/api/telemetry_routes.py, on api/httpd.py:

    GET  /distributed/metrics           Prometheus text exposition
    GET  /distributed/trace/{trace_id}  span tree JSON for one execution
    GET  /distributed/traces            paginated trace-id listing
    GET  /distributed/fleet             fleet rollup and per-worker drill-down
                                        (?since=SECONDS adds history,
                                        ?worker=ID scopes it)
    GET  /distributed/alerts            SLO burn rates and alert state
    GET  /distributed/usage             chip-time attribution by tenant,
                                        lane and job (?since=, ?tenant=)
    GET  /distributed/events            live event stream (WebSocket;
                                        ?types=a,b filters bus-side)
    GET  /distributed/cache             tile-cache stats
    POST /distributed/cache/clear       drop both tile-cache tiers

The metrics body is the process-global registry: counters and
histograms pushed by the instrumented layers, live-state gauges filled
at scrape time by each server's collectors (telemetry/instruments.py)
and the runtime gauges (telemetry/runtime.py). A master and a worker in
one process share it; the `role`, `worker_id` and `server` labels keep
their series apart.

The fleet, alerts and usage routes answer `{"enabled": false, "hint"}`
on a server without the fleet plane (a worker, or CDT_FLEET=0).
The event stream is the event bus (telemetry/events.py) over a
WebSocket: its first frame is `hello` (the breaker snapshot and the
store's counts), then every event the bus fans out to the connection's
subscription, an `events_dropped` notice before the first event after
the subscription's queue dropped some, until the client closes. Push
grants ride it (graph/usdu_elastic.py::GrantSignal).
Not registered, so it answers 404 as the port's other unported routes
do: /distributed/durability (ROADMAP.md, Queue 1 step 7f). The
profiler-capture routes are api/profile_routes.py, the incident routes
api/incident_routes.py.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import math
from typing import Any

from ..telemetry import TRACE_HEADER, get_metrics_registry, get_tracer
from ..telemetry.events import get_event_bus
from .httpd import Request, Response, Router, accept_websocket, json_response

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

DEFAULT_TRACE_PAGE = 50


@contextlib.contextmanager
def rpc_span(request: Request, name: str, **attrs: Any):
    """Attach a server-side span for one inbound RPC to the trace the
    X-CDT-Trace-Id header names; no-op (yields None) when the caller did
    not propagate a trace. Shared by every route module that receives
    trace-propagated worker RPCs (usdu_routes, job_routes)."""
    trace_id = request.headers.get(TRACE_HEADER.lower())
    if not trace_id:
        yield None
        return
    with get_tracer().span(name, trace_id=trace_id, **attrs) as span:
        yield span


def register(router: Router, server) -> None:
    routes = TelemetryRoutes(server)
    router.add_get("/distributed/metrics", routes.metrics)
    router.add_get("/distributed/trace/{trace_id}", routes.trace)
    router.add_get("/distributed/traces", routes.traces)
    router.add_get("/distributed/fleet", routes.fleet)
    router.add_get("/distributed/alerts", routes.alerts)
    router.add_get("/distributed/usage", routes.usage)
    router.add_get("/distributed/events", routes.events)
    router.add_get("/distributed/cache", routes.cache)
    router.add_post("/distributed/cache/clear", routes.cache_clear)


class TelemetryRoutes:
    def __init__(self, server):
        self.server = server

    async def metrics(self, request: Request) -> Response:
        body = get_metrics_registry().render()
        return Response.raw(body.encode("utf-8"), PROMETHEUS_CONTENT_TYPE)

    @staticmethod
    def _since(request: Request) -> tuple[float | None, Response | None]:
        """The `since` query parameter: (seconds or None, None), or
        (None, a 400 answer) when it is not a finite number >= 0."""
        since_param = request.query.get("since")
        if since_param is None:
            return None, None
        try:
            since_s = float(since_param)
        except (TypeError, ValueError):
            return None, json_response({"error": "since must be a number of seconds"}, 400)
        # NaN and Infinity would serialize as non-standard JSON tokens
        if not math.isfinite(since_s) or since_s < 0:
            return None, json_response({"error": "since must be a finite number >= 0"}, 400)
        return since_s, None

    async def fleet(self, request: Request) -> Response:
        """Fleet rollups and per-worker drill-down (telemetry/fleet.py)."""
        registry = getattr(self.server, "fleet", None)
        if registry is None:
            return json_response({"enabled": False,
                                  "hint": "fleet plane runs on masters with CDT_FLEET=1"})
        since_s, error = self._since(request)
        if error is not None:
            return error
        payload = registry.status(since_s=since_s, worker=request.query.get("worker"))
        payload["enabled"] = True
        return json_response(payload)

    async def usage(self, request: Request) -> Response:
        """Chip-time attribution from the master's usage aggregator: the
        fleet rollup by tenant, lane and job, the waste breakdown, the
        conservation identity and the measured cost model."""
        fleet = getattr(self.server, "fleet", None)
        aggregator = getattr(fleet, "usage", None) if fleet else None
        if aggregator is None:
            return json_response({"enabled": False,
                                  "hint": "usage metering runs on masters with CDT_FLEET=1 "
                                          "and CDT_USAGE=1"})
        since_s, error = self._since(request)
        if error is not None:
            return error
        return json_response(aggregator.status(since_s=since_s,
                                               tenant=request.query.get("tenant")))

    async def alerts(self, request: Request) -> Response:
        """The SLO engine: every spec's burn rates, the open alerts and
        the bounded transition history."""
        engine = getattr(self.server, "slo", None)
        if engine is None:
            return json_response({"enabled": False,
                                  "hint": "SLO engine runs on masters with CDT_FLEET=1"})
        payload = engine.status()
        payload["enabled"] = True
        return json_response(payload)

    async def events(self, request: Request) -> Response:
        """The live event stream over a WebSocket (see the module
        docstring). The handler waits on the subscription and on the
        socket at once: the stream is one-way, so anything the client
        sends, or its close, ends it, and the subscription goes with it
        (waiting on the subscription alone would keep a departed client's
        queue on the bus until the next event)."""
        types_param = request.query.get("types")
        types = ({t.strip() for t in types_param.split(",") if t.strip()} if types_param
                 else None)
        ws = await accept_websocket(request)
        if ws is None:
            return json_response({"error": "websocket handshake expected"}, 400)
        bus = get_event_bus()
        # named per remote: the scrape's per-subscriber depth and drops
        sub = bus.subscribe(types=types, name=f"ws:{request.remote or 'events'}")
        from ..resilience.health import get_health_registry

        hello = {
            "type": "hello", "seq": None, "ts": None,
            "data": {
                "server": f"{'worker' if self.server.is_worker else 'master'}:{self.server.port}",
                "subscribed": sorted(types) if types else "all",
                "health": get_health_registry().snapshot(),
                "store": self.server.job_store.stats_unlocked(),
            },
        }
        receiver = asyncio.ensure_future(ws.receive())
        getter: asyncio.Future | None = None
        reported_drops = 0
        try:
            await ws.send_text(json.dumps(hello, default=str))
            while True:
                getter = asyncio.ensure_future(sub.get())
                done, _ = await asyncio.wait({getter, receiver},
                                             return_when=asyncio.FIRST_COMPLETED)
                if receiver in done:
                    break  # the client closed (or sent something)
                event = getter.result()
                getter = None
                if sub.dropped > reported_drops:
                    # a connection-local notice: it never rode the bus
                    await ws.send_text(json.dumps({
                        "type": "events_dropped", "seq": None, "ts": None,
                        "data": {"count": sub.dropped - reported_drops}}))
                    reported_drops = sub.dropped
                await ws.send_text(json.dumps(event, default=str))
        except ConnectionError:
            pass  # the client went away mid-send
        finally:
            bus.unsubscribe(sub)
            if getter is not None:
                getter.cancel()
            receiver.cancel()
            with contextlib.suppress(Exception):
                await ws.close()
        return Response.detached_response()

    async def trace(self, request: Request) -> Response:
        trace_id = request.match_info["trace_id"]
        tracer = get_tracer()
        spans = tracer.spans(trace_id)
        if not spans:
            return json_response({"error": "no such trace"}, 404)
        return json_response({
            "trace_id": trace_id,
            "span_count": len(spans),
            "tree": tracer.tree(trace_id, spans),
        })

    async def traces(self, request: Request) -> Response:
        """Paginated listing, most-recently-active first. The page size is
        clamped to the tracer's retention bound."""
        tracer = get_tracer()
        try:
            limit = int(request.query.get("limit", DEFAULT_TRACE_PAGE))
            offset = int(request.query.get("offset", 0))
        except (TypeError, ValueError):
            return json_response({"error": "limit/offset must be integers"}, 400)
        if limit <= 0 or offset < 0:
            return json_response({"error": "limit must be > 0 and offset >= 0"}, 400)
        limit = min(limit, tracer.max_traces)
        ids = tracer.trace_ids()
        ids.reverse()  # storage order is LRU: last = most recently active
        return json_response({
            "traces": ids[offset:offset + limit],
            "total": len(ids),
            "limit": limit,
            "offset": offset,
        })

    async def cache(self, request: Request) -> Response:
        """Tile-cache stats: tier sizes, hit/miss/corrupt counters and
        the derived hit rate."""
        from ..cache.store import get_tile_cache

        tile_cache = get_tile_cache()
        if tile_cache is None:
            return json_response({
                "enabled": False,
                "hint": "tile result cache runs on masters with CDT_CACHE=1 "
                        "(CDT_CACHE_DIR adds the disk tier)"})
        payload = tile_cache.stats()
        payload["enabled"] = True
        return json_response(payload)

    async def cache_clear(self, request: Request) -> Response:
        """Drop both cache tiers (the lever for a suspected-stale cache,
        e.g. after weights were edited in place); returns what went."""
        from ..cache.store import get_tile_cache

        tile_cache = get_tile_cache()
        if tile_cache is None:
            return json_response({"enabled": False,
                                  "hint": "tile result cache runs on masters with CDT_CACHE=1"})
        payload = tile_cache.clear()
        payload["enabled"] = True
        return json_response(payload)
