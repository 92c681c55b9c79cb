"""DistributedServer: the hub of one master or worker process.

The port's own copy of comfyui_distributed_tpu/api/server.py, on
api/httpd.py instead of aiohttp. It owns:

- the HTTP server with GET/POST /prompt, POST /interrupt,
  GET /history/{prompt_id}, and the /distributed/* routes: the jobs
  (api/job_routes.py), the elastic tier (api/usdu_routes.py), the worker
  processes, websocket dispatch and host info (api/worker_routes.py),
  the config (api/config_routes.py), the telemetry
  (api/telemetry_routes.py), the incidents and the profiler capture
  (api/incident_routes.py, api/profile_routes.py) and the scheduler
  (api/scheduler_routes.py);
- the prompt queue, consumed by one executor thread running the graph
  executor, so compute never blocks the loop; every prompt shares the
  server's `execution_context.pipelines` (loaded models) and `extras`
  (the node cache). A prompt joins the trace its X-CDT-Trace-Id header
  (or the orchestration) names, else its prompt id, and runs under an
  `execute_prompt` span;
- the JobStore of the elastic tier, built with the process's fault
  injector (CDT_FAULT_PLAN: its pull, submit and heartbeat sites run
  under the plan; a FaultInjected raised there answers 500, which a
  worker's retry policies retry), and the scrape-time collectors of
  its live state, bound at start and unbound at stop; the breaker's
  quarantine requeue (a quarantined worker's in-flight tiles go back on
  the queue at once), bound with the store and unbound at stop; on a
  master, push grants (CDT_PUSH_GRANTS, on by default): the store's
  refills call the placement policy's `notify_grants`, which publishes
  the `grant_available` events workers wait on over
  /distributed/events;
- the control plane, as the JAX server wires it by default: the
  `SchedulerControl` (admission lanes and fair share in front of the
  orchestration, its placement policy sizing the store's grants, the
  brownout controller), the `PreemptionCoordinator`, the poison pardon
  into the breaker, the store's latency fan-out (placement, watchdog,
  the tile-latency SLO) and settle sink, the straggler and stall
  `Watchdog` (CDT_WATCHDOG=0 turns it off entirely), and on a master
  the fleet plane (CDT_FLEET=0 turns it off): the `FleetRegistry` with
  its usage aggregator, the `SLOEngine` and the `FleetMonitor`. The
  watchdog and fleet-monitor threads start with the server and stop
  with it, each woken from its interval wait by the stop;
- the incident plane, as the JAX server wires it: every server, master
  and worker, installs the process's flight recorder on the event bus at
  construction (CDT_FLIGHT=0 opts out), and a master with
  CDT_INCIDENT_DIR gets an `IncidentManager` bound to its store,
  scheduler, breakers and fleet plane, whose trigger tap and writer
  thread start with the server and stop with it. The incident and
  profiler-capture routes (api/incident_routes.py,
  api/profile_routes.py) answer on every server;
- the durable control plane, as the JAX server wires it: a master with
  CDT_JOURNAL_DIR builds a `DurabilityManager` (a worker never
  journals), whose append latency feeds the brownout's and the SLO
  engine's journal windows. Before the listener opens, `start()` takes
  the master lease (`quorum_lease_from_env` under CDT_LEASE_PEERS, else
  the flock'd `Lease` on the journal directory; forced, epoch + 1),
  recovers the store from the journal and attaches the write-ahead seam
  (`journal_sink`, `on_worker_seen`), then renews the lease every ttl/3
  on the loop; a `LeaseLost` deposes the server (`deposed`, the
  `master_deposed` event) and the seam's fencing refuses every later
  append. `stop()` detaches the seam and closes the journal last, after
  the listener and the executor, off the loop, then releases the lease.
  The store's RPCs are not gated on the lease's epoch yet (ROADMAP Queue
  1 step 7g).

The same server runs on master and workers; a prompt's hidden inputs
(written by the orchestration) decide each node's role. `device` is
where the nodes run: the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import asyncio
import contextlib
import os
import queue as thread_queue
import threading
import types
from typing import Any, Optional

import torch

from ..graph import ExecutionContext, GraphExecutor, validate_prompt
from ..graph.io_dirs import get_input_dir
from ..jobs import JobStore
from ..utils import config as config_mod
from ..utils.async_helpers import set_server_loop
from ..utils.constants import DEFAULT_MASTER_PORT, WORKER_ENV_FLAG
from ..utils.exceptions import PromptValidationError
from ..utils.logging import debug_log, log
from .httpd import HTTPServer, Request, Response, Router, json_response


class PromptJob:
    def __init__(self, prompt_id: str, prompt: dict, trace_id: str | None = None):
        self.prompt_id = prompt_id
        self.prompt = prompt
        # the execution joins this trace; prompt_id is the fallback so a
        # standalone execution still gets a span tree
        self.trace_id = trace_id or prompt_id
        self.done = threading.Event()
        self.outputs: dict[str, Any] | None = None
        self.error: str | None = None
        self.timings: dict[str, float] = {}


class DistributedServer:
    def __init__(self, port: int = DEFAULT_MASTER_PORT, is_worker: Optional[bool] = None,
                 config_path: str | None = None, host: str | None = None,
                 device: str | None = None):
        self.port = port
        # loopback unless asked: the /distributed/* surface has no auth
        self.host = host or os.environ.get("CDT_HOST") or "127.0.0.1"
        self.is_worker = (is_worker if is_worker is not None
                          else os.environ.get(WORKER_ENV_FLAG) == "1")
        self.config_path = config_path
        self.device = device or "cuda"
        from ..resilience import bind_quarantine_requeue, get_fault_injector
        from ..resilience.health import get_health_registry

        # the process's fault plan (CDT_FAULT_PLAN), consulted at the
        # store's pull, submit and heartbeat sites; None without one
        self.job_store = JobStore(fault_injector=get_fault_injector())

        # breaker → store: a quarantined worker's tiles requeue at once
        self._unbind_health = bind_quarantine_requeue(get_health_registry(), self.job_store)
        self._wire_control_plane()
        # before the incident plane: its manager binds the durability status
        self._wire_durability()
        self._wire_incident_plane()
        self.router = Router()
        self.http: Optional[HTTPServer] = None
        self.loop: Optional[asyncio.AbstractEventLoop] = None
        self._prompt_queue: "thread_queue.Queue[Optional[PromptJob]]" = thread_queue.Queue()
        self._executing = threading.Event()
        self._executor_thread: Optional[threading.Thread] = None
        self._history: dict[str, PromptJob] = {}
        self._interrupt = threading.Event()
        self.execution_context = ExecutionContext(device=self.device)
        # prompts taken over /distributed/worker_ws (not the HTTP fallback)
        self.ws_prompts = 0
        self._unbind_telemetry: Any = lambda: None
        self._register_routes()

    def _wire_control_plane(self) -> None:
        """The scheduler, preemption, watchdog and fleet plane, wired to
        the store as the JAX server wires them (without the region plane;
        the journal is `_wire_durability`'s)."""
        from ..resilience.health import get_health_registry
        from ..scheduler import PreemptionCoordinator, SchedulerControl
        from ..telemetry.watchdog import Watchdog
        from ..utils.constants import FLEET_ENABLED

        health = get_health_registry()
        store = self.job_store
        # CDT_WATCHDOG=0: no latency feed, no thread, no final pass
        self._watchdog_enabled = os.environ.get("CDT_WATCHDOG", "1") != "0"
        self.watchdog = Watchdog(store=store, health=health)
        self.scheduler = SchedulerControl(health=health)
        store.placement = self.scheduler.placement
        self.preempt = PreemptionCoordinator(self.scheduler.queue.lane_order, store)
        store.preempt_policy = self.preempt

        def brownout_evict(level: int, shed_lanes: list) -> None:
            # evaluate() runs on the server loop (admission): schedule the
            # eviction sweep without blocking admission
            try:
                asyncio.get_running_loop().create_task(self.preempt.on_brownout(level, shed_lanes))
            except RuntimeError:
                pass

        self.scheduler.brownout.preempt_hook = brownout_evict

        def poison_pardon(worker_ids: list) -> None:
            for wid in worker_ids:
                health.pardon(str(wid))

        store.poison_pardon = poison_pardon
        sinks = [self.scheduler.placement.record_latency]
        if self._watchdog_enabled:
            sinks.append(self.watchdog.record_latency)

        def latency_fan_out(worker_id: str, seconds: float) -> None:
            for sink in sinks:
                sink(worker_id, seconds)

        store.latency_sink = latency_fan_out
        store.settle_sink = self.scheduler.note_cache_settled
        self.fleet = None
        self.slo = None
        self._fleet_monitor = None
        if FLEET_ENABLED and not self.is_worker:
            from ..telemetry.fleet import FleetMonitor, FleetRegistry
            from ..telemetry.slo import SLOEngine

            self.slo = SLOEngine()
            self.fleet = FleetRegistry()
            self.fleet.bind_master(scheduler=self.scheduler, job_store=store, slo=self.slo)
            self._fleet_monitor = FleetMonitor(self.fleet, slo=self.slo)
            slo_engine = self.slo
            sinks.append(lambda _wid, sec: slo_engine.note_latency("tile_latency", sec))
            # a worker the placement policy forgets leaves the fleet view
            self.scheduler.placement.on_forget = self.fleet.forget_worker
            if self.fleet.usage is not None:
                # CDT_USAGE_COST: DRR cost meters a tenant's measured burn
                self.scheduler.usage_cost = self.fleet.usage.cost_ratio

    def _wire_durability(self) -> None:
        """On a master with CDT_JOURNAL_DIR, the DurabilityManager (files
        and the lease come in start()), its append latency fanned out to
        the brownout's journal window and, with the fleet plane, to the
        journal_latency SLO."""
        from ..durability import DurabilityManager, journal_dir_from_env

        self.durability: Optional[DurabilityManager] = None
        # the lease renewal task, and whether a LeaseLost deposed this server
        self._lease_task: Optional[asyncio.Task] = None
        self.deposed = False
        journal_dir = journal_dir_from_env()
        if not journal_dir or self.is_worker:
            return
        self.durability = DurabilityManager(journal_dir, scheduler=self.scheduler)
        sinks = [self.scheduler.brownout.note_journal_append]
        if self.slo is not None:
            slo_engine = self.slo
            sinks.append(lambda seconds: slo_engine.note_latency("journal_latency", seconds))

        def journal_latency_fan_out(seconds: float) -> None:
            for sink in sinks:
                sink(seconds)

        self.durability.append_latency_sink = journal_latency_fan_out

    async def _start_durability(self) -> None:
        """Take the lease (epoch + 1: the newest claimant on the journal
        directory wins; a deposed holder is fenced by the bump), recover
        the store from the journal, attach the seam, start renewing."""
        from ..durability import Lease, quorum_lease_from_env

        manager = self.durability
        owner = f"master:{self.host}:{self.port}:{os.getpid()}"
        lease = quorum_lease_from_env(owner) or Lease(manager.directory, owner=owner)
        await asyncio.to_thread(lease.acquire, True)
        manager.lease = lease
        # on the loop, as nothing serves yet: the store's jobs and queues
        # are made where they will be used
        manager.recover(self.job_store, scheduler=self.scheduler)
        self.job_store.journal_sink = manager.record
        self.job_store.on_worker_seen = manager.note_worker_activity
        self._lease_task = asyncio.get_running_loop().create_task(
            self._renew_lease_loop(), name="cdt-lease-renew")

    async def _renew_lease_loop(self) -> None:
        """Renew the lease every ttl/3, off the loop. A LeaseLost (another
        claimant took it) deposes this master: renewal stops and the
        journal seam's fencing refuses every later append; any other
        failure is retried."""
        from ..durability import LeaseLost

        lease = self.durability.lease
        while True:
            await asyncio.sleep(max(0.1, lease.ttl / 3.0))
            try:
                await asyncio.to_thread(lease.renew)
            except LeaseLost as exc:
                self.deposed = True
                log(f"master DEPOSED: {exc}; journal appends are fenced, this process serves "
                    "no further authoritative writes")
                from ..telemetry.events import get_event_bus

                get_event_bus().publish("master_deposed", owner=lease.owner, port=self.port)
                return
            except Exception as exc:  # noqa: BLE001 - renewal retries
                debug_log(f"lease renewal failed (will retry): {exc}")

    async def _stop_durability(self) -> None:
        """Detach the seam and close the journal (off the loop: it may
        fsync), then release the lease so the next claimant need not wait
        out its TTL. A failure here is logged, not raised."""
        manager = self.durability
        self.job_store.journal_sink = None
        self.job_store.on_worker_seen = None
        try:
            await asyncio.to_thread(manager.close)
        except Exception as exc:  # noqa: BLE001 - reported, not fatal
            log(f"durability close failed during shutdown: {exc}")
        if manager.lease is not None:
            try:
                await asyncio.to_thread(manager.lease.release)
            except Exception as exc:  # noqa: BLE001 - best effort
                debug_log(f"lease release failed during shutdown: {exc}")

    def _wire_incident_plane(self) -> None:
        """The flight recorder on every server; on a master with
        CDT_INCIDENT_DIR, an incident manager built after the scheduler,
        the fleet and the SLO engine it reads. Its tap and writer thread
        attach in start() and detach in stop()."""
        from ..telemetry import IncidentManager, get_flight_recorder
        from ..utils.constants import incident_dir_from_env

        self.flight = get_flight_recorder()
        self.incidents: Optional[IncidentManager] = None
        incident_dir = incident_dir_from_env()
        if incident_dir and not self.is_worker:
            self.incidents = IncidentManager(incident_dir)
            self.incidents.bind_server(self)

    # --- config ----------------------------------------------------------

    @property
    def config(self) -> dict[str, Any]:
        return config_mod.load_config(self.config_path)

    def media_context(self) -> Any:
        """What graph/io_dirs.py reads the media directories from: this
        server's config, as its nodes see it."""
        return types.SimpleNamespace(config=self.config)

    def input_dir(self) -> str:
        """Where this server's LoadImage reads and /upload/image writes."""
        return get_input_dir(self.media_context())

    # --- routes ----------------------------------------------------------

    def _register_routes(self) -> None:
        from . import (
            config_routes,
            incident_routes,
            job_routes,
            profile_routes,
            scheduler_routes,
            telemetry_routes,
            usdu_routes,
            worker_routes,
        )

        self.router.add_get("/prompt", self.handle_get_prompt)
        self.router.add_post("/prompt", self.handle_post_prompt)
        self.router.add_post("/interrupt", self.handle_interrupt)
        self.router.add_get("/history/{prompt_id}", self.handle_history)
        job_routes.register(self.router, self)
        usdu_routes.register(self.router, self)
        worker_routes.register(self.router, self)
        config_routes.register(self.router, self)
        telemetry_routes.register(self.router, self)
        incident_routes.register(self.router, self)
        profile_routes.register(self.router, self)
        scheduler_routes.register(self.router, self)

    # --- prompt queue ----------------------------------------------------

    @property
    def queue_remaining(self) -> int:
        return self._prompt_queue.qsize() + (1 if self._executing.is_set() else 0)

    async def handle_get_prompt(self, request: Request) -> Response:
        # the ComfyUI probe shape: exec_info.queue_remaining is the
        # busy-ness metric of worker selection and the busy-probe grace
        return json_response({"exec_info": {"queue_remaining": self.queue_remaining}})

    async def handle_post_prompt(self, request: Request) -> Response:
        body = request.json()
        if not isinstance(body, dict):
            return json_response({"error": "invalid json"}, 400)
        prompt = body.get("prompt")
        if not isinstance(prompt, dict):
            return json_response({"error": "missing prompt"}, 400)
        prompt_id = body.get("prompt_id") or f"prompt_{len(self._history)}_{os.getpid()}"
        from ..telemetry import TRACE_HEADER

        trace_id = request.headers.get(TRACE_HEADER.lower()) or None
        try:
            job = self.queue_prompt(prompt, str(prompt_id), trace_id=trace_id)
        except PromptValidationError as exc:
            return json_response({"error": str(exc), "node_errors": exc.node_errors}, 400)
        return json_response({"prompt_id": job.prompt_id, "number": 0})

    async def handle_interrupt(self, request: Request) -> Response:
        self.interrupt()
        return json_response({"interrupted": True})

    async def handle_history(self, request: Request) -> Response:
        prompt_id = request.match_info["prompt_id"]
        job = self._history.get(prompt_id)
        if job is None:
            return json_response({}, 404)
        return json_response({
            "prompt_id": prompt_id,
            "done": job.done.is_set(),
            "error": job.error,
            "outputs": _jsonable_outputs(job.outputs),
            "timings": job.timings,
        })

    def get_job(self, prompt_id: str) -> Optional[PromptJob]:
        """A queued prompt with its outputs once done (None if unknown)."""
        return self._history.get(prompt_id)

    def queue_prompt(self, prompt: dict, prompt_id: str,
                     trace_id: str | None = None) -> PromptJob:
        """Validate, then enqueue; validation errors reach the caller.
        Idempotent per prompt_id: a retried dispatch whose first delivery
        landed does not run the prompt twice. The execution joins
        `trace_id` (else the prompt id)."""
        existing = self._history.get(prompt_id)
        if existing is not None:
            debug_log(f"prompt {prompt_id} already queued; duplicate dropped")
            return existing
        validate_prompt(prompt)
        job = PromptJob(prompt_id, prompt, trace_id=trace_id)
        self._history[prompt_id] = job
        self._prompt_queue.put(job)
        return job

    def interrupt(self) -> None:
        self._interrupt.set()

    # --- executor thread --------------------------------------------------

    def _executor_loop(self) -> None:
        # grad mode is thread-local: this thread runs the models
        with torch.inference_mode():
            while True:
                job = self._prompt_queue.get()
                if job is None:
                    return
                self._execute(job)

    def _execute(self, job: PromptJob) -> None:
        self._executing.set()
        self._interrupt.clear()
        ctx = ExecutionContext(
            device=self.device,
            config=self.config,
            server=self,
            interrupt_event=self._interrupt,
            pipelines=self.execution_context.pipelines,
            extras=self.execution_context.extras,  # the node cache persists
        )
        from ..telemetry import get_tracer

        tracer = get_tracer()
        # this thread joins the prompt's trace: every span opened while it
        # executes (tile pulls, sampler stages) attaches to the
        # distributed execution's tree
        token = tracer.activate(job.trace_id)
        try:
            debug_log(f"executing prompt {job.prompt_id}")
            with tracer.span("execute_prompt", prompt_id=job.prompt_id,
                             role="worker" if self.is_worker else "master"):
                executor = GraphExecutor(ctx)
                job.outputs = executor.execute(job.prompt)
                job.timings = executor.last_timings
        except Exception as exc:  # noqa: BLE001 - reported to the client
            job.error = f"{type(exc).__name__}: {exc}"
            log(f"prompt {job.prompt_id} failed: {job.error}")
        finally:
            tracer.deactivate(token)
            self._executing.clear()
            job.done.set()

    # --- lifecycle --------------------------------------------------------

    async def start(self) -> None:
        """Start the HTTP listener and the executor thread on the running
        loop."""
        self.loop = asyncio.get_running_loop()
        set_server_loop(self.loop)
        from ..utils.constants import PUSH_GRANTS_ENABLED

        placement = self.job_store.placement  # the scheduler's placement policy
        if PUSH_GRANTS_ENABLED and not self.is_worker and placement is not None:
            self.job_store.grant_notifier = placement.notify_grants
        if self.durability is not None:
            # before the executor and the listener: no transition races
            # the replay, and every one after it is journaled
            await self._start_durability()
        self._executor_thread = threading.Thread(target=self._executor_loop,
                                                 name="cdt-executor", daemon=True)
        self._executor_thread.start()
        self.http = HTTPServer(self.router)
        await self.http.start(self.host, self.port)
        # live-state gauges (queue depths, breaker states) are filled at
        # /distributed/metrics scrape time from this server
        from ..telemetry import bind_server_collectors

        self._unbind_telemetry = bind_server_collectors(self)
        if self._watchdog_enabled:
            self.watchdog.start()
        if self._fleet_monitor is not None:
            self._fleet_monitor.start()
        if self.incidents is not None:
            self.incidents.start()
        log(f"{'worker' if self.is_worker else 'master'} server listening on "
            f"{self.host}:{self.port} (device {self.device})")

    async def stop(self) -> None:
        """Stop listening, then let the executor finish its prompt and exit
        (joined off the loop: a prompt in flight still needs the loop);
        the journal closes last."""
        if self._lease_task is not None:
            self._lease_task.cancel()
            with contextlib.suppress(asyncio.CancelledError, Exception):
                await self._lease_task
            self._lease_task = None
        if self.http is not None:
            await self.http.stop()
            self.http = None
        # joined off the loop: a speculation pass in flight blocks the
        # watchdog thread on a coroutine scheduled on this loop
        if self._watchdog_enabled:
            await asyncio.to_thread(self.watchdog.stop)
        if self._fleet_monitor is not None:
            # its step touches only the series store and the bus
            self._fleet_monitor.stop()
        if self.incidents is not None:
            # joined off the loop: the writer may be mid-capture
            await asyncio.to_thread(self.incidents.stop)
        self._unbind_telemetry()
        self._unbind_telemetry = lambda: None
        self._unbind_health()
        self._unbind_health = lambda: None
        self._prompt_queue.put(None)
        if self._executor_thread is not None:
            self.interrupt()
            await asyncio.to_thread(self._executor_thread.join, 30)
            if self._executor_thread.is_alive():
                log("executor thread still running 30 s after stop")
            self._executor_thread = None
        if self.durability is not None:
            # last: every transition acknowledged during shutdown (late
            # worker RPCs, the prompt's cleanup) was journaled
            await self._stop_durability()


def _jsonable_outputs(outputs: dict | None) -> dict:
    if not outputs:
        return {}
    out: dict[str, Any] = {}
    for node_id, result in outputs.items():
        entry: dict[str, Any] = {}
        for item in result if isinstance(result, tuple) else (result,):
            if isinstance(item, dict) and "ui" in item:
                entry.update(item["ui"])
        out[node_id] = entry
    return out
