"""In-process chaos harness: the elastic USDU master/worker loop under a
scripted fault plan, hermetic (no sockets, no model).

The port's own copy of the scenarios of comfyui_distributed_tpu/
resilience/chaos.py whose modules the port has: `run_chaos_usdu`,
`run_chaos_poison`, `run_chaos_master_crash` and `run_chaos_cancel`. The
harness runs `run_master_elastic` against worker THREADS that pull from
the same JobStore (the production protocol shape) while a seeded
`FaultInjector` kills workers mid-tile, injects latency, or drops
heartbeats on a scripted schedule. The assertion chaos
tests make is strong: the blended output of a faulted run is
BIT-IDENTICAL to the fault-free run.

Two properties make that possible:

1. determinism of the work itself: a tile's noise comes from the tiles'
   noise by its GLOBAL index (ops/upscale.py::TileNoise, a generator
   seeded by (seed, tile index)), so a requeued tile reproduces exactly
   whichever participant re-runs it. The harness stubs the diffusion
   processor (graph/usdu_elastic.py::_tile_processor) with a cheap
   deterministic op whose outputs are exact multiples of 1/255, so the
   PNG envelope worker tiles travel in is lossless and master-local and
   worker-computed tiles are bit-equal;
2. determinism of the blend: sequential feathered compositing is
   order-dependent where tiles overlap, and arrival order is a race. The
   harness sets CDT_DETERMINISTIC_BLEND=1 for the run (sorted-order
   deferred compositing, ops/tiles.py::DeterministicHostCanvas), so the
   canvas does not depend on who finished first.

Fault-plan op names the harness exposes (resilience/faults.py grammar):

    chaos:<worker>:pull     before a worker's pull RPC
    chaos:<worker>:pulled   after a successful pull (crash here =
                            crash-after-pull: tile assigned, never
                            submitted; the requeue path must cover it)
    chaos:<worker>:submit   before a worker's submit RPC
    store:heartbeat:<id>    JobStore heartbeat recording (drop = the
                            master never sees the beat)
    store:pull:<id> / store:submit:<id>   JobStore RPC surfaces

`run_chaos_master_crash` extends the harness to the MASTER's own death:
phase 1 runs the elastic loop with the write-ahead journal attached and
a fault plan that kills the master mid-job (after a pull, or after a
partial submit: `crash@store:pull:master#k` / `crash@store:submit:
master#k`); phase 2 is the restarted process, a fresh JobStore recovered
from the journal directory, which drains the job. The acceptance is the
same bit-identical canvas the worker-crash scenarios give. Its `work`
keyword (port-only) runs a real model's tile processor instead of the
stub, as the card's smoke run does on SDXL. `run_chaos_cancel` cancels a
job mid-flight with the journal attached and a standby replica teed in.

Tensors live on `device`: the card unless the caller asks for the CPU
(the tests do). Arguments whose modules the port has not got yet raise
NotImplementedError naming the ROADMAP step that brings them back:
`tile_batch` > 1 (step 7b: the port's GrantSampler is K = 1),
`mesh_devices` > 1 (step 8) and `device_canvas` (step 7j). The JAX
harness's failover, region and cross-job scenarios come back with the
steps that port their modules.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
import types
from typing import Any, Callable, Optional, Sequence
from unittest import mock

import numpy as np
import torch

from ..telemetry import Tracer, get_tracer, set_tracer
from ..utils.logging import debug_log
from .faults import FaultAction, FaultInjected, FaultInjector

_WAITING = {
    "tile_batch": "step 7b (the cross-job tier: the port's GrantSampler runs one tile a "
                  "dispatch, K = 1)",
    "mesh_devices": "step 8 (the mesh tier)",
    "device_canvas": "step 7j (DeviceCanvas)",
}


def _refuse_waiting(**args: tuple[Any, bool]) -> None:
    """NotImplementedError for the first argument, given as (its value,
    whether the value needs a module the port has not got yet), that
    does, naming the step that brings it."""
    for name, (value, waits) in args.items():
        if waits:
            raise NotImplementedError(
                f"run_chaos_*({name}={value!r}) waits for ROADMAP.md Queue 1 "
                f"{_WAITING[name]}")


class FakeClock:
    """Deterministic monotonic clock for trace timestamps: every call
    advances by a fixed step, so span durations in a chaos trace are a
    pure function of the span SEQUENCE, not wall time."""

    def __init__(self, step: float = 0.001):
        self._step = step
        self._now = 0.0
        self._lock = threading.Lock()

    def __call__(self) -> float:
        with self._lock:
            self._now += self._step
            return self._now


@dataclasses.dataclass
class ChaosResult:
    """Output image + what the injector actually did (tests assert the
    scripted faults FIRED, so a passing run can't be vacuous)."""

    output: np.ndarray
    fired: list[FaultAction]
    crashed_workers: list[str]
    trace_id: str = ""
    # watchdog verdicts (run_chaos_usdu(watchdog=...))
    stragglers: list[str] = dataclasses.field(default_factory=list)
    stalls: list[str] = dataclasses.field(default_factory=list)
    speculated: dict[str, list[int]] = dataclasses.field(default_factory=dict)
    health: dict[str, dict] = dataclasses.field(default_factory=dict)
    # accepted (first-wins) submissions per participant, master included
    tiles_by_worker: dict[str, int] = dataclasses.field(default_factory=dict)
    # the placement policy's snapshot (run_chaos_usdu(placement=...))
    placement: dict = dataclasses.field(default_factory=dict)
    # SLO alert transitions in order (run_chaos_usdu(slo=...)): the
    # engine's transition dicts ({"type": "alert_fired"|"alert_resolved",
    # "slo", "ts", ...})
    alerts: list[dict] = dataclasses.field(default_factory=list)
    # whether an alert was still open when the harness gave up waiting
    slo_active: bool = False
    # incident bundles captured during the run (run_chaos_usdu(
    # incidents=...)): the manager's newest-first listing, and its directory
    incidents: list[dict] = dataclasses.field(default_factory=list)
    incident_dir: str = ""
    # debounce proof: the disposition of a simulated second identical
    # alert inside the debounce window ("" when no alert fired)
    incident_retrigger: str = ""
    # chip-time attribution on a run-local UsageMeter:
    # {"rollup": per-tenant/lane/job view, "totals": the exact ns identity}
    usage: dict = dataclasses.field(default_factory=dict)
    # TileResultCache.stats() after the run (run_chaos_usdu(cache=...))
    cache: dict = dataclasses.field(default_factory=dict)
    # the ops each rule of the plan matched, in plan order
    # (FaultInjector.matches): what a rule's schedule is held against
    rule_matches: list[int] = dataclasses.field(default_factory=list)

    def fired_kinds(self) -> set[str]:
        return {a.kind for a in self.fired}


def _stub_process(tile, tile_index, noise, pos, neg, yx):
    """Deterministic stand-in for the VAE → sample → VAE tile processor,
    with its signature: the tile plus its noise, snapped to the uint8 grid
    (multiples of 1/255) on the tile's device, so the PNG envelope is
    lossless and master-local results are bit-equal to worker results.
    The division is by a tensor on the tile's device: CUDA divides by a
    host scalar as a multiply by its reciprocal, one ulp away from the
    k / 255 a decoded PNG holds."""
    jitter = noise(int(tile_index), tuple(tile.shape)).to(tile.device)
    noisy = torch.clamp(tile + 0.05 * jitter, 0.0, 1.0)
    levels = torch.tensor(255.0, dtype=noisy.dtype, device=noisy.device)
    return torch.round(noisy * 255.0) / levels


@contextlib.contextmanager
def _ensure_server_loop():
    """All JobStore asyncio state must live on ONE loop; start a
    control-plane loop thread if the process has none."""
    from ..utils.async_helpers import ServerLoopThread, get_server_loop

    existing = get_server_loop()
    if existing is not None and existing.is_running():
        yield
        return
    thread = ServerLoopThread(name="cdt-chaos-loop")
    thread.start()
    try:
        yield
    finally:
        thread.stop()


def _stub_bundle(device: torch.device):
    """What run_master_elastic reads of a bundle when its processor is the
    stub: the device (the noise, the tiles) and, with a tile cache, the
    weights fingerprint's fields (cache/keys.py::bundle_fingerprint: a
    model name, no backbone, no VAE)."""
    return types.SimpleNamespace(device=device, model_name="chaos-stub", unet=None, vae=None)


def _seeded_image(seed: int, h: int, w: int, device: torch.device) -> torch.Tensor:
    """The run's [1, h, w, 3] input, the JAX harness's draw."""
    host = np.random.default_rng(seed).random((1, h, w, 3)).astype(np.float32)
    return torch.from_numpy(host).to(device)


def _worker_tiles(image, upscale_by: float, tile: int, padding: int):
    """(grid, extracted tiles) of the master's own preprocessing, made once
    for every worker thread before they start: per-tile determinism means
    the only thing identity changes is WHO computed a tile, and a thread
    that resized on its own could come to the job after another worker
    had drained it."""
    from ..ops import upscale as upscale_ops

    with torch.inference_mode():
        _, grid, extracted = upscale_ops.prepare_upscaled_tiles(
            image, upscale_by, tile, padding, "bicubic", None)
    return grid, extracted


def _elastic_patches(stack: contextlib.ExitStack, elastic) -> None:
    """The stub processor on the master's seam, and the deterministic
    blend, for one run (restored when `stack` closes)."""
    stack.enter_context(mock.patch.object(elastic, "_tile_processor",
                                          lambda *a, **k: _stub_process))
    stack.enter_context(mock.patch.dict(os.environ, {"CDT_DETERMINISTIC_BLEND": "1"}))


def run_chaos_usdu(
    seed: int = 0,
    fault_plan: Optional[str] = None,
    *,
    workers: Sequence[str] = ("w1", "w2"),
    image_hw: tuple[int, int] = (64, 64),
    tile: int = 64,
    padding: int = 16,
    upscale_by: float = 2.0,
    worker_timeout: float = 0.6,
    job_id: str = "chaos-job",
    trace_jsonl: Optional[str] = None,
    watchdog: Optional[dict] = None,
    placement: Optional[dict] = None,
    tile_batch: int = 1,
    pipeline: bool = True,
    prefetch: bool = False,
    journal_dir: Optional[str] = None,
    mesh_devices: int = 0,
    slo: Optional[dict] = None,
    incidents: Optional[dict] = None,
    cache=None,
    device_canvas: bool = False,
    device: str = "cuda",
    noise: Optional[Callable[[int, tuple], Any]] = None,
) -> ChaosResult:
    """One in-process elastic USDU run under `fault_plan`; returns the
    blended [B, H, W, C] image (on the host) plus the faults that actually
    fired. `fault_plan=None` is the fault-free reference run.

    The whole run executes under a fake-clock tracer (one span tree,
    trace id `exec_chaos_<seed>`): master and worker tile stages are
    recorded deterministically. `trace_jsonl` exports the spans to that
    path.

    Worker threads start BEFORE the master and park on the JobStore's
    creation signal (`wait_for_tile_job`), so they contend for tiles from
    the first instant of the job: plans that slow the master's pulls
    (`latency(..)@store:pull:master`) make worker participation
    deterministic instead of a race the master usually wins. The
    workers' tiles are prepared once before they start, the master
    starts only when every worker thread is ready, and the workers' first
    pulls go out together (two barriers), so no worker comes late to a
    job another one drained.

    `worker_timeout` reaches the master through its config
    (settings.worker_timeout_seconds, utils/config.py). `noise(tile_index,
    shape)` is the tiles' noise of master and workers alike (default the
    port's TileNoise of `seed` on `device`; the parity tests hand it the
    JAX package's per-tile draw).

    `watchdog`: a dict of Watchdog overrides (may be empty) runs a live
    straggler/stall monitor over the harness store, fed by the store's
    latency sink, pushing stragglers into a PRIVATE HealthRegistry and
    speculating stalled in-flight tiles through the real requeue path.
    Verdicts land in ChaosResult.stragglers / .stalls / .speculated /
    .health. The harness defaults are tight (50 ms interval, 300 ms stall
    window, min_samples=1) so sub-second chaos plans trigger real
    detections.

    `placement`: a dict of PlacementPolicy overrides (may be empty) runs
    cost-aware weighted placement over the harness store: worker threads
    pull speed-sized grants through `JobStore.pull_tasks`, the policy's
    EWMA is fed by the same latency sink, and tail pulls from slow or
    suspect workers are trimmed. Harness defaults: min_samples=1,
    base_batch=2, max_batch=4, tail_tiles=1. Accepted submissions per
    participant land in ChaosResult.tiles_by_worker and the policy's
    snapshot in ChaosResult.placement.

    `slo`: a dict of overrides (may be empty) runs a live burn-rate SLO
    engine (telemetry/slo.py) over the harness store's latency stream: one
    `tile_latency` spec with harness-tight windows (threshold 0.15 s, one
    (1 s, 0.25 s) burn rule, objective 0.9, resolve hold 50 ms). The
    engine steps on every latency sample; after the run the harness keeps
    stepping (bounded, 5 s) until the alert resolves. Transitions land in
    ChaosResult.alerts. Keys: ``threshold_s``, ``objective``, ``long_s``,
    ``short_s``, ``burn_threshold``, ``resolve_hold_s``, ``min_events``.

    `incidents`: ``{"dir": <path>, ...overrides}`` runs a live
    IncidentManager (telemetry/incidents.py) over the run: the flight
    recorder taps the bus, a harness FleetRegistry retains per-worker
    tile-rate series from the latency stream, and the manager's bus tap
    turns the SLO engine's `alert_fired` into a debug-bundle capture.
    Overrides beyond ``dir`` are IncidentManager keywords (harness
    defaults: debounce 60 s, no global rate limit, 8 bundles). Bundles
    land newest first in ChaosResult.incidents (+ .incident_dir).

    `cache`: a TileResultCache installed for the run (the process's is
    swapped back after it): the master probes it before it creates the
    job and settles the hits with the creation. Counters land in
    ChaosResult.cache.

    `pipeline`/`prefetch`: worker threads always run the production
    TilePipeline; `pipeline=False` runs its stages serially, and
    `prefetch=True` enables the one-grant-ahead pull stage. Defaults keep
    claim timing deterministic (no prefetch).

    `journal_dir`: the store journals every transition into a
    DurabilityManager on that directory (closed when the run ends).

    Every run restores the process-wide tracer, usage meter, tile cache
    and environment, also when it raises; the injector it builds is the
    store's and the harness's own, never installed process-wide.
    """
    _refuse_waiting(tile_batch=(tile_batch, int(tile_batch) > 1),
                    mesh_devices=(mesh_devices, int(mesh_devices) > 1),
                    device_canvas=(device_canvas, bool(device_canvas)))
    from ..graph import ExecutionContext
    from ..graph import usdu_elastic as elastic
    from ..graph.tile_pipeline import GrantSampler, TilePipeline, stage_span
    from ..jobs import JobStore
    from ..ops import upscale as upscale_ops
    from ..telemetry.usage import UsageMeter, set_usage_meter
    from ..utils import image as img_utils
    from ..utils.async_helpers import run_async_in_server_loop
    from ..utils.exceptions import JobQueueError

    dev = torch.device(device)
    injector = FaultInjector(fault_plan) if fault_plan else None
    store = JobStore(fault_injector=injector)
    durability = None
    if journal_dir:
        # the standard scenarios with the write-ahead seam attached
        from ..durability import DurabilityManager

        durability = DurabilityManager(journal_dir)
        store.journal_sink = durability.record
    wd = None
    wd_health = None
    latency_sinks: list[Callable[[str, float], None]] = []
    if watchdog is not None:
        from ..telemetry.watchdog import Watchdog
        from .health import HealthRegistry

        wd_health = HealthRegistry()
        wd_kwargs = dict(interval=0.05, stall_seconds=0.3, min_samples=1, straggler_factor=4.0)
        wd_kwargs.update(watchdog)
        wd = Watchdog(store=store, health=wd_health, **wd_kwargs)
        latency_sinks.append(wd.record_latency)
    slo_engine = None
    if slo is not None:
        from ..telemetry.slo import BurnRule, SLOEngine, SLOSpec
        from ..telemetry.timeseries import SeriesStore

        slo_kwargs = dict(threshold_s=0.15, objective=0.9, long_s=1.0, short_s=0.25,
                          burn_threshold=1.0, resolve_hold_s=0.05, min_events=2)
        slo_kwargs.update(slo)
        spec = SLOSpec(
            name="tile_latency",
            description="chaos-harness tile pull->submit latency",
            objective=slo_kwargs["objective"],
            kind="latency",
            threshold_s=slo_kwargs["threshold_s"],
            rules=(BurnRule(long_s=slo_kwargs["long_s"], short_s=slo_kwargs["short_s"],
                            burn_threshold=slo_kwargs["burn_threshold"]),),
            resolve_hold_s=slo_kwargs["resolve_hold_s"],
            min_events=slo_kwargs["min_events"],
        )
        # fine raw buckets, so sub-second windows have real resolution
        slo_engine = SLOEngine(specs=(spec,), store=SeriesStore(raw_step=0.05, raw_points=4096))

        def _slo_sink(_wid: str, seconds: float) -> None:
            slo_engine.note_latency("tile_latency", seconds)
            slo_engine.step()

        latency_sinks.append(_slo_sink)
    incident_manager = None
    if incidents is not None:
        from ..telemetry.fleet import S_WORKER_TILES_PER_S, FleetRegistry
        from ..telemetry.flight import get_flight_recorder
        from ..telemetry.incidents import IncidentManager

        if not incidents.get("dir"):
            raise ValueError("incidents requires a 'dir' key")
        get_flight_recorder()  # tap the bus before anything publishes
        incident_fleet = FleetRegistry()
        inc_kwargs = dict(debounce_s=60.0, min_interval_s=0.0, max_bundles=8)
        inc_kwargs.update({k: v for k, v in incidents.items() if k != "dir"})
        incident_manager = IncidentManager(str(incidents["dir"]), **inc_kwargs)
        incident_manager.sources["store"] = store.stats_unlocked
        if wd_health is not None:
            incident_manager.sources["health"] = wd_health.snapshot
        if slo_engine is not None:
            incident_manager.sources["slo"] = slo_engine.status
        incident_manager.sources["fleet"] = lambda: incident_fleet.status(since_s=600.0)

        def _fleet_sink(wid: str, seconds: float) -> None:
            # the straggler's slow rate is the evidence the bundle's fleet
            # window must carry
            incident_fleet.store.record(S_WORKER_TILES_PER_S,
                                        (1.0 / seconds) if seconds > 0 else 0.0, worker_id=wid)

        # FIRST in the fan-out: the sample that makes the SLO engine fire
        # (and so capture) must be in the fleet series when the writer
        # thread reads them
        latency_sinks.insert(0, _fleet_sink)
    policy = None
    if placement is not None:
        from ..scheduler.placement import PlacementPolicy

        pl_kwargs = dict(min_samples=1, base_batch=2, max_batch=4, tail_tiles=1,
                         health=wd_health)
        pl_kwargs.update(placement)
        policy = PlacementPolicy(**pl_kwargs)
        store.placement = policy
        latency_sinks.append(policy.record_latency)
    if latency_sinks:
        store.latency_sink = lambda wid, sec: [sink(wid, sec) for sink in latency_sinks]
    ctx = ExecutionContext(
        device=str(dev), server=types.SimpleNamespace(job_store=store),
        config={"workers": [], "settings": {"worker_timeout_seconds": worker_timeout}})
    bundle = _stub_bundle(dev)
    crashed: list[str] = []
    trace_id = f"exec_chaos_{seed}"
    chaos_tracer = Tracer(clock=FakeClock())

    h, w = image_hw
    image = _seeded_image(seed, h, w, dev)
    pos = neg = torch.zeros((1, 4, 8), dtype=torch.float32, device=dev)
    tile_noise = noise or upscale_ops.default_noise(seed, dev)

    accepted_by_worker: dict[str, int] = {wid: 0 for wid in workers}
    grid, extracted = _worker_tiles(image, upscale_by, tile, padding)
    ready = threading.Barrier(len(workers) + 1, timeout=30)
    # every worker's first pull goes out together, so one that woke late
    # does not find the job drained by another
    first_pulls = threading.Barrier(max(1, len(workers)), timeout=10)

    def worker_body(wid: str) -> None:
        ready.wait()
        job = run_async_in_server_loop(store.wait_for_tile_job(job_id, grace_seconds=20),
                                       timeout=30)
        if job is None:
            return
        # the worker threads join the run's trace
        tracer = get_tracer()
        token = tracer.activate(trace_id)
        sampler = GrantSampler(_stub_process, extracted, grid.positions, None, None, tile_noise,
                               role="worker", job_id=job_id)
        flush_pending: dict[int, list] = {}

        pulled_once = []

        def pull():
            if not pulled_once:
                pulled_once.append(True)
                try:
                    first_pulls.wait()
                except threading.BrokenBarrierError:
                    pass  # a worker that never pulls (its job never came)
            if injector is not None:
                injector.check_blocking(f"chaos:{wid}:pull")
            # pull_tasks, the production grant path: one tile without a
            # placement policy, speed-sized grants with one
            return run_async_in_server_loop(
                store.pull_tasks(job_id, wid, timeout=0.2), timeout=10) or None

        def sample(chunk):
            if injector is not None:
                # the per-tile crash point AFTER assignment, BEFORE compute
                for _t in chunk:
                    injector.check_blocking(f"chaos:{wid}:pulled")
            with torch.inference_mode():
                return sampler.sample(chunk)

        def emit(tile_idx, arr):
            flush_pending[int(tile_idx)] = [
                {"batch_idx": i, "image": img_utils.encode_image_data_url(arr[i])}
                for i in range(arr.shape[0])
            ]

        def flush(is_final):
            if not flush_pending:
                return
            grouped = dict(flush_pending)
            flush_pending.clear()
            if injector is not None:
                for _t in sorted(grouped):
                    injector.check_blocking(f"chaos:{wid}:submit")
            with stage_span("submit", "worker", sorted(grouped)[0], batch=sorted(grouped),
                            worker_id=wid):
                accepted = run_async_in_server_loop(store.submit_flush(job_id, wid, grouped),
                                                    timeout=10)
            accepted_by_worker[wid] += accepted

        def heartbeat():
            try:
                run_async_in_server_loop(store.heartbeat(job_id, wid), timeout=10)
            except Exception:  # noqa: BLE001 - liveness is best effort
                pass

        def release(idxs):
            run_async_in_server_loop(store.release_tasks(job_id, wid, idxs), timeout=10)

        try:
            TilePipeline(
                pull=pull, sample=sample, chunks=sampler.chunks, to_host=sampler.collect,
                emit=emit, flush=flush, heartbeat=heartbeat, release=release, role="worker",
                span_attrs={"worker_id": wid}, threaded=pipeline, prefetch=prefetch,
            ).run()
        except FaultInjected as exc:
            # a simulated crash: the thread dies with a tile assigned and
            # unsubmitted; the master's requeue path must recover it
            debug_log(f"chaos worker {wid} died: {exc}")
            crashed.append(wid)
        except JobQueueError:
            pass  # the master cleaned the job up while this worker pulled
        finally:
            tracer.deactivate(token)

    threads = [threading.Thread(target=worker_body, args=(wid,), daemon=True)
               for wid in workers]

    previous_tracer = get_tracer()
    if incident_manager is not None:
        # the writer thread and the bus tap start right before the guarded
        # try, so any raise below reaches the arm that stops them
        incident_manager.start()
    set_tracer(chaos_tracer)
    usage_meter = UsageMeter()
    try:
        with contextlib.ExitStack() as stack:
            stack.enter_context(_ensure_server_loop())
            # run-local chip-time attribution: master, worker threads and
            # the store's waste notes meter into this meter (restored on
            # exit), so the result's usage block is this run's alone
            stack.callback(set_usage_meter, set_usage_meter(usage_meter))
            if cache is not None:
                from ..cache.store import set_tile_cache

                stack.callback(set_tile_cache, set_tile_cache(cache))
            if wd is not None:
                # after the loop exists (speculation goes through it);
                # stopped (LIFO) before the loop shuts down
                wd.start()
                stack.callback(wd.stop)
            _elastic_patches(stack, elastic)
            token = chaos_tracer.activate(trace_id)
            try:
                with chaos_tracer.span("chaos_usdu", trace_id=trace_id, seed=seed,
                                       fault_plan=fault_plan or ""):
                    for t in threads:
                        t.start()
                    ready.wait()
                    out = elastic.run_master_elastic(
                        bundle, image, pos, neg, job_id=job_id,
                        enabled_worker_ids=list(workers), upscale_by=upscale_by, tile=tile,
                        padding=padding, steps=1, sampler="euler", scheduler="karras", cfg=1.0,
                        denoise=0.3, seed=seed, context=ctx, noise=tile_noise,
                    )
                    for t in threads:
                        t.join(timeout=30)
            finally:
                chaos_tracer.deactivate(token)
        if trace_jsonl:
            chaos_tracer.write_jsonl(trace_id, trace_jsonl)
    except BaseException:
        # a raising run must not leak the incident plane (stop is
        # idempotent)
        if incident_manager is not None:
            incident_manager.stop()
        raise
    finally:
        set_tracer(previous_tracer)
        if durability is not None:
            durability.close()
    if slo_engine is not None and slo_engine.is_active("tile_latency"):
        # the straggler is quarantined and the job is done: no new bad
        # samples can arrive, so evaluation must resolve the alert once
        # the short window drains past the resolve hold (bounded: a stuck
        # alert is an engine bug the tests read from slo_active)
        deadline = time.monotonic() + 5.0
        while slo_engine.is_active("tile_latency") and time.monotonic() < deadline:
            slo_engine.step()
            time.sleep(0.02)
    incident_list: list[dict] = []
    incident_retrigger = ""
    if incident_manager is not None:
        # every queued capture is written before the listing
        incident_manager.flush(10.0)
        if slo_engine is not None:
            fired = [a for a in slo_engine.history if a["type"] == "alert_fired"]
            if fired:
                # debounce proof: a second identical alert inside the
                # window must capture nothing
                incident_retrigger = incident_manager.trigger(
                    "alert_fired", key=str(fired[0].get("slo", "")),
                    context={"resimulated": True})
                incident_manager.flush(5.0)
        incident_list = incident_manager.list_bundles()
        incident_manager.stop()
    # every tile is accepted exactly once (first result wins), so the
    # master's share is the remainder
    _, _, grid = upscale_ops.plan_grid(h, w, upscale_by, tile, padding, None)
    tiles_by_worker = dict(accepted_by_worker)
    tiles_by_worker["master"] = grid.num_tiles - sum(accepted_by_worker.values())
    return ChaosResult(
        output=out.detach().to("cpu").numpy(),
        fired=list(injector.fired) if injector is not None else [],
        crashed_workers=crashed,
        trace_id=trace_id,
        stragglers=list(wd.stragglers_flagged) if wd is not None else [],
        stalls=list(wd.stalls_detected) if wd is not None else [],
        speculated=dict(wd.speculated) if wd is not None else {},
        health=wd_health.snapshot() if wd_health is not None else {},
        tiles_by_worker=tiles_by_worker,
        placement=policy.snapshot() if policy is not None else {},
        alerts=list(slo_engine.history) if slo_engine is not None else [],
        slo_active=slo_engine.is_active("tile_latency") if slo_engine is not None else False,
        incidents=incident_list,
        incident_dir=str(incidents["dir"]) if incidents else "",
        incident_retrigger=incident_retrigger,
        usage={"rollup": usage_meter.rollup(), "totals": usage_meter.totals()},
        cache=cache.stats() if cache is not None else {},
        rule_matches=injector.matches() if injector is not None else [],
    )


# --------------------------------------------------------------------------
# kill-the-master scenarios (durable control plane acceptance)
# --------------------------------------------------------------------------


@dataclasses.dataclass
class TileWork:
    """A real model's tile work for `run_chaos_master_crash(work=...)`, in
    place of the stub processor: the bundle, the [B, H, W, C] input, the
    conditioning as the USDU node receives it, and the node's sampling
    arguments as run_master_elastic takes them (upscale_by, tile, tile_h,
    padding, steps, sampler, scheduler, cfg, denoise, seed,
    upscale_method, mask_blur, tiled_decode, uniform)."""

    bundle: Any
    image: Any
    pos: Any
    neg: Any
    options: dict


@dataclasses.dataclass
class MasterCrashResult:
    """Outcome of a two-phase kill-the-master run: the recovered
    canvas, what recovery found, and proof the crash actually fired."""

    output: np.ndarray
    report: dict
    crash_error: str
    fired: list[FaultAction]
    # seconds of the dying master's run (to its crash, the workers joined),
    # of the restarted master's drain, and of its recovery within it (the
    # replay and the snapshot it writes)
    phase_seconds: dict = dataclasses.field(default_factory=dict)
    # the ops each rule of the plan matched, in plan order
    rule_matches: list[int] = dataclasses.field(default_factory=list)

    def fired_kinds(self) -> set[str]:
        return {a.kind for a in self.fired}


def run_chaos_master_crash(
    seed: int = 0,
    crash_plan: str = "crash@store:pull:master#3",
    *,
    journal_dir: str,
    workers: Sequence[str] = ("w1", "w2"),
    image_hw: tuple[int, int] = (64, 64),
    tile: int = 64,
    padding: int = 16,
    upscale_by: float = 2.0,
    worker_timeout: float = 0.6,
    job_id: str = "chaos-crash-job",
    snapshot_every: int = 4,
    fsync_every: int = 0,
    device: str = "cuda",
    noise: Optional[Callable[[int, tuple], Any]] = None,
    work: Optional[TileWork] = None,
    on_phase: Optional[Callable[[str], None]] = None,
) -> MasterCrashResult:
    """SIGKILL-the-master simulation, in process and deterministic.

    Phase 1 (the process that dies): the elastic USDU loop runs with the
    write-ahead journal attached (`journal_dir`) under a fault plan that
    raises out of one of the MASTER's own store RPCs
    (`crash@store:pull:master#k` = killed after k-1 successful pulls,
    `crash@store:submit:master#k` = killed after a partial submit). The
    abandoned JobStore, like the dead process's memory, is discarded
    with its journal seam detached; worker threads are orphaned
    mid-flight as a real master SIGKILL orphans them, then drained out.

    Phase 2 (the restarted process): a FRESH JobStore is recovered from
    `journal_dir` (snapshot + WAL tail; in-flight and master-volatile
    tiles requeue, durable worker payloads restore to the results queue)
    and a fresh master loop drains the job with no workers.

    Per-tile noise by global tile index makes recomputed tiles reproduce
    exactly; restored worker tiles travel the PNG envelope (lossless for
    the stub's 1/255 grid); the deterministic blend makes compositing
    order irrelevant. So the canvas equals an uninterrupted run's.

    `device` and `noise` as in run_chaos_usdu. `work` (port-only) runs
    the given model's tile processor on the bundle's device instead of
    the stub, with its image, conditioning and sampling arguments
    (`image_hw`, `tile`, `padding`, `upscale_by`, `seed`'s noise and
    `device` are then the work's). `on_phase(name)` is called with
    "phase 1" and "phase 2" just before each phase starts.
    """
    from ..durability import DurabilityManager
    from ..graph import ExecutionContext
    from ..graph import usdu_elastic as elastic
    from ..graph.tile_pipeline import GrantSampler, TilePipeline
    from ..jobs import JobStore
    from ..ops import upscale as upscale_ops
    from ..utils import image as img_utils
    from ..utils.async_helpers import run_async_in_server_loop
    from ..utils.exceptions import JobQueueError

    if work is None:
        dev = torch.device(device)
        h, w = image_hw
        image = _seeded_image(seed, h, w, dev)
        pos = neg = torch.zeros((1, 4, 8), dtype=torch.float32, device=dev)
        bundle = _stub_bundle(dev)
        options = dict(upscale_by=upscale_by, tile=tile, padding=padding, steps=1,
                       sampler="euler", scheduler="karras", cfg=1.0, denoise=0.3, seed=seed)
        tile_noise = noise or upscale_ops.default_noise(seed, dev)
        grid, extracted = _worker_tiles(image, upscale_by, tile, padding)
        process, worker_pos, worker_neg = _stub_process, None, None
    else:
        bundle, image, pos, neg = work.bundle, work.image, work.pos, work.neg
        options = dict(work.options)
        tile_noise = noise or upscale_ops.default_noise(int(options["seed"]), bundle.device)
        with torch.inference_mode():
            _, grid, extracted, worker_pos, worker_neg = elastic._prepare(
                bundle, image, pos, neg, float(options["upscale_by"]), int(options["tile"]),
                int(options["padding"]), options.get("upscale_method", "bicubic"),
                options.get("tile_h"), int(options.get("mask_blur", 0)),
                bool(options.get("uniform", True)))
        process = elastic._tile_processor(
            bundle, grid, int(options["steps"]), options["sampler"], options["scheduler"],
            float(options["cfg"]), float(options["denoise"]),
            bool(options.get("tiled_decode", False)))
    ready = threading.Barrier(len(workers) + 1, timeout=60)

    def worker_body(store: Any, wid: str) -> None:
        ready.wait()
        job = run_async_in_server_loop(store.wait_for_tile_job(job_id, grace_seconds=20),
                                       timeout=30)
        if job is None:
            return
        sampler = GrantSampler(process, extracted, grid.positions, worker_pos, worker_neg,
                               tile_noise, role="worker", job_id=job_id)
        flush_pending: dict[int, list] = {}

        def pull():
            return run_async_in_server_loop(
                store.pull_tasks(job_id, wid, timeout=0.2), timeout=10) or None

        def sample(chunk):
            with torch.inference_mode():
                return sampler.sample(chunk)

        def emit(tile_idx, arr):
            flush_pending[int(tile_idx)] = [
                {"batch_idx": i, "image": img_utils.encode_image_data_url(arr[i])}
                for i in range(arr.shape[0])
            ]

        def flush(is_final):
            if not flush_pending:
                return
            grouped = dict(flush_pending)
            flush_pending.clear()
            run_async_in_server_loop(store.submit_flush(job_id, wid, grouped), timeout=10)

        def heartbeat():
            try:
                run_async_in_server_loop(store.heartbeat(job_id, wid), timeout=10)
            except Exception:  # noqa: BLE001 - liveness is best effort
                pass

        try:
            TilePipeline(pull=pull, sample=sample, chunks=sampler.chunks,
                         to_host=sampler.collect, emit=emit, flush=flush, heartbeat=heartbeat,
                         role="worker", span_attrs={"worker_id": wid}, threaded=False).run()
        except JobQueueError:
            pass  # the dead master's job was torn down under us

    def run_master(store: Any) -> torch.Tensor:
        ctx = ExecutionContext(
            device=str(bundle.device), server=types.SimpleNamespace(job_store=store),
            config={"workers": [], "settings": {"worker_timeout_seconds": worker_timeout}})
        return elastic.run_master_elastic(bundle, image, pos, neg, job_id=job_id,
                                          enabled_worker_ids=[], context=ctx,
                                          noise=tile_noise, **options)

    injector = FaultInjector(f"seed={seed};{crash_plan}")
    crash_error = ""
    phase_seconds: dict[str, float] = {}
    with contextlib.ExitStack() as stack:
        stack.enter_context(_ensure_server_loop())
        if work is None:
            _elastic_patches(stack, elastic)
        else:
            stack.enter_context(mock.patch.dict(os.environ, {"CDT_DETERMINISTIC_BLEND": "1"}))

        # --- phase 1: the master that dies ---------------------------------
        if on_phase is not None:
            on_phase("phase 1")
        started = time.perf_counter()
        store1 = JobStore(fault_injector=injector)
        manager1 = DurabilityManager(journal_dir, snapshot_every=snapshot_every,
                                     fsync_every=fsync_every)
        store1.journal_sink = manager1.record
        threads = [threading.Thread(target=worker_body, args=(store1, wid), daemon=True)
                   for wid in workers]
        for t in threads:
            t.start()
        try:
            ready.wait()
            run_master(store1)
            raise RuntimeError(f"master crash plan {crash_plan!r} never fired; the scenario "
                               "would be vacuous")
        except FaultInjected as exc:
            crash_error = str(exc)
            debug_log(f"chaos master died: {exc}")
        finally:
            # the dead process takes its journal seam with it: late worker
            # submissions against the abandoned store are lost as they would
            # be against a closed socket (recovery requeues them)
            store1.journal_sink = None

            async def _teardown():
                async with store1.lock:
                    store1.tile_jobs.pop(job_id, None)

            run_async_in_server_loop(_teardown(), timeout=10)
            for t in threads:
                t.join(timeout=60)
            manager1.close()
        phase_seconds["phase 1"] = time.perf_counter() - started

        # --- phase 2: the restarted master ---------------------------------
        if on_phase is not None:
            on_phase("phase 2")
        started = time.perf_counter()
        store2 = JobStore()
        manager2 = DurabilityManager(journal_dir, snapshot_every=snapshot_every,
                                     fsync_every=fsync_every)
        recovering = time.perf_counter()
        report = manager2.recover(store2)
        phase_seconds["recovery"] = time.perf_counter() - recovering
        store2.journal_sink = manager2.record
        try:
            out = run_master(store2)
        finally:
            manager2.close()
        if bundle.device.type == "cuda":
            torch.cuda.synchronize(bundle.device)
        phase_seconds["phase 2"] = time.perf_counter() - started

    return MasterCrashResult(
        output=out.detach().to("cpu").numpy(),
        report=report.as_json(),
        crash_error=crash_error,
        fired=list(injector.fired),
        phase_seconds=phase_seconds,
        rule_matches=injector.matches(),
    )


# --------------------------------------------------------------------------
# poison-tile quarantine
# --------------------------------------------------------------------------


class _TrimMaster:
    """Placement stub that trims the MASTER out of the pull set (and keeps
    worker grants at one tile): the poison tile must stay with worker
    threads instead of being drained at once by the in-process master."""

    def may_pull(self, worker_id: str, pending: int) -> bool:
        return worker_id != "master"

    def batch_size(self, worker_id: str, pending: int) -> int:
        return 1


@dataclasses.dataclass
class CancelResult:
    """Outcome of a cancel-mid-job run: the refund accounting, the leak
    check, and the terminal-state parity evidence."""

    raised: str                    # exception type the master died with
    reason: str                    # cancel reason it carried
    accounting: dict               # cancel_job's refund accounting
    completed_before_cancel: int
    stats_after: dict              # store stats right after cancel
    state_after_cancel: dict       # manager shadow at cancel time
    journal_jobs_after: dict       # jobs left in the journal at the end
    replica_jobs_after: dict       # jobs left in the replica at the end
    replica_saw_cancel: bool       # the cancel record reached the standby
    idempotent_replay: bool
    cancel_latency_ms: float       # cancel call -> all tiles refunded


def run_chaos_cancel(
    seed: int = 0,
    *,
    journal_dir: str,
    workers: Sequence[str] = ("w1", "w2"),
    image_hw: tuple[int, int] = (96, 96),
    tile: int = 48,
    padding: int = 16,
    upscale_by: float = 2.0,
    worker_timeout: float = 5.0,
    job_id: str = "chaos-cancel-job",
    cancel_after: int = 2,
    tile_delay: float = 0.08,
    reason: str = "chaos",
    device: str = "cuda",
    noise: Optional[Callable[[int, tuple], Any]] = None,
) -> CancelResult:
    """Cancel-mid-job acceptance: the elastic USDU loop runs with the
    write-ahead journal attached and a live standby replica teed in; once
    `cancel_after` tiles have completed, a canceller thread fires
    `JobStore.cancel_job` mid-flight, with tiles pending AND assigned.
    The run then shows:

    - the refund accounting balances (no in-flight assignment survives
      the cancel: `stats_after`);
    - the master loop settles with a terminal JobCancelled instead of
      blending a partial canvas; workers' later submissions drop;
    - the cancel round-trips the journal: the shadow state at cancel
      time shows the job terminally drained, the standby replica applied
      the same record, and replay is idempotent.

    Workers are slowed by `tile_delay` a tile (and the master is trimmed
    out of the pull set) so the cancel lands while work is in flight.
    `device` and `noise` as in run_chaos_usdu.
    """
    from ..durability import DurabilityManager, StandbyReplica
    from ..durability import state as dstate
    from ..durability.recovery import recover_state, verify_idempotent_replay
    from ..graph import ExecutionContext
    from ..graph import usdu_elastic as elastic
    from ..graph.tile_pipeline import GrantSampler, TilePipeline
    from ..jobs import JobStore
    from ..ops import upscale as upscale_ops
    from ..utils import image as img_utils
    from ..utils.async_helpers import run_async_in_server_loop
    from ..utils.exceptions import JobCancelled, JobQueueError

    dev = torch.device(device)
    h, w = image_hw
    image = _seeded_image(seed, h, w, dev)
    pos = neg = torch.zeros((1, 4, 8), dtype=torch.float32, device=dev)
    bundle = _stub_bundle(dev)
    tile_noise = noise or upscale_ops.default_noise(seed, dev)

    store = JobStore()
    store.placement = _TrimMaster()
    manager = DurabilityManager(journal_dir, snapshot_every=64, fsync_every=0)
    store.journal_sink = manager.record

    # live standby: an attach-consistent subscription and the replica's tail
    sub = manager.subscribe_replica()
    replica = StandbyReplica()
    replica.reset(sub.snapshot_state, sub.head_lsn, sub.epoch)
    tail_stop = threading.Event()

    def tail_body() -> None:
        while not tail_stop.is_set():
            sub.wait(0.02)
            for record in sub.pop():
                replica.apply(record)

    tail = threading.Thread(target=tail_body, name="chaos-cancel-standby", daemon=True)
    tail.start()
    grid, extracted = _worker_tiles(image, upscale_by, tile, padding)

    def worker_body(wid: str) -> None:
        job = run_async_in_server_loop(store.wait_for_tile_job(job_id, grace_seconds=20),
                                       timeout=30)
        if job is None:
            return
        sampler = GrantSampler(_stub_process, extracted, grid.positions, None, None, tile_noise,
                               role="worker", job_id=job_id)
        flush_pending: dict[int, list] = {}

        def pull():
            try:
                return run_async_in_server_loop(
                    store.pull_tasks(job_id, wid, timeout=0.2), timeout=10) or None
            except JobQueueError:
                return None

        def sample(chunk):
            time.sleep(tile_delay)  # keep work in flight at cancel time
            with torch.inference_mode():
                return sampler.sample(chunk)

        def emit(tile_idx, arr):
            flush_pending[int(tile_idx)] = [
                {"batch_idx": i, "image": img_utils.encode_image_data_url(arr[i])}
                for i in range(arr.shape[0])
            ]

        def flush(is_final):
            if not flush_pending:
                return
            grouped = dict(flush_pending)
            flush_pending.clear()
            try:
                run_async_in_server_loop(store.submit_flush(job_id, wid, grouped), timeout=10)
            except JobQueueError:
                pass  # cancelled and cleaned up under us

        try:
            TilePipeline(pull=pull, sample=sample, chunks=sampler.chunks,
                         to_host=sampler.collect, emit=emit, flush=flush, role="worker",
                         span_attrs={"worker_id": wid}, threaded=False).run()
        except JobQueueError:
            pass

    cancel_outcome: dict[str, Any] = {}

    def canceller_body() -> None:
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            job = run_async_in_server_loop(store.get_tile_job(job_id), timeout=10)
            if job is not None and len(job.completed) >= cancel_after:
                started = time.monotonic()
                accounting = run_async_in_server_loop(store.cancel_job(job_id, reason=reason),
                                                      timeout=10)
                cancel_outcome["latency_ms"] = (time.monotonic() - started) * 1000.0
                cancel_outcome["accounting"] = accounting
                cancel_outcome["completed"] = len(job.completed)
                with manager._lock:
                    cancel_outcome["state"] = dstate.clone(manager._state)
                cancel_outcome["stats"] = store.stats_unlocked()
                return
            time.sleep(0.005)

    raised = ""
    got_reason = ""
    with contextlib.ExitStack() as stack:
        stack.enter_context(_ensure_server_loop())
        _elastic_patches(stack, elastic)
        ctx = ExecutionContext(
            device=str(dev), server=types.SimpleNamespace(job_store=store),
            config={"workers": [], "settings": {"worker_timeout_seconds": worker_timeout}})
        threads = [threading.Thread(target=worker_body, args=(wid,), daemon=True)
                   for wid in workers]
        canceller = threading.Thread(target=canceller_body, daemon=True)
        for t in threads:
            t.start()
        canceller.start()
        try:
            elastic.run_master_elastic(
                bundle, image, pos, neg, job_id=job_id, enabled_worker_ids=list(workers),
                upscale_by=upscale_by, tile=tile, padding=padding, steps=1, sampler="euler",
                scheduler="karras", cfg=1.0, denoise=0.3, seed=seed, context=ctx,
                noise=tile_noise,
            )
        except JobCancelled as exc:
            raised = type(exc).__name__
            got_reason = exc.reason
        finally:
            for t in threads:
                t.join(timeout=30)
            canceller.join(timeout=30)
            # the replication tee's last records, then the tail stops
            for record in sub.pop(max_items=100000):
                replica.apply(record)
            tail_stop.set()
            tail.join(timeout=10)
            manager.close()

    journal_state, _ = recover_state(journal_dir)
    replica_state = dstate.clone(replica._state)
    state_after_cancel = cancel_outcome.get("state", {})
    job_at_cancel = state_after_cancel.get("jobs", {}).get(job_id, {})
    return CancelResult(
        raised=raised,
        reason=got_reason,
        accounting=cancel_outcome.get("accounting") or {},
        completed_before_cancel=int(cancel_outcome.get("completed", 0)),
        stats_after=cancel_outcome.get("stats") or {},
        state_after_cancel=job_at_cancel,
        journal_jobs_after=dict(journal_state.get("jobs", {})),
        replica_jobs_after=dict(replica_state.get("jobs", {})),
        replica_saw_cancel=bool(job_at_cancel.get("cancelled", False)),
        idempotent_replay=verify_idempotent_replay(journal_dir),
        cancel_latency_ms=float(cancel_outcome.get("latency_ms", 0.0)),
    )


class _PoisonCrash(RuntimeError):
    """Simulated worker-process death on a poison payload."""


@dataclasses.dataclass
class PoisonResult:
    """Outcome of a poison-tile run: quarantine evidence, breaker states,
    and the degraded canvas."""

    output: np.ndarray
    poison_tile: int
    poison_rect: tuple[int, int, int, int]  # y, x, h, w in output coordinates
    crashed_workers: list[str]
    attempts: dict
    quarantined: list[int]
    pardons: list[str]
    health_after: dict
    charged_states: list[str]  # breaker states right after each crash
    # the tiles the journal's tile_quarantine records of the job name
    # ([] without a journal)
    journal_quarantined: list[int]


def run_chaos_poison(
    seed: int = 0,
    *,
    journal_dir: Optional[str] = None,
    workers: Sequence[str] = ("w1", "w2", "w3"),
    image_hw: tuple[int, int] = (96, 96),
    tile: int = 48,
    padding: int = 16,
    upscale_by: float = 2.0,
    worker_timeout: float = 0.4,
    job_id: str = "chaos-poison-job",
    poison_tile: int = 0,
    max_attempts: int = 3,
    poison_policy: str = "degrade",
    device: str = "cuda",
    noise: Optional[Callable[[int, tuple], Any]] = None,
) -> PoisonResult:
    """Poison-tile acceptance: tile ``poison_tile``'s payload crashes EVERY
    worker that samples it (each crash also charges the worker's circuit
    breaker with failure_threshold=1, the harshest cascade setting). The
    store must quarantine the tile after ``max_attempts`` crash-requeues,
    the job must complete DEGRADED (the quarantined region blended from
    the base image, every other tile bit-identical to a clean run), and
    the breaker pardon must leave NO worker quarantined on account of the
    poison. With poison_policy "fail" the master raises JobPoisoned.

    The master is trimmed out of the pull set (`_TrimMaster`) so the
    poison can only travel through workers; its deadline fallback covers
    whatever healthy tiles the dead fleet left behind, skipping the
    quarantined one.

    `journal_dir`: the store journals into a DurabilityManager there
    (write-behind), and `journal_quarantined` lists the tiles its
    tile_quarantine records name. The JAX harness reads the recovered
    state instead, after the master's cleanup record removed the job, so
    its list is always empty."""
    from ..graph import ExecutionContext
    from ..graph import usdu_elastic as elastic
    from ..graph.tile_pipeline import GrantSampler, TilePipeline
    from ..jobs import JobStore
    from ..ops import upscale as upscale_ops
    from ..utils import image as img_utils
    from ..utils.async_helpers import run_async_in_server_loop
    from ..utils.exceptions import JobQueueError
    from .health import HealthRegistry

    dev = torch.device(device)
    h, w = image_hw
    image = _seeded_image(seed, h, w, dev)
    pos = neg = torch.zeros((1, 4, 8), dtype=torch.float32, device=dev)
    bundle = _stub_bundle(dev)
    tile_noise = noise or upscale_ops.default_noise(seed, dev)

    health = HealthRegistry(failure_threshold=1, suspect_threshold=1)
    pardons: list[str] = []
    charged_states: list[str] = []
    captured: dict[str, Any] = {}

    store = JobStore(max_attempts=max_attempts, poison_policy=poison_policy)
    store.placement = _TrimMaster()
    manager = None
    if journal_dir:
        from ..durability import DurabilityManager

        manager = DurabilityManager(journal_dir, snapshot_every=64, fsync_every=0)
        store.journal_sink = manager.record

    def pardon(worker_ids: list) -> None:
        # runs at quarantine time: snapshot the job's final attempt and
        # quarantine books here (the job may be cleaned up before any
        # poller sees them)
        job_obj = store.tile_jobs.get(job_id)
        if job_obj is not None:
            captured["attempts"] = {int(t): int(n) for t, n in dict(job_obj.attempts).items()}
            captured["quarantined"] = sorted(job_obj.quarantined_tiles)
        for wid in worker_ids:
            pardons.append(str(wid))
            health.pardon(str(wid))

    store.poison_pardon = pardon

    crashed: list[str] = []
    crashed_lock = threading.Lock()

    grid, extracted = _worker_tiles(image, upscale_by, tile, padding)

    def worker_body(wid: str) -> None:
        job = run_async_in_server_loop(store.wait_for_tile_job(job_id, grace_seconds=20),
                                       timeout=30)
        if job is None:
            return
        sampler = GrantSampler(_stub_process, extracted, grid.positions, None, None, tile_noise,
                               role="worker", job_id=job_id)
        flush_pending: dict[int, list] = {}

        def pull():
            # a persistent pull: park through empty windows so a requeued
            # poison tile finds a live victim (a worker process keeps
            # polling just so)
            deadline = time.monotonic() + 20
            while time.monotonic() < deadline:
                try:
                    job_obj = run_async_in_server_loop(store.get_tile_job(job_id), timeout=10)
                    if job_obj is None or job_obj.cancelled:
                        return None
                    if len(job_obj.completed) + len(job_obj.quarantined_tiles) \
                            >= job_obj.total_tasks:
                        return None
                    grant = run_async_in_server_loop(
                        store.pull_tasks(job_id, wid, timeout=0.1), timeout=10)
                except JobQueueError:
                    return None
                if grant:
                    return grant
            return None

        def sample(chunk):
            if int(poison_tile) in [int(t) for t in chunk]:
                # the poison payload kills the worker process; the breaker
                # sees the death as a transport failure
                charged_states.append(health.record_failure(wid).value)
                raise _PoisonCrash(f"{wid} crashed sampling tile {poison_tile}")
            with torch.inference_mode():
                return sampler.sample(chunk)

        def emit(tile_idx, arr):
            flush_pending[int(tile_idx)] = [
                {"batch_idx": i, "image": img_utils.encode_image_data_url(arr[i])}
                for i in range(arr.shape[0])
            ]

        def flush(is_final):
            if not flush_pending:
                return
            grouped = dict(flush_pending)
            flush_pending.clear()
            try:
                run_async_in_server_loop(store.submit_flush(job_id, wid, grouped), timeout=10)
            except JobQueueError:
                pass

        try:
            TilePipeline(pull=pull, sample=sample, chunks=sampler.chunks,
                         to_host=sampler.collect, emit=emit, flush=flush, role="worker",
                         span_attrs={"worker_id": wid}, threaded=False).run()
        except _PoisonCrash as exc:
            debug_log(f"chaos poison worker died: {exc}")
            with crashed_lock:
                crashed.append(wid)
        except JobQueueError:
            pass

    with contextlib.ExitStack() as stack:
        stack.enter_context(_ensure_server_loop())
        _elastic_patches(stack, elastic)
        ctx = ExecutionContext(
            device=str(dev), server=types.SimpleNamespace(job_store=store),
            config={"workers": [], "settings": {"worker_timeout_seconds": worker_timeout}})
        threads = [threading.Thread(target=worker_body, args=(wid,), daemon=True)
                   for wid in workers]
        # fallback snapshots of the live job's books while it exists (the
        # pardon hook takes the final one)
        monitor_stop = threading.Event()

        def monitor_body() -> None:
            while not monitor_stop.is_set():
                try:
                    job_obj = run_async_in_server_loop(store.get_tile_job(job_id), timeout=10)
                except Exception:  # noqa: BLE001 - the loop is shutting down
                    return
                if job_obj is not None:
                    if job_obj.attempts:
                        captured["attempts"] = {int(t): int(n)
                                                for t, n in dict(job_obj.attempts).items()}
                    if job_obj.quarantined_tiles:
                        captured["quarantined"] = sorted(job_obj.quarantined_tiles)
                time.sleep(0.02)

        monitor = threading.Thread(target=monitor_body, daemon=True)
        monitor.start()
        for t in threads:
            t.start()
        # ghost ids pad the master's collection deadline (timeout x N) so
        # three crash → timeout → requeue cycles fit before its local
        # fallback would race the quarantine
        padded_ids = list(workers) + [f"ghost{i}" for i in range(9)]
        try:
            out = elastic.run_master_elastic(
                bundle, image, pos, neg, job_id=job_id, enabled_worker_ids=padded_ids,
                upscale_by=upscale_by, tile=tile, padding=padding, steps=1, sampler="euler",
                scheduler="karras", cfg=1.0, denoise=0.3, seed=seed, context=ctx,
                noise=tile_noise,
            )
        finally:
            for t in threads:
                t.join(timeout=30)
            monitor_stop.set()
            monitor.join(timeout=10)
            if manager is not None:
                manager.close()

    journal_quarantined: list[int] = []
    if journal_dir:
        from ..durability import replay_journal

        journal_quarantined = sorted({
            int(t) for record in replay_journal(journal_dir).records
            if record.get("type") == "tile_quarantine" and record.get("job") == job_id
            for t in record.get("tasks", [])})
    _, _, grid = upscale_ops.plan_grid(h, w, upscale_by, tile, padding, None)
    y, x = grid.positions[int(poison_tile)]
    return PoisonResult(
        output=out.detach().to("cpu").numpy(),
        poison_tile=int(poison_tile),
        poison_rect=(int(y), int(x), int(grid.padded_h), int(grid.padded_w)),
        crashed_workers=sorted(crashed),
        attempts=captured.get("attempts", {}),
        quarantined=captured.get("quarantined", []),
        pardons=list(pardons),
        health_after=health.snapshot(),
        charged_states=charged_states,
        journal_quarantined=journal_quarantined,
    )
