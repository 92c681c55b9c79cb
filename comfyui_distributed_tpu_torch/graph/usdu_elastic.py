"""Elastic-tier USDU: master/worker loops over HTTP.

The port's own copy of the static (tile-queue) and dynamic (frame-queue)
modes of comfyui_distributed_tpu/graph/usdu_elastic.py, for participants
outside the master's process (or inside it, on their own server):

  worker: poll job ready → pipelined pull/sample/encode/submit stages
          (graph/tile_pipeline.py), heartbeats from the I/O stage →
          final flush
  master: init the tile queue → pull tiles, sample, blend locally while
          draining worker results → on drain, a collection phase with
          heartbeat-timeout requeue (busy-probe grace) → local fallback
          for requeued tiles → the composited canvas

Dynamic mode, for image batches (video frames) at or past the node's
`dynamic_threshold`, queues whole frames instead: a participant pulls a
frame index, runs all of that frame's tiles (`_process_whole_image`)
and submits the frame (`/distributed/submit_image`); the master takes
part, requeues a silent worker's frames, and stacks the frames in
order. A frame's tile noise is seeded by (seed, frame index, tile
index, stream) (`upscale.FrameTileNoise`), so a frame comes out the same
whoever claims it.

The tile processor is ops/upscale.py::_process_tile_fn with the same
`noise` seam as `run_upscale`: the default draws a tile's initial and
step noise from generators seeded by (seed, global tile index, stream),
so a requeued tile is bit-identical wherever it runs. Worker tiles travel as 8-bit PNG data
URLs and composite on the master's host canvas (ops/tiles.py); with
CDT_DETERMINISTIC_BLEND=1 the canvas composites in sorted tile order, so
the image does not depend on which participant finished first.

A job's adapter plan (adapters/) rides the readiness answer: the worker
resolves it against its own catalog (the hashes must match the
master's), and each participant that samples a tile patches its
backbone once per job into a copy (`adapters.patch_params`), released
when the job ends; the bundle it came from, which other jobs read, is
never written. With the tile cache on (cache/, CDT_CACHE=1 or an
installed cache) the master keys every tile before it creates the job,
settles the hits atomically with the job's creation, blends them from
the cache, and stores every tile it blends, its own and the workers'.
The cache is the master's alone, and keys its base bundle with the
plan's content identity. Dynamic mode carries no adapters and no cache,
as in the JAX package.

Telemetry, as in the JAX package: the worker's RPCs carry the trace id
active where its client was made (the X-CDT-Trace-Id header), so the
master's `rpc.*` spans join the execution's tree; each tile of either
role runs its stages under `tile.*` spans (graph/tile_pipeline.py:
both roles dispatch through a `GrantSampler`, which feeds the usage
meter and the transfer ledger); finished tiles count in
cdt_tiles_processed_total{role}, a job wearing adapters in
cdt_adapter_jobs_total, a worker's failed master RPCs in
cdt_worker_master_errors_total{op}, and the master charges tiles the
cache settled to the usage meter's `cached` bucket.

The control plane, as in the JAX package: a worker's pull asks for a
grant of up to CDT_SCHED_MAX_PULL_BATCH tiles (the master's placement
policy sizes it) and runs its tiles one after another through the K = 1
pipeline, one stage span and one usage record a tile; its pulls and
heartbeats advertise one device and piggyback this process's fleet
snapshot (telemetry/fleet.py::local_snapshot) at most once per
CDT_FLEET_SNAPSHOT_SECONDS; a `preempt` answer ends its pulls for the
job, as a drained answer does.

Push grants (CDT_PUSH_GRANTS, on by default), as in the JAX package: a
worker holds the master's /distributed/events stream (`GrantSignal`)
and, after an empty pull, parks up to CDT_PUSH_WAIT seconds on it
before it concludes the queue is drained, so a tile requeued or
speculated after its last pull can still reach it; a pushed
`job_complete` ends the park and a pushed `job_cancelled` aborts
between tiles. It is an accelerator over the pull protocol: a stream
that is down leaves the pure pull loop. Unlike the JAX worker, this one
ships the tiles it has encoded before it parks: the master cannot finish
the job while a worker holds finished tiles, so a park that no earlier
frame cuts short would end on its timeout. What the signal saw (frames,
parks, how each ended) lands in the worker's
`context.extras["grant_signal"]` (None for a job run pull-only), which
/distributed/system_info reports.

Left out, each with its ROADMAP item: the master-URL failover list,
shard routing and fencing epochs (Queue 1 step 7), the cross-job tier
and preemption checkpoints (step 7b), the device canvas and the mesh.
Both roles prep the conditioning for tiles (ControlNet hints and masks
windowed per tile) and take `tiled_decode`.

Every function here enters `torch.inference_mode()` on its own thread:
grad mode is thread-local, and the server runs them on its executor
thread.
"""

from __future__ import annotations

import asyncio
import json
import math
import threading
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..models import pipeline as pl
from ..ops import tiles as tile_ops
from ..ops import upscale as upscale_ops
from ..resilience.policy import (
    http_policy,
    poll_ready_policy,
    retry_async,
    transport_errors,
    work_pull_policy,
)
from ..telemetry import TRACE_HEADER, current_trace_id
from ..telemetry.instruments import (
    adapter_jobs_total,
    tiles_processed_total,
    worker_master_errors_total,
)
from ..utils import constants
from ..utils import image as img_utils
from ..utils.async_helpers import run_async_in_server_loop
from ..utils.config import worker_timeout_seconds
from ..utils.constants import (
    MAX_PAYLOAD_SIZE,
    MAX_TILE_BATCH,
    PAYLOAD_HEADROOM,
    PIPELINE_ENABLED,
    PUSH_GRANTS_ENABLED,
    PUSH_WAIT_SECONDS,
    QUEUE_POLL_INTERVAL_SECONDS,
    deterministic_blend,
)
from ..utils.exceptions import JobCancelled, JobPoisoned, TransientServerError, WorkerError
from ..utils.logging import debug_log, log
from ..utils.network import build_worker_url, parse_master_urls, probe_worker, request_json_async
from .tile_pipeline import GrantSampler, TilePipeline
from .tile_pipeline import stage_span as _stage

_MESH_UNPORTED = ("the multi-device tile tier is not ported yet (ROADMAP.md, Queue 1 item 6: "
                  "the multi-GPU tier)")

# Heartbeat suppression after consecutive failures: a master outage must
# not turn each worker into a request flood while the pull path already
# retries patiently.
HEARTBEAT_BACKOFF_BASE_SECONDS = 1.0
HEARTBEAT_BACKOFF_CAP_SECONDS = 30.0


def _check_ported(mesh: Any) -> None:
    if mesh is not None:
        raise NotImplementedError(_MESH_UNPORTED)


def _finish_job(store, job_id: str) -> None:
    """Remove the job from the store: the collector job the orchestration
    announced for it (its workers' readiness poll), then the tile job,
    whose record stays in `finished`."""
    run_async_in_server_loop(store.cleanup_collector(job_id), timeout=30)
    run_async_in_server_loop(store.cleanup_tile_job(job_id), timeout=30)


def _busy_probe(config: dict):
    """The requeue scan's probe: whether a stale worker of `config` is
    online with a queue (busy on a long tile or frame: given grace)."""

    async def probe_busy(worker_id: str) -> bool:
        worker = next((w for w in config.get("workers", []) if str(w.get("id")) == worker_id),
                      None)
        if worker is None:
            return False
        result = await probe_worker(build_worker_url(worker))
        return bool(result["online"] and (result["queue_remaining"] or 0) > 0)

    return probe_busy


# --------------------------------------------------------------------------
# worker side
# --------------------------------------------------------------------------


class HTTPWorkClient:
    """Worker → master RPCs over `urllib` (utils/network.py), each through
    the shared RetryPolicy: a fixed interval for the readiness poll, a
    patient capped backoff for the pull, the default HTTP policy for
    submits (safe: the master drops duplicate results). Every RPC carries
    the trace id active where the client was made, and a failed one
    counts in cdt_worker_master_errors_total by operation. Pulls and
    heartbeats advertise `devices` (one card) and piggyback the fleet
    snapshot; their answers' `preempt` flag is tracked (absence clears
    it: it is live scheduling pressure, not a latch). One master URL;
    the failover list, shard routing and fencing epochs are ROADMAP
    Queue 1, item 3."""

    def __init__(self, master_url: str, job_id: str, worker_id: str):
        urls = parse_master_urls(master_url)
        self.master_url = urls[0] if urls else str(master_url)
        self.job_id = job_id
        self.worker_id = worker_id
        # captured here, on the executor thread where the dispatched
        # prompt's trace is active; the RPCs run on the server loop,
        # where it is not
        self.trace_id = current_trace_id()
        # the job's adapter plan (wire form), read by poll_ready
        self.adapters: list = []
        # set when a pull response reports the job cancelled; the worker
        # loop's interrupt check reads it
        self.job_cancelled = False
        self.cancel_reason = ""
        # the master's preemption flag on this job, from the last pull or
        # heartbeat answer
        self.preempt_requested = False
        self.preempt_reason = ""
        # the advertised grant capacity: one card a worker (the mesh is
        # ROADMAP Queue 1 item 6)
        self.devices = 1
        # the fleet snapshot rides at most one RPC per interval (<= 0:
        # never); the first RPC always carries one, however recently the
        # host's monotonic clock started
        self._telemetry_interval = constants.FLEET_SNAPSHOT_SECONDS
        self._telemetry_last = -math.inf
        # heartbeats run on one thread (the pipeline's I/O stage)
        self._hb_failures = 0
        self._hb_suppressed_until = 0.0

    def _maybe_telemetry(self) -> Optional[dict]:
        """The fleet snapshot to piggyback on this RPC, or None when one
        rode recently (or the piggyback is off). Never raises: telemetry
        must not break the work protocol."""
        if self._telemetry_interval <= 0:
            return None
        now = time.monotonic()
        if now - self._telemetry_last < self._telemetry_interval:
            return None
        self._telemetry_last = now
        try:
            from ..telemetry.fleet import local_snapshot

            return local_snapshot(role="worker")
        except Exception as exc:  # noqa: BLE001 - an advisory payload
            debug_log(f"fleet snapshot build failed: {exc}")
            return None

    def _work_payload(self) -> dict:
        """The fields of a pull or heartbeat: the ids, the advertised
        capacity and, when one is due, the fleet snapshot."""
        payload = {"job_id": self.job_id, "worker_id": self.worker_id, "devices": self.devices}
        snapshot = self._maybe_telemetry()
        if snapshot is not None:
            payload["telemetry"] = snapshot
        return payload

    def _learn_preempt(self, out: dict) -> None:
        self.preempt_requested = bool(out.get("preempt"))
        self.preempt_reason = str(out.get("preempt_reason", ""))

    async def _post(self, path: str, payload: dict, timeout: float = 60.0,
                    op: str = "transport") -> dict:
        headers = {TRACE_HEADER: self.trace_id} if self.trace_id else None
        try:
            status, out = await request_json_async(
                "POST", f"{self.master_url}{path}", payload, timeout=timeout, headers=headers
            )
        except transport_errors():
            worker_master_errors_total().inc(op=op)
            raise
        if status >= 500:
            worker_master_errors_total().inc(op=op)
            raise TransientServerError(f"{path} -> HTTP {status}", self.worker_id)
        if status != 200:
            raise WorkerError(f"{path} -> HTTP {status}", self.worker_id)
        return out if isinstance(out, dict) else {}

    def poll_ready(self) -> bool:
        async def attempt():
            out = await self._post("/distributed/job_status",
                                   {"job_id": self.job_id, "worker_id": self.worker_id},
                                   op="status")
            if not out.get("ready"):
                raise WorkerError(f"job {self.job_id} not ready", self.worker_id)
            self.adapters = list(out.get("adapters") or [])
            return True

        async def poll():
            try:
                return await retry_async(attempt, poll_ready_policy(),
                                         label=f"poll_ready:{self.job_id}")
            except (WorkerError,) + transport_errors():
                return False

        return run_async_in_server_loop(poll(), timeout=None)

    def request_tile(self, batch_max: int = 1) -> Optional[dict]:
        """Pull the next work; None when drained (or the master stayed
        unreachable through the whole pull policy). `batch_max` > 1 asks
        for a grant the master's placement policy sizes: the answer then
        carries `tile_idxs` beside `tile_idx`."""
        payload = self._work_payload()
        if batch_max > 1:
            payload["batch_max"] = int(batch_max)

        async def pull():
            try:
                return await retry_async(
                    lambda: self._post("/distributed/request_image", payload, op="pull"),
                    work_pull_policy(), label=f"request_tile:{self.worker_id}",
                )
            except (WorkerError,) + transport_errors() as exc:
                debug_log(f"request_tile gave up: {exc}")
                return None

        out = run_async_in_server_loop(pull(), timeout=None)
        if out is None:
            return None
        if out.get("cancelled"):
            self.job_cancelled = True
            self.cancel_reason = str(out.get("cancel_reason", ""))
            return None
        self._learn_preempt(out)
        if out.get("tile_idx") is None and out.get("image_idx") is None:
            return None
        return out

    def submit_tiles(self, entries: list[dict], is_final: bool) -> None:
        """Ship a flush. Transport failures and 5xx answers retry; a 4xx is
        the master's verdict and raises."""

        async def send():
            await retry_async(
                lambda: self._post(
                    "/distributed/submit_tiles",
                    {"job_id": self.job_id, "worker_id": self.worker_id, "tiles": entries,
                     "is_final_flush": is_final},
                    timeout=300.0, op="submit",
                ),
                http_policy(), retryable=transport_errors() + (TransientServerError,),
                label=f"submit_tiles:{self.worker_id}",
            )

        run_async_in_server_loop(send(), timeout=600)

    def submit_image(self, image_idx: int, data_url: str, is_last: bool) -> None:
        """Dynamic mode: ship one processed frame; retried as a flush is."""

        async def send():
            await retry_async(
                lambda: self._post(
                    "/distributed/submit_image",
                    {"job_id": self.job_id, "worker_id": self.worker_id,
                     "image_idx": int(image_idx), "image": data_url, "is_last": bool(is_last)},
                    timeout=300.0, op="submit",
                ),
                http_policy(), retryable=transport_errors() + (TransientServerError,),
                label=f"submit_image:{self.worker_id}",
            )

        run_async_in_server_loop(send(), timeout=600)

    def heartbeat(self) -> None:
        """Best-effort liveness beat; after k consecutive failures beats
        are skipped for min(base * 2^(k-1), cap) seconds."""
        if time.monotonic() < self._hb_suppressed_until:
            return

        payload = self._work_payload()

        async def beat():
            try:
                # the eviction side channel: a worker mid-grant may be a
                # tile away from its next pull
                self._learn_preempt(await self._post("/distributed/heartbeat", payload,
                                                     timeout=30.0, op="heartbeat"))
            except (WorkerError,) + transport_errors() as exc:
                self._hb_failures += 1
                backoff = min(HEARTBEAT_BACKOFF_BASE_SECONDS * 2.0 ** (self._hb_failures - 1),
                              HEARTBEAT_BACKOFF_CAP_SECONDS)
                self._hb_suppressed_until = time.monotonic() + backoff
                debug_log(f"heartbeat failed ({self._hb_failures} consecutive; "
                          f"suppressing {backoff:.1f}s): {exc}")
            else:
                self._hb_failures = 0
                self._hb_suppressed_until = 0.0

        run_async_in_server_loop(beat(), timeout=60)

    def return_tiles(self, tile_idxs: list[int]) -> None:
        """Hand claimed-but-unprocessed tiles back so they requeue at once
        (best effort: the master's timeout requeue covers a failure)."""

        async def send():
            try:
                await self._post("/distributed/return_tiles",
                                 {"job_id": self.job_id, "worker_id": self.worker_id,
                                  "tile_idxs": [int(t) for t in tile_idxs]}, timeout=30.0,
                                 op="release")
            except (WorkerError,) + transport_errors() as exc:
                debug_log(f"return_tiles failed: {exc}")

        run_async_in_server_loop(send(), timeout=60)


class GrantSignal:
    """Push-mode grant wakeups (CDT_PUSH_GRANTS): the worker holds the
    master's `/distributed/events` WebSocket, filtered to this job's
    `grant_available`, `job_ready`, `job_complete` and `job_cancelled`
    frames, and a thread Event flips whenever grants land, so a parked
    pull loop wakes the moment work exists.

    An accelerator over the pull protocol only: grants still transfer
    through request_image (a push carries availability, never an
    assignment, so placement, sizing and first-result-wins are
    untouched), and every failure (the handshake refused, the stream
    dropped) degrades to the pull behaviour. The socket follows the
    client's `master_url` through `url_provider`, and reconnects a
    second after a drop.

    Beside the JAX signal it keeps what it saw for the worker's summary
    (`summary`): connections, the stream's `hello` frames and the frames
    of this job by type, and each park with its seconds and what ended it
    (the waking frame's type, or "timeout")."""

    EVENT_TYPES = ("grant_available", "job_ready", "job_complete", "job_cancelled")

    def __init__(self, url_provider: Callable[[], str], job_id: str):
        self.url_provider = url_provider
        self.job_id = job_id
        self._event = threading.Event()
        self._stopped = threading.Event()
        self.connected = False
        self._complete = False
        self._cancelled = False
        self._future: Any = None
        self.connects = 0
        self.frames: dict[str, int] = {}
        self.parks: list[tuple[float, str]] = []
        self._woken_by = ""

    # --- worker-thread side ------------------------------------------------

    def wait_for_grant(self, timeout: float) -> bool:
        """Park until a frame wakes the signal (True) or `timeout` passes
        (False); clears the flag, so the next wait needs a new push. Never
        waits while the stream is down: the pull fallback."""
        if not self.connected:
            return False
        started = time.monotonic()
        fired = self._event.wait(timeout)
        self._event.clear()
        self.parks.append((time.monotonic() - started, self._woken_by if fired else "timeout"))
        return fired

    @property
    def job_complete(self) -> bool:
        return self._complete

    @property
    def job_cancelled(self) -> bool:
        """A pushed `job_cancelled` arrived: the worker's interrupt check
        aborts between tiles without waiting for its next pull."""
        return self._cancelled

    def start(self) -> None:
        from ..utils.async_helpers import get_server_loop

        loop = get_server_loop()
        if loop is None or not loop.is_running():
            return  # no loop, no stream: pure pull mode
        self._future = asyncio.run_coroutine_threadsafe(self._run(), loop)

    def stop(self) -> None:
        self._stopped.set()
        future, self._future = self._future, None
        if future is not None:
            future.cancel()

    def summary(self) -> dict[str, Any]:
        return {
            "job_id": self.job_id,
            "connects": self.connects,
            "frames": dict(sorted(self.frames.items())),
            "parks": [[round(seconds, 6), how] for seconds, how in self.parks],
            "job_complete": self._complete,
            "job_cancelled": self._cancelled,
        }

    # --- server-loop side --------------------------------------------------

    def _on_frame(self, frame: dict) -> bool:
        """Take one frame; True when the stream has nothing more to say
        to this job. The `hello` that opens a stream is counted and wakes
        nothing: it shows the stream delivers."""
        data = frame.get("data") or {}
        if data.get("job_id") not in (None, self.job_id):
            return False
        kind = frame.get("type")
        if kind not in self.EVENT_TYPES + ("hello",):
            return False
        self.frames[kind] = self.frames.get(kind, 0) + 1
        if kind == "hello":
            return False
        if kind == "job_cancelled":
            self._cancelled = True
        if kind in ("job_complete", "job_cancelled"):
            self._complete = True
        self._woken_by = kind
        self._event.set()
        return self._complete

    async def _run(self) -> None:
        from ..utils.websocket import connect_websocket

        while not self._stopped.is_set():
            url = self.url_provider()
            ws_url = "ws" + url[len("http"):] if url.startswith("http") else url
            try:
                async with connect_websocket(
                        f"{ws_url}/distributed/events?types={','.join(self.EVENT_TYPES)}") as ws:
                    self.connected = True
                    self.connects += 1
                    async for text in ws:
                        if self._stopped.is_set():
                            return
                        try:
                            frame = json.loads(text)
                        except ValueError:
                            continue
                        if isinstance(frame, dict) and self._on_frame(frame):
                            return
            except Exception as exc:  # noqa: BLE001 - advisory: degrade to pull
                debug_log(f"grant signal stream to {url} failed: {exc}")
            finally:
                self.connected = False
            if self._stopped.is_set():
                return
            # the pull path works meanwhile; the next attempt follows the
            # client's current master address
            await asyncio.sleep(1.0)


def _flush_threshold_bytes() -> int:
    return MAX_PAYLOAD_SIZE - PAYLOAD_HEADROOM


def _tile_processor(bundle: pl.PipelineBundle, grid: tile_ops.TileGrid, steps: int,
                    sampler: str, scheduler: str, cfg: float, denoise: float,
                    tiled_decode: bool = False) -> Callable:
    """fn(tile, tile_index, noise, pos, neg, yx) → processed tile: the
    local path's processor, in inference mode on whichever thread calls
    it. pos/neg are prepped by prep_cond_for_tiles."""
    process = upscale_ops._process_tile_fn(
        bundle, grid, int(steps), sampler, scheduler, float(cfg), float(denoise),
        bool(tiled_decode)
    )

    def fn(*args):
        with torch.inference_mode():
            return process(*args)

    return fn


def _adapter_processor(bundle: pl.PipelineBundle, wire: list, context, role: str,
                       make_process: Callable) -> tuple[list, Callable]:
    """(resolved specs, a tile processor wearing the plan `wire`). The
    specs are resolved now against this process's catalog, so a hash
    that differs from the master's fails the job before it takes a tile;
    the operands and the patched copy of the backbone are made at the
    processor's first call, so a participant that samples no tile (all
    of them settled from the cache, or taken by others) patches nothing.
    `make_process(bundle)` builds the processor."""
    from ..adapters import get_adapter_catalog, specs_from_wire

    specs = get_adapter_catalog().resolve(specs_from_wire(wire))
    made: list[Callable] = []

    def process(*args):
        if not made:
            made.append(make_process(patched_bundle(bundle, specs, context, role)))
        return made[0](*args)

    return specs, process


def patched_bundle(bundle: pl.PipelineBundle, specs: list, context, role: str):
    """`bundle` with its backbone patched by the resolved plan `specs`
    (operands from the operand cache). Leaves its seconds, operand bytes
    and the operand cache's hits and misses in
    context.extras["adapters"][role]."""
    from ..adapters import bundle_target_map, get_adapter_cache, operands_for_plan, patch_params

    started = time.perf_counter()
    cache = get_adapter_cache()
    before = cache.stats()
    operands = operands_for_plan(specs, bundle_target_map(bundle), cache=cache)
    built = time.perf_counter()
    patched = patch_params(bundle, operands)
    if bundle.device.type == "cuda":
        torch.cuda.synchronize(bundle.device)
    after = cache.stats()
    if context is not None:
        context.extras.setdefault("adapters", {})[role] = {
            "plan": [(s.name, s.strength) for s in specs],
            "operand_bytes": operands.nbytes, "rank_bucket": operands.rank_bucket,
            "operands_s": built - started, "patch_s": time.perf_counter() - built,
            "operand_hits": after["hits"] - before["hits"],
            "operand_misses": after["misses"] - before["misses"],
        }
    log(f"{role}: adapters {[s.name for s in specs]} patched into the backbone "
        f"({operands.nbytes} operand bytes, rank bucket {operands.rank_bucket})")
    return patched


def _prepare(bundle, image, pos, neg, upscale_by, tile, padding, upscale_method, tile_h,
             mask_blur, uniform):
    image = torch.as_tensor(image, dtype=torch.float32).to(bundle.device)
    upscaled, grid, extracted = upscale_ops.prepare_upscaled_tiles(
        image, upscale_by, tile, padding, upscale_method, tile_h,
        mask_blur=mask_blur, uniform=uniform,
    )
    return (upscaled, grid, extracted, upscale_ops.prep_cond_for_tiles(pos, grid),
            upscale_ops.prep_cond_for_tiles(neg, grid))


@torch.inference_mode()
def run_worker_loop(
    bundle: pl.PipelineBundle,
    image,
    pos,
    neg,
    job_id: str,
    worker_id: str,
    master_url: str,
    upscale_by: float,
    tile: int,
    padding: int,
    steps: int,
    sampler: str,
    scheduler: str,
    cfg: float,
    denoise: float,
    seed: int,
    upscale_method: str = "bicubic",
    mask_blur: int = 0,
    uniform: bool = True,
    tiled_decode: bool = False,
    tile_h: int | None = None,
    context=None,
    client: Any = None,
    mesh: Any = None,
    noise: upscale_ops.NoiseFn | None = None,
) -> None:
    """Pull tiles until the master's queue drains, through the staged
    tile pipeline: readback, encode and submit overlap the next tile's
    sampling; results flush in size-aware batches with a heartbeat per
    processed tile (and idle heartbeats while a tile samples).
    CDT_PIPELINE=0 runs the stages serially."""
    _check_ported(mesh)
    _, grid, extracted, pos, neg = _prepare(
        bundle, image, pos, neg, upscale_by, tile, padding, upscale_method, tile_h,
        mask_blur, uniform,
    )
    process = _tile_processor(bundle, grid, steps, sampler, scheduler, cfg, denoise,
                              tiled_decode)
    grant_sampler = GrantSampler(
        process, extracted, grid.positions, pos, neg,
        noise or upscale_ops.default_noise(seed, bundle.device), role="worker", job_id=job_id,
    )
    client = client or HTTPWorkClient(master_url, job_id, worker_id)
    if not client.poll_ready():
        raise WorkerError(f"job {job_id} never became ready", worker_id)
    adapter_wire = getattr(client, "adapters", None) or []
    if adapter_wire:
        # the job's plan: this job samples a patched copy of the backbone
        _, process = _adapter_processor(
            bundle, adapter_wire, context, "worker",
            lambda patched: _tile_processor(patched, grid, steps, sampler, scheduler, cfg,
                                            denoise, tiled_decode))
        grant_sampler = GrantSampler(process, extracted, grid.positions, pos, neg,
                                     grant_sampler.noise, role="worker", job_id=job_id)
        adapter_jobs_total().inc(tier="elastic")

    pending: list[dict] = []
    pending_bytes = 0
    # the I/O stage flushes after each tile, and a puller about to park
    # forces a flush: one lock keeps the two apart
    pending_lock = threading.Lock()
    # a grant of up to CDT_SCHED_MAX_PULL_BATCH tiles a device, which the
    # master's placement policy sizes
    pull_cap = constants.SCHED_MAX_PULL_BATCH * max(1, int(getattr(client, "devices", 1)))

    def emit(tile_idx: int, arr) -> None:
        """One processed tile (host-side [B, h, w, C]) → pending entries;
        runs on the pipeline's I/O stage."""
        nonlocal pending_bytes
        y, x = grid.positions[tile_idx]
        entries = []
        for batch_idx in range(arr.shape[0]):
            entries.append({
                "tile_idx": tile_idx, "batch_idx": batch_idx,
                "global_idx": tile_idx * arr.shape[0] + batch_idx,
                "x": int(x), "y": int(y),
                "extracted_w": grid.padded_w, "extracted_h": grid.padded_h,
                "image": img_utils.encode_image_data_url(arr[batch_idx]),
            })
        with pending_lock:
            pending.extend(entries)
            pending_bytes += sum(len(e["image"]) for e in entries)
        tiles_processed_total().inc(role="worker")

    def flush(is_final: bool, force: bool = False) -> None:
        """Ship when the payload budget or the tile batch fills, when
        `force`d with anything pending, or on the final flush (an empty
        final flush still marks this worker done)."""
        nonlocal pending, pending_bytes
        with pending_lock:
            if not (is_final or (force and pending) or len(pending) >= MAX_TILE_BATCH
                    or pending_bytes >= _flush_threshold_bytes()):
                return
            # worker_id groups this span with the worker's other stages
            with _stage("submit", "worker", worker_id=worker_id):
                client.submit_tiles(pending, is_final)
            pending, pending_bytes = [], 0

    # Push grants: hold the master's event stream and, after an empty
    # pull, park up to CDT_PUSH_WAIT on it before reading the queue as
    # drained. Scripted clients (no master_url) and CDT_PUSH_GRANTS=0
    # keep the pure pull protocol.
    push: Optional[GrantSignal] = None
    if PUSH_GRANTS_ENABLED and getattr(client, "master_url", None):
        push = GrantSignal(lambda: client.master_url, job_id)

    def cancelled() -> bool:
        return bool(getattr(client, "job_cancelled", False)
                    or (push is not None and push.job_cancelled))

    def grant_ids(work: dict) -> list[int]:
        return [int(t) for t in (work.get("tile_idxs") or [work["tile_idx"]])]

    def pull() -> Optional[list[int]]:
        """The next grant's tile ids; None once the queue reads drained
        (after a park, with push grants), or the job is cancelled or
        preempted (a preempted job's pulls read as drained)."""
        if cancelled() or getattr(client, "preempt_requested", False):
            return None
        work = client.request_tile(batch_max=pull_cap)
        if work is not None:
            return grant_ids(work)
        if push is not None and push.connected and not push.job_complete:
            # ship the encoded tiles first: the job cannot complete while
            # this worker holds finished ones
            if pipeline.wait_emitted():
                flush(False, force=True)
            if push.wait_for_grant(PUSH_WAIT_SECONDS) and not push.job_complete:
                work = client.request_tile(batch_max=pull_cap)
                if work is not None:
                    return grant_ids(work)
        return None

    def check_abort() -> None:
        """Between tiles: the prompt's interrupt, or a cancellation the
        master reported (on a pull answer or pushed). InterruptedError
        takes the pipeline's graceful path: flush what is encoded, hand
        the rest back."""
        if context is not None:
            context.check_interrupted()
        if cancelled():
            reason = getattr(client, "cancel_reason", "") or "cancelled"
            raise InterruptedError(f"job {job_id} cancelled by master ({reason})")

    pipeline = TilePipeline(
        pull=pull, sample=grant_sampler.sample, chunks=grant_sampler.chunks,
        to_host=grant_sampler.collect, emit=emit, flush=flush,
        heartbeat=client.heartbeat, check_interrupted=check_abort,
        release=getattr(client, "return_tiles", None), role="worker",
        threaded=PIPELINE_ENABLED, span_attrs={"worker_id": worker_id},
    )
    try:
        if push is not None:
            push.start()
        pipeline.run()
    except InterruptedError:
        if not cancelled():
            raise  # a real interrupt
        log(f"worker {worker_id}: job {job_id} cancelled; aborted cleanly")
    finally:
        summary = None
        if push is not None:
            push.stop()
            summary = push.summary()
            debug_log(f"worker {worker_id}: grant signal of job {job_id}: {summary}")
        if context is not None:
            context.extras["grant_signal"] = summary  # None: the job ran pull-only


# --------------------------------------------------------------------------
# master side
# --------------------------------------------------------------------------


def _bind_tile_cache(bundle, pos, neg, noise, grid, extracted, context, adapter_key,
                     **options):
    """The job's view of the tile cache, or None (no cache, or noise the
    key cannot name). Leaves the key derivation's seconds (the weights
    fingerprint apart) in context.extras["tile_cache"]."""
    from ..cache import (
        bind_job_cache,
        bundle_fingerprint,
        job_key_context,
        noise_identity,
        tile_keys_for,
    )

    base_key = noise_identity(noise)
    if base_key is None:
        return None

    def build_keys() -> list[str]:
        started = time.perf_counter()
        weights_fp = bundle_fingerprint(bundle)
        fingerprinted = time.perf_counter()
        ctx = job_key_context(bundle, pos, neg, base_key, grid, adapter=adapter_key,
                              weights_fp=weights_fp, **options)
        keys = tile_keys_for(ctx, extracted, grid)
        if context is not None:
            context.extras["tile_cache"] = {
                "weights_fingerprint_s": fingerprinted - started,
                "keys_s": time.perf_counter() - fingerprinted,
            }
        return keys

    return bind_job_cache(build_keys)


@torch.inference_mode()
def run_master_elastic(
    bundle: pl.PipelineBundle,
    image,
    pos,
    neg,
    job_id: str,
    enabled_worker_ids: list[str],
    mesh: Any = None,
    upscale_by: float = 2.0,
    tile: int = 512,
    padding: int = 32,
    steps: int = 20,
    sampler: str = "euler",
    scheduler: str = "karras",
    cfg: float = 7.0,
    denoise: float = 0.35,
    seed: int = 0,
    upscale_method: str = "bicubic",
    mask_blur: int = 0,
    uniform: bool = True,
    tiled_decode: bool = False,
    tile_h: int | None = None,
    context=None,
    noise: upscale_ops.NoiseFn | None = None,
) -> torch.Tensor:
    """The master takes part in the tile queue and collects worker tiles;
    returns the composited [B, H, W, C] image on the bundle's device.
    Stale workers' tiles are requeued (busy-probe grace) and run locally.
    The job's adapter plan and the tile cache: see the module docstring."""
    _check_ported(mesh)
    store = context.server.job_store
    config = getattr(context, "config", None) or {}
    upscaled, grid, extracted, pos, neg = _prepare(
        bundle, image, pos, neg, upscale_by, tile, padding, upscale_method, tile_h,
        mask_blur, uniform,
    )
    def make_process(model: pl.PipelineBundle) -> Callable:
        return _tile_processor(model, grid, steps, sampler, scheduler, cfg, denoise, tiled_decode)

    # the plan the orchestration noted (init_tile_job takes it onto the
    # job): the master samples a patched copy, the cache keys the base
    # bundle with the plan's content identity
    adapter_key = None
    adapter_wire = run_async_in_server_loop(store.peek_job_adapters(job_id), timeout=30)
    if adapter_wire:
        from ..adapters import adapter_plan_key

        specs, process = _adapter_processor(bundle, adapter_wire, context, "master",
                                            make_process)
        adapter_key = adapter_plan_key(specs)
        adapter_jobs_total().inc(tier="elastic")
    else:
        process = make_process(bundle)
    noise = noise or upscale_ops.default_noise(seed, bundle.device)
    grant_sampler = GrantSampler(process, extracted, grid.positions, pos, neg, noise,
                                 role="master", job_id=job_id)
    canvas_cls = (tile_ops.DeterministicHostCanvas if deterministic_blend()
                  else tile_ops.HostIncrementalCanvas)
    canvas = canvas_cls(upscaled, grid)
    done_tiles: set[int] = set()
    timeout = worker_timeout_seconds(config)
    cache_binding = _bind_tile_cache(
        bundle, pos, neg, noise, grid, extracted, context, adapter_key, steps=steps,
        sampler=sampler, scheduler=scheduler, cfg=cfg, denoise=denoise, upscale_by=upscale_by,
        upscale_method=upscale_method, mask_blur=mask_blur, uniform=uniform,
        tiled_decode=tiled_decode)

    def blend_local(tile_idx: int, result) -> None:
        with _stage("blend", "master", tile_idx):
            y, x = grid.positions[tile_idx]
            if cache_binding is not None:
                cache_binding.populate(tile_idx, result)
            canvas.blend(result, y, x)
            done_tiles.add(tile_idx)

    # probe BEFORE the job exists and settle the hits atomically with its
    # creation: no puller ever sees them pending. A job that existed
    # already (creation ignored the list) settles through settle_cached,
    # which leaves out tiles a worker completed: those must not blend
    # twice (the canvas accumulates weight)
    hits: dict[int, Any] = {}
    if cache_binding is not None:
        with _stage("cache.probe", "master") as probe_span:
            hits = cache_binding.probe()
            probe_span.attrs["hits"] = len(hits)
    job = run_async_in_server_loop(
        store.init_tile_job(job_id, list(range(grid.num_tiles)),
                            cache_settled=sorted(hits) or None),
        timeout=30)
    if hits:
        settled = [t for t in sorted(hits) if t in job.cached_tiles]
        if not settled:
            settled = run_async_in_server_loop(store.settle_cached(job_id, sorted(hits)),
                                               timeout=30)
        for tile_idx in settled:
            with _stage("cache.hit", "master", tile_idx):
                y, x = grid.positions[tile_idx]
                canvas.blend(hits[tile_idx], y, x)
                done_tiles.add(tile_idx)
        cache_binding.cache.note_settled(len(settled))
        if settled and constants.USAGE_ENABLED:
            from ..telemetry.usage import get_usage_meter

            get_usage_meter().note_cached("master", job_id, len(settled))

    def drain_results() -> None:
        async def drain():
            job = await store.get_tile_job(job_id)
            items = []
            while job is not None and not job.results.empty():
                items.append(job.results.get_nowait())
            return items

        for tile_idx, payload in run_async_in_server_loop(drain(), timeout=30):
            if tile_idx in done_tiles or payload is None:
                continue  # payload None: a master-local tile, blended already
            with _stage("decode", "master", tile_idx):
                batch = np.stack([
                    img_utils.decode_image_data_url(e["image"])
                    for e in sorted(payload, key=lambda e: e["batch_idx"])
                ])
            blend_local(tile_idx, batch)

    def run_local(tile_idx: int):
        """One tile through the master's sampler: [B, h, w, C] on the host."""
        with _stage("sample", "master", tile_idx, batch=[tile_idx]):
            result = grant_sampler.sample([tile_idx])
        with _stage("readback", "master", tile_idx, batch=[tile_idx]):
            return grant_sampler.collect(result)[0]

    # --- main pull/process loop ---
    empty_pulls = 0
    while empty_pulls < 2:
        if context is not None:
            context.check_interrupted()
        with _stage("pull", "master") as pull_span:
            grant = run_async_in_server_loop(
                store.pull_tasks(job_id, "master", timeout=QUEUE_POLL_INTERVAL_SECONDS),
                timeout=30,
            )
            if not grant:
                pull_span.attrs["outcome"] = "empty"
            else:
                pull_span.attrs["tile_idx"] = int(grant[0])
                if len(grant) > 1:
                    pull_span.attrs["batch"] = [int(t) for t in grant]
        if not grant:
            empty_pulls += 1
            drain_results()
            continue
        empty_pulls = 0
        for tile_idx in grant:
            if context is not None:
                context.check_interrupted()
            result = run_local(int(tile_idx))
            run_async_in_server_loop(
                store.submit_flush(job_id, "master", {int(tile_idx): None}), timeout=30
            )
            tiles_processed_total().inc(role="master")
            blend_local(int(tile_idx), result)
            drain_results()

    # --- collection phase ---
    # quarantined tiles count as settled (the job completes degraded);
    # a terminal cancellation unwinds instead of waiting
    def lifecycle() -> dict:
        state = run_async_in_server_loop(store.job_lifecycle(job_id), timeout=30)
        return state or {"cancelled": False, "cancel_reason": "", "quarantined": []}

    deadline = time.monotonic() + timeout * max(1, len(enabled_worker_ids))
    while True:
        state = lifecycle()
        quarantined = set(state["quarantined"])
        if state["cancelled"] or len(done_tiles | quarantined) >= grid.num_tiles:
            break
        if context is not None:
            context.check_interrupted()
        run_async_in_server_loop(store.sweep_deadlines(), timeout=30)
        drain_results()
        if len(done_tiles | quarantined) >= grid.num_tiles:
            break
        requeued = run_async_in_server_loop(
            store.requeue_timed_out(job_id, timeout, _busy_probe(config)), timeout=60
        )
        pending_now = run_async_in_server_loop(store.remaining(job_id), timeout=30)
        if requeued or pending_now:
            # claim requeued tiles through the same pull path workers use,
            # so a surviving worker may still take some first
            while True:
                with _stage("pull", "master") as pull_span:
                    tile_idx = run_async_in_server_loop(
                        store.pull_task(job_id, "master", timeout=QUEUE_POLL_INTERVAL_SECONDS),
                        timeout=30,
                    )
                    if tile_idx is None:
                        pull_span.attrs["outcome"] = "empty"
                    else:
                        pull_span.attrs["tile_idx"] = int(tile_idx)
                if tile_idx is None:
                    break
                if tile_idx in done_tiles:
                    continue
                result = run_local(tile_idx)
                run_async_in_server_loop(
                    store.submit_result(job_id, "master", tile_idx, None), timeout=30
                )
                tiles_processed_total().inc(role="master")
                blend_local(tile_idx, result)
        if len(done_tiles | quarantined) >= grid.num_tiles:
            break
        if time.monotonic() > deadline:
            # quarantined tiles are not reprocessed: a payload that
            # crashed every worker stays settled degraded
            missing = sorted(set(range(grid.num_tiles)) - done_tiles - quarantined)
            log(f"USDU: deadline hit; locally processing {len(missing)} tile(s)")
            for tile_idx in missing:
                result = run_local(tile_idx)
                tiles_processed_total().inc(role="master")
                blend_local(tile_idx, result)
            break
        time.sleep(QUEUE_POLL_INTERVAL_SECONDS)

    state = lifecycle()
    _finish_job(store, job_id)
    if state["cancelled"]:
        raise JobCancelled(job_id, state["cancel_reason"] or "cancel")
    poisoned = sorted(set(state["quarantined"]) - done_tiles)
    if poisoned:
        if getattr(store, "poison_policy", "degrade") == "fail":
            raise JobPoisoned(job_id, poisoned)
        log(f"USDU: job {job_id} completes DEGRADED: tile(s) {poisoned} quarantined "
            "(region blended from the base image)")
    return canvas.result().to(bundle.device)


# --------------------------------------------------------------------------
# dynamic (frame-queue) mode: image batches
# --------------------------------------------------------------------------

FrameNoise = Callable[[int], upscale_ops.NoiseFn]


def _frame_noise(seed: int, device) -> FrameNoise:
    """Frame index → that frame's tile noise (upscale.FrameTileNoise)."""
    return lambda frame_index: upscale_ops.FrameTileNoise(seed, frame_index, device)


def _process_whole_image(image_1: torch.Tensor, pos, neg, grid: tile_ops.TileGrid,
                         process: Callable, noise: upscale_ops.NoiseFn) -> torch.Tensor:
    """One [1, H, W, C] upscaled frame through all its tiles on this
    participant, composited on the device → [1, H, W, C]. pos/neg are
    prepped by prep_cond_for_tiles; `noise` is the frame's tile noise."""
    extracted = tile_ops.extract_tiles(image_1, grid)
    canvas = tile_ops.IncrementalCanvas(image_1, grid)
    for tile_idx, (y, x) in enumerate(grid.positions):
        canvas.blend(process(extracted[tile_idx], tile_idx, noise, pos, neg, (y, x)), y, x)
    return canvas.result()


@torch.inference_mode()
def run_worker_dynamic(
    bundle: pl.PipelineBundle,
    image,
    pos,
    neg,
    job_id: str,
    worker_id: str,
    master_url: str,
    upscale_by: float,
    tile: int,
    padding: int,
    steps: int,
    sampler: str,
    scheduler: str,
    cfg: float,
    denoise: float,
    seed: int,
    upscale_method: str = "bicubic",
    mask_blur: int = 0,
    uniform: bool = True,
    tiled_decode: bool = False,
    tile_h: int | None = None,
    context=None,
    client: Any = None,
    mesh: Any = None,
    noise: FrameNoise | None = None,
) -> None:
    """Pull frame indices until the master's queue drains; run each
    frame's tiles here and submit the finished frame (an 8-bit PNG data
    URL), heartbeating after each."""
    _check_ported(mesh)
    client = client or HTTPWorkClient(master_url, job_id, worker_id)
    if not client.poll_ready():
        raise WorkerError(f"job {job_id} never became ready", worker_id)
    upscaled, grid, _, pos, neg = _prepare(
        bundle, image, pos, neg, upscale_by, tile, padding, upscale_method, tile_h,
        mask_blur, uniform,
    )
    process = _tile_processor(bundle, grid, steps, sampler, scheduler, cfg, denoise,
                              tiled_decode)
    noise = noise or _frame_noise(seed, bundle.device)
    while True:
        if context is not None:
            context.check_interrupted()
        work = client.request_tile()
        if work is None:
            break
        image_idx = int(work.get("image_idx", work.get("tile_idx")))
        out = _process_whole_image(upscaled[image_idx:image_idx + 1], pos, neg, grid,
                                   process, noise(image_idx))
        client.submit_image(image_idx,
                            img_utils.encode_image_data_url(img_utils.ensure_numpy(out)[0]),
                            is_last=int(work.get("estimated_remaining", 0)) == 0)
        client.heartbeat()


@torch.inference_mode()
def run_master_dynamic(
    bundle: pl.PipelineBundle,
    image,
    pos,
    neg,
    job_id: str,
    enabled_worker_ids: list[str],
    mesh: Any = None,
    upscale_by: float = 2.0,
    tile: int = 512,
    padding: int = 32,
    steps: int = 20,
    sampler: str = "euler",
    scheduler: str = "karras",
    cfg: float = 7.0,
    denoise: float = 0.35,
    seed: int = 0,
    upscale_method: str = "bicubic",
    mask_blur: int = 0,
    uniform: bool = True,
    tiled_decode: bool = False,
    tile_h: int | None = None,
    context=None,
    noise: FrameNoise | None = None,
) -> torch.Tensor:
    """The frame-queue master: it pulls and processes frames itself,
    drains the workers' frames between its own, requeues a silent
    worker's frames (busy-probe grace) and runs what is left at the
    deadline; returns the [B, H, W, C] batch in frame order on the
    bundle's device."""
    _check_ported(mesh)
    store = context.server.job_store
    config = getattr(context, "config", None) or {}
    batch = int(torch.as_tensor(image).shape[0])
    upscaled, grid, _, pos, neg = _prepare(
        bundle, image, pos, neg, upscale_by, tile, padding, upscale_method, tile_h,
        mask_blur, uniform,
    )
    process = _tile_processor(bundle, grid, steps, sampler, scheduler, cfg, denoise,
                              tiled_decode)
    noise = noise or _frame_noise(seed, bundle.device)
    timeout = worker_timeout_seconds(config)
    run_async_in_server_loop(
        store.init_tile_job(job_id, list(range(batch)), batched=False, kind="image"), timeout=30)
    frames: dict[int, np.ndarray] = {}

    def drain() -> None:
        async def pop_all():
            job = await store.get_tile_job(job_id)
            items = []
            while job is not None and not job.results.empty():
                items.append(job.results.get_nowait())
            return items

        for image_idx, payload in run_async_in_server_loop(pop_all(), timeout=30):
            if image_idx in frames or payload is None:
                continue  # payload None: a frame of the master's, kept already
            frames[image_idx] = img_utils.decode_image_data_url(payload[0]["image"])

    def run_local(image_idx: int) -> None:
        out = _process_whole_image(upscaled[image_idx:image_idx + 1], pos, neg, grid,
                                   process, noise(image_idx))
        frames[image_idx] = img_utils.ensure_numpy(out)[0]

    def claim_and_process() -> bool:
        image_idx = run_async_in_server_loop(
            store.pull_task(job_id, "master", timeout=QUEUE_POLL_INTERVAL_SECONDS), timeout=30)
        if image_idx is None:
            return False
        if image_idx not in frames:
            run_local(image_idx)
        run_async_in_server_loop(store.submit_result(job_id, "master", image_idx, None),
                                 timeout=30)
        drain()
        return True

    while claim_and_process():
        if context is not None:
            context.check_interrupted()

    deadline = time.monotonic() + timeout * max(1, len(enabled_worker_ids))
    cancelled = None
    while len(frames) < batch:
        if context is not None:
            context.check_interrupted()
        run_async_in_server_loop(store.sweep_deadlines(), timeout=30)
        state = run_async_in_server_loop(store.job_lifecycle(job_id), timeout=30)
        if state is not None and state["cancelled"]:
            cancelled = state["cancel_reason"] or "cancel"
            break
        drain()
        if len(frames) >= batch:
            break
        requeued = run_async_in_server_loop(
            store.requeue_timed_out(job_id, timeout, _busy_probe(config)), timeout=60)
        pending_now = run_async_in_server_loop(store.remaining(job_id), timeout=30)
        if requeued or pending_now:
            # a surviving worker may still take some of them first
            while claim_and_process():
                pass
        if len(frames) >= batch:
            break
        if time.monotonic() > deadline:
            missing = sorted(set(range(batch)) - set(frames))
            log(f"USDU dynamic: deadline hit; processing {len(missing)} frame(s) locally")
            for image_idx in missing:
                run_local(image_idx)
            break
        time.sleep(QUEUE_POLL_INTERVAL_SECONDS)

    _finish_job(store, job_id)
    if cancelled is not None:
        raise JobCancelled(job_id, cancelled)
    stacked = np.stack([frames[i] for i in range(batch)], axis=0)
    return torch.from_numpy(stacked).to(bundle.device)
