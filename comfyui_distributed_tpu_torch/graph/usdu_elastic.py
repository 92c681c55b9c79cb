"""Elastic-tier USDU: master/worker tile-queue loops over HTTP.

The port's own copy of the static mode of comfyui_distributed_tpu/
graph/usdu_elastic.py, for participants outside the master's process
(or inside it, on their own server):

  worker: poll job ready → pipelined pull/sample/encode/submit stages
          (graph/tile_pipeline.py), heartbeats from the I/O stage →
          final flush
  master: init the tile queue → pull tiles, sample, blend locally while
          draining worker results → on drain, a collection phase with
          heartbeat-timeout requeue (busy-probe grace) → local fallback
          for requeued tiles → the composited canvas

The tile processor is ops/upscale.py::_process_tile_fn with the same
`noise` seam as `run_upscale`: the default draws a tile's initial and
step noise from generators seeded by (seed, global tile index, stream),
so a requeued tile is bit-identical wherever it runs. Worker tiles travel as 8-bit PNG data
URLs and composite on the master's host canvas (ops/tiles.py); with
CDT_DETERMINISTIC_BLEND=1 the canvas composites in sorted tile order, so
the image does not depend on which participant finished first.

Left out, each with its ROADMAP item: the master-URL failover list,
shard routing and fencing epochs, push grants (`GrantSignal`), the
fleet-telemetry piggyback, the tile cache, adapters, the cross-job tier,
the device canvas, the mesh and the dynamic (whole-image) mode. Both
roles prep the conditioning for tiles (ControlNet hints and masks
windowed per tile) and take `tiled_decode`.

Every function here enters `torch.inference_mode()` on its own thread:
grad mode is thread-local, and the server runs them on its executor
thread.
"""

from __future__ import annotations

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
from ..utils import image as img_utils
from ..utils.async_helpers import run_async_in_server_loop
from ..utils.config import worker_timeout_seconds
from ..utils.constants import (
    MAX_PAYLOAD_SIZE,
    MAX_TILE_BATCH,
    PAYLOAD_HEADROOM,
    PIPELINE_ENABLED,
    QUEUE_POLL_INTERVAL_SECONDS,
    deterministic_blend,
)
from ..utils.exceptions import JobCancelled, JobPoisoned, TransientServerError, WorkerError
from ..utils.logging import debug_log, log
from ..utils.network import build_worker_url, parse_master_urls, probe_worker, request_json_async
from .tile_pipeline import GrantSampler, StageTotals, TilePipeline
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


def _publish_stage_totals(context, role: str, totals: StageTotals) -> None:
    """Leave the run's stage wall times where the caller can read them:
    context.extras["stage_seconds"][role]."""
    if context is not None:
        context.extras.setdefault("stage_seconds", {})[role] = totals.seconds()


# --------------------------------------------------------------------------
# worker side
# --------------------------------------------------------------------------


class HTTPWorkClient:
    """Worker → master RPCs over `urllib` (utils/network.py), each through
    the shared RetryPolicy: a fixed interval for the readiness poll, a
    patient capped backoff for the pull, the default HTTP policy for
    submits (safe: the master drops duplicate results). One master URL;
    the failover list, shard routing and fencing epochs are ROADMAP
    Queue 1, item 3."""

    def __init__(self, master_url: str, job_id: str, worker_id: str):
        urls = parse_master_urls(master_url)
        self.master_url = urls[0] if urls else str(master_url)
        self.job_id = job_id
        self.worker_id = worker_id
        # set when a pull response reports the job cancelled; the worker
        # loop's interrupt check reads it
        self.job_cancelled = False
        self.cancel_reason = ""
        # heartbeats run on one thread (the pipeline's I/O stage)
        self._hb_failures = 0
        self._hb_suppressed_until = 0.0

    async def _post(self, path: str, payload: dict, timeout: float = 60.0) -> dict:
        status, out = await request_json_async(
            "POST", f"{self.master_url}{path}", payload, timeout=timeout
        )
        if status >= 500:
            raise TransientServerError(f"{path} -> HTTP {status}", self.worker_id)
        if status != 200:
            raise WorkerError(f"{path} -> HTTP {status}", self.worker_id)
        return out if isinstance(out, dict) else {}

    def poll_ready(self) -> bool:
        async def attempt():
            out = await self._post("/distributed/job_status",
                                   {"job_id": self.job_id, "worker_id": self.worker_id})
            if not out.get("ready"):
                raise WorkerError(f"job {self.job_id} not ready", self.worker_id)
            return True

        async def poll():
            try:
                return await retry_async(attempt, poll_ready_policy(),
                                         label=f"poll_ready:{self.job_id}")
            except (WorkerError,) + transport_errors():
                return False

        return run_async_in_server_loop(poll(), timeout=None)

    def request_tile(self) -> Optional[dict]:
        """Pull the next tile; None when drained (or the master stayed
        unreachable through the whole pull policy)."""

        async def pull():
            try:
                return await retry_async(
                    lambda: self._post("/distributed/request_image",
                                       {"job_id": self.job_id, "worker_id": self.worker_id}),
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
        return out if out.get("tile_idx") is not None else None

    def submit_tiles(self, entries: list[dict], is_final: bool) -> None:
        """Ship a flush. Transport failures and 5xx answers retry; a 4xx is
        the master's verdict and raises."""

        async def send():
            await retry_async(
                lambda: self._post(
                    "/distributed/submit_tiles",
                    {"job_id": self.job_id, "worker_id": self.worker_id, "tiles": entries,
                     "is_final_flush": is_final},
                    timeout=300.0,
                ),
                http_policy(), retryable=transport_errors() + (TransientServerError,),
                label=f"submit_tiles:{self.worker_id}",
            )

        run_async_in_server_loop(send(), timeout=600)

    def heartbeat(self) -> None:
        """Best-effort liveness beat; after k consecutive failures beats
        are skipped for min(base * 2^(k-1), cap) seconds."""
        if time.monotonic() < self._hb_suppressed_until:
            return

        async def beat():
            try:
                await self._post("/distributed/heartbeat",
                                 {"job_id": self.job_id, "worker_id": self.worker_id},
                                 timeout=30.0)
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
                                  "tile_idxs": [int(t) for t in tile_idxs]}, timeout=30.0)
            except (WorkerError,) + transport_errors() as exc:
                debug_log(f"return_tiles failed: {exc}")

        run_async_in_server_loop(send(), timeout=60)


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
        noise or upscale_ops.default_noise(seed, bundle.device),
    )
    client = client or HTTPWorkClient(master_url, job_id, worker_id)
    if not client.poll_ready():
        raise WorkerError(f"job {job_id} never became ready", worker_id)

    pending: list[dict] = []
    pending_bytes = 0

    def emit(tile_idx: int, arr) -> None:
        """One processed tile (host-side [B, h, w, C]) → pending entries;
        runs on the pipeline's I/O stage."""
        nonlocal pending_bytes
        y, x = grid.positions[tile_idx]
        for batch_idx in range(arr.shape[0]):
            encoded = img_utils.encode_image_data_url(arr[batch_idx])
            pending.append({
                "tile_idx": tile_idx, "batch_idx": batch_idx,
                "global_idx": tile_idx * arr.shape[0] + batch_idx,
                "x": int(x), "y": int(y),
                "extracted_w": grid.padded_w, "extracted_h": grid.padded_h,
                "image": encoded,
            })
            pending_bytes += len(encoded)

    totals = StageTotals()

    def flush(is_final: bool) -> None:
        """Ship when the payload budget or the tile batch fills, or on the
        final flush (an empty final flush still marks this worker done)."""
        nonlocal pending, pending_bytes
        if not is_final and len(pending) < MAX_TILE_BATCH \
                and pending_bytes < _flush_threshold_bytes():
            return
        if pending or is_final:
            with _stage("submit", "worker", totals=totals):
                client.submit_tiles(pending, is_final)
        pending, pending_bytes = [], 0

    def pull() -> Optional[list[int]]:
        if getattr(client, "job_cancelled", False):
            return None
        work = client.request_tile()
        return None if work is None else [int(work["tile_idx"])]

    def check_abort() -> None:
        """Between tiles: the prompt's interrupt, or a cancellation the
        master reported. InterruptedError takes the pipeline's graceful
        path: flush what is encoded, hand the rest back."""
        if context is not None:
            context.check_interrupted()
        if getattr(client, "job_cancelled", False):
            reason = getattr(client, "cancel_reason", "") or "cancelled"
            raise InterruptedError(f"job {job_id} cancelled by master ({reason})")

    pipeline = TilePipeline(
        pull=pull, sample=grant_sampler.sample, chunks=grant_sampler.chunks,
        to_host=grant_sampler.collect, emit=emit, flush=flush,
        heartbeat=client.heartbeat, check_interrupted=check_abort,
        release=getattr(client, "return_tiles", None), role="worker",
        threaded=PIPELINE_ENABLED, stage_totals=totals,
    )
    try:
        pipeline.run()
    except InterruptedError:
        if not getattr(client, "job_cancelled", False):
            raise  # a real interrupt
        log(f"worker {worker_id}: job {job_id} cancelled; aborted cleanly")
    finally:
        _publish_stage_totals(context, "worker", totals)


# --------------------------------------------------------------------------
# master side
# --------------------------------------------------------------------------


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
    Stale workers' tiles are requeued (busy-probe grace) and run locally."""
    _check_ported(mesh)
    store = context.server.job_store
    config = getattr(context, "config", None) or {}
    upscaled, grid, extracted, pos, neg = _prepare(
        bundle, image, pos, neg, upscale_by, tile, padding, upscale_method, tile_h,
        mask_blur, uniform,
    )
    process = _tile_processor(bundle, grid, steps, sampler, scheduler, cfg, denoise,
                              tiled_decode)
    noise = noise or upscale_ops.default_noise(seed, bundle.device)
    canvas_cls = (tile_ops.DeterministicHostCanvas if deterministic_blend()
                  else tile_ops.HostIncrementalCanvas)
    canvas = canvas_cls(upscaled, grid)
    done_tiles: set[int] = set()
    timeout = worker_timeout_seconds(config)
    totals = StageTotals()

    def blend_local(tile_idx: int, result) -> None:
        with _stage("blend", "master", tile_idx, totals=totals):
            y, x = grid.positions[tile_idx]
            canvas.blend(result, y, x)
            done_tiles.add(tile_idx)

    run_async_in_server_loop(store.init_tile_job(job_id, list(range(grid.num_tiles))),
                             timeout=30)

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
            with _stage("decode", "master", tile_idx, totals=totals):
                batch = np.stack([
                    img_utils.decode_image_data_url(e["image"])
                    for e in sorted(payload, key=lambda e: e["batch_idx"])
                ])
            blend_local(tile_idx, batch)

    async def probe_busy(worker_id: str) -> bool:
        worker = next((w for w in config.get("workers", []) if str(w.get("id")) == worker_id),
                      None)
        if worker is None:
            return False
        result = await probe_worker(build_worker_url(worker))
        return bool(result["online"] and (result["queue_remaining"] or 0) > 0)

    def run_local(tile_idx: int):
        with _stage("sample", "master", tile_idx, totals=totals):
            result = process(extracted[tile_idx], tile_idx, noise, pos, neg,
                             grid.positions[tile_idx])
        with _stage("readback", "master", tile_idx, totals=totals):
            return img_utils.ensure_numpy(result)

    # --- main pull/process loop ---
    empty_pulls = 0
    while empty_pulls < 2:
        if context is not None:
            context.check_interrupted()
        with _stage("pull", "master", totals=totals) as pull_span:
            grant = run_async_in_server_loop(
                store.pull_tasks(job_id, "master", timeout=QUEUE_POLL_INTERVAL_SECONDS),
                timeout=30,
            )
            if not grant:
                pull_span.attrs["outcome"] = "empty"
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
            store.requeue_timed_out(job_id, timeout, probe_busy), timeout=60
        )
        pending_now = run_async_in_server_loop(store.remaining(job_id), timeout=30)
        if requeued or pending_now:
            # claim requeued tiles through the same pull path workers use,
            # so a surviving worker may still take some first
            while True:
                with _stage("pull", "master", totals=totals) as pull_span:
                    tile_idx = run_async_in_server_loop(
                        store.pull_task(job_id, "master", timeout=QUEUE_POLL_INTERVAL_SECONDS),
                        timeout=30,
                    )
                    if tile_idx is None:
                        pull_span.attrs["outcome"] = "empty"
                if tile_idx is None:
                    break
                if tile_idx in done_tiles:
                    continue
                result = run_local(tile_idx)
                run_async_in_server_loop(
                    store.submit_result(job_id, "master", tile_idx, None), timeout=30
                )
                blend_local(tile_idx, result)
        if len(done_tiles | quarantined) >= grid.num_tiles:
            break
        if time.monotonic() > deadline:
            # quarantined tiles are not reprocessed: a payload that
            # crashed every worker stays settled degraded
            missing = sorted(set(range(grid.num_tiles)) - done_tiles - quarantined)
            log(f"USDU: deadline hit; locally processing {len(missing)} tile(s)")
            for tile_idx in missing:
                blend_local(tile_idx, run_local(tile_idx))
            break
        time.sleep(QUEUE_POLL_INTERVAL_SECONDS)

    state = lifecycle()
    run_async_in_server_loop(store.cleanup_tile_job(job_id), timeout=30)
    _publish_stage_totals(context, "master", totals)
    if state["cancelled"]:
        raise JobCancelled(job_id, state["cancel_reason"] or "cancel")
    poisoned = sorted(set(state["quarantined"]) - done_tiles)
    if poisoned:
        if getattr(store, "poison_policy", "degrade") == "fail":
            raise JobPoisoned(job_id, poisoned)
        log(f"USDU: job {job_id} completes DEGRADED: tile(s) {poisoned} quarantined "
            "(region blended from the base image)")
    return canvas.result().to(bundle.device)
