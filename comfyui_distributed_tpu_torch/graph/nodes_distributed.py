"""Distributed workflow nodes of seed-parallel generation.

The port's own copy of comfyui_distributed_tpu/graph/nodes_distributed.py
on the elastic (HTTP) tier: DistributedSeed, DistributedValue,
DistributedModelName, ImageBatchDivider, AudioBatchDivider,
DistributedEmptyImage and DistributedCollector.

- Workers POST one envelope per image to the master's
  /distributed/job_complete ({job_id, worker_id, batch_idx, image as a
  base64 PNG data URL, is_last}; an empty batch still sends one `empty`
  envelope marked is_last; a worker's audio rides its last envelope as
  an `audio` payload, utils/audio_payload.py), over `urllib` under the
  shared RetryPolicy,
  with the executing prompt's trace id in the X-CDT-Trace-Id header so
  the master's `rpc.job_complete` spans join the execution's tree.
- The master's collector drains its collector job's queue with sliced
  waits, probes the missing workers when they stall (busy ⇒ grace),
  drops repeated (worker, batch_idx) envelopes, and orders the batch:
  its own images first, then enabled workers in configured order, then
  stragglers; images of another size than the first are dropped. Its
  own audio and the workers' concatenate along the samples axis, its
  own first, then the workers' in the order their envelopes arrived (as
  the JAX collector does), under one sample rate.

Unlike the JAX drain, which stops as soon as every worker has sent its
last envelope, this one also empties the queue first: a worker's earlier
images can still be queued behind its last one. And unlike the JAX
master, which leaves its collector job and queue in the store for good,
this one cleans its job up once it has collected (or given up): the
store keeps its counts among the finished jobs and drops an envelope
that arrives later as late.

The collector's `load_balance` widget is accepted and has no effect,
as in the JAX node: load balancing is a field of the queue request,
which the orchestration reads (api/orchestration/queue_orchestration.py).

Not ported, raising with its ROADMAP item: the mesh branch (a
per-participant SeedSpec; Queue 1 item 6).
"""

from __future__ import annotations

import asyncio
import time
from typing import Any

import numpy as np
import torch

from ..parallel.collective import reorder_participant_first
from ..resilience.policy import http_policy, retry_async, transport_errors
from ..utils import audio_payload as audio_utils
from ..utils import image as img_utils
from ..utils.async_helpers import run_async_in_server_loop
from ..utils.config import worker_timeout_seconds
from ..utils.constants import COLLECTOR_WAIT_SLICES, JOB_INIT_GRACE_SECONDS
from ..utils.exceptions import TransientServerError, WorkerError
from ..utils.logging import debug_log, log
from ..utils.network import build_worker_url, probe_worker, request_json_async
from .nodes_core import _MESH_UNPORTED, SeedSpec
from .registry import register_node

@register_node
class DistributedSeed:
    """The master passes the seed through; worker i samples with
    seed + i + 1 (SeedSpec.effective_seed)."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {"seed": ("INT", {"default": 0})},
            "hidden": {
                "is_worker": ("BOOLEAN", {"default": False}),
                "worker_index": ("INT", {"default": -1}),
            },
        }

    RETURN_TYPES = ("INT",)
    FUNCTION = "get_seed"

    def get_seed(self, seed, is_worker=False, worker_index=-1, enabled_worker_ids=None,
                 context=None):
        if getattr(context, "mesh", None) is not None:
            raise NotImplementedError(_MESH_UNPORTED)
        if is_worker and worker_index >= 0:
            return (SeedSpec(base_seed=int(seed), worker_index=int(worker_index)),)
        return (SeedSpec(base_seed=int(seed)),)


@register_node
class DistributedValue:
    """A typed per-worker value: the prompt rewrite (graph/prompt.py)
    writes worker i's override into `value`; the node passes it on."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {"value": ("STRING", {"default": ""})},
            "optional": {"overrides": ("DICT", {"default": None})},
            "hidden": {
                "is_worker": ("BOOLEAN", {"default": False}),
                "worker_index": ("INT", {"default": -1}),
            },
        }

    RETURN_TYPES = ("*",)
    FUNCTION = "get_value"

    def get_value(self, value, overrides=None, is_worker=False, worker_index=-1,
                  enabled_worker_ids=None, context=None):
        return (value,)


@register_node
class DistributedModelName:
    """A model reference as its registry name."""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"model": ("MODEL",)}}

    RETURN_TYPES = ("STRING",)
    FUNCTION = "name_of"
    OUTPUT_NODE = True

    def name_of(self, model, context=None):
        return (getattr(model, "model_name", str(model)),)


def _chunk_bounds(total: int, parts: int) -> list[tuple[int, int]]:
    """Contiguous near-equal split: the first `total % parts` chunks get
    one item more."""
    parts = max(1, min(parts, total)) if total > 0 else 1
    base, extra = divmod(total, parts)
    bounds = []
    start = 0
    for i in range(parts):
        size = base + (1 if i < extra else 0)
        bounds.append((start, start + size))
        start += size
    return bounds


MAX_DIVIDER_OUTPUTS = 10


@register_node
class ImageBatchDivider:
    """Split an IMAGE batch into up to 10 contiguous chunks; the outputs
    past `divide_by` are empty batches."""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"images": ("IMAGE",), "divide_by": ("INT", {"default": 2})}}

    RETURN_TYPES = tuple(["IMAGE"] * MAX_DIVIDER_OUTPUTS)
    FUNCTION = "divide"

    def divide(self, images, divide_by=2, context=None):
        parts = max(1, min(int(divide_by), MAX_DIVIDER_OUTPUTS))
        outs = [images[start:end] for start, end in _chunk_bounds(images.shape[0], parts)]
        outs += [images[0:0]] * (MAX_DIVIDER_OUTPUTS - len(outs))
        return tuple(outs)


@register_node
class AudioBatchDivider:
    """Split AUDIO into up to 10 contiguous chunks along the samples
    axis; the outputs past `divide_by` are empty waveforms."""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"audio": ("AUDIO",), "divide_by": ("INT", {"default": 2})}}

    RETURN_TYPES = tuple(["AUDIO"] * MAX_DIVIDER_OUTPUTS)
    FUNCTION = "divide"

    def divide(self, audio, divide_by=2, context=None):
        wave, rate = audio["waveform"], audio["sample_rate"]
        parts = max(1, min(int(divide_by), MAX_DIVIDER_OUTPUTS))
        outs = [{"waveform": wave[..., start:end], "sample_rate": rate}
                for start, end in _chunk_bounds(wave.shape[-1], parts)]
        outs += [{"waveform": wave[..., 0:0], "sample_rate": rate}
                 for _ in range(MAX_DIVIDER_OUTPUTS - len(outs))]
        return tuple(outs)


@register_node
class DistributedEmptyImage:
    """A zero-batch IMAGE placeholder (a delegate-only master's input to
    its collector)."""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {}}

    RETURN_TYPES = ("IMAGE",)
    FUNCTION = "empty"

    def empty(self, context=None):
        return (torch.zeros((0, 64, 64, 3), device=getattr(context, "device", None) or "cuda"),)


@register_node
class DistributedCollector:
    """The gather: on a worker, send every image (and its audio) to the
    master; on the master, return its own images followed by the
    workers', and the audio combined alike (see the module docstring)."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {"images": ("IMAGE",)},
            "optional": {
                "audio": ("AUDIO", {"default": None}),
                "pass_through": ("BOOLEAN", {"default": False}),
                "load_balance": ("BOOLEAN", {"default": False}),
            },
            "hidden": {
                "is_worker": ("BOOLEAN", {"default": False}),
                "worker_id": ("STRING", {"default": ""}),
                "master_url": ("STRING", {"default": ""}),
                "job_id": ("STRING", {"default": ""}),
            },
        }

    RETURN_TYPES = ("IMAGE", "AUDIO")
    FUNCTION = "run"
    NEVER_CACHE = True  # a network gather re-runs every time

    def run(self, images, audio=None, pass_through=False, load_balance=False, is_worker=False,
            worker_id="", master_url="", job_id="", enabled_worker_ids=None, context=None):
        if pass_through:
            return (images, audio)
        if is_worker:
            self._send_to_master(images, audio, str(worker_id), str(master_url), str(job_id))
            return (images, audio)
        return self._collect_master(images, audio, str(job_id), enabled_worker_ids or [],
                                    context)

    # --- worker side ------------------------------------------------------

    @staticmethod
    def envelopes(images, worker_id: str, job_id: str, audio=None) -> list[dict[str, Any]]:
        """One envelope per image, `is_last` on the last; an empty batch
        gives one 1-px placeholder marked `empty` and is_last, so the
        master does not wait a timeout for this worker. The audio, if
        any, rides the last envelope."""
        arr = img_utils.ensure_numpy(images)
        if arr.shape[0] == 0:
            envelopes = [{"job_id": job_id, "worker_id": worker_id, "batch_idx": 0,
                          "image": img_utils.encode_image_data_url(
                              np.zeros((1, 1, 3), np.float32)),
                          "is_last": True, "empty": True}]
        else:
            envelopes = [{"job_id": job_id, "worker_id": worker_id, "batch_idx": idx,
                          "image": img_utils.encode_image_data_url(arr[idx]),
                          "is_last": idx == arr.shape[0] - 1}
                         for idx in range(arr.shape[0])]
        if audio is not None:
            envelopes[-1]["audio"] = audio_utils.encode_audio_payload(audio["waveform"],
                                                                      audio["sample_rate"])
        return envelopes

    def _send_to_master(self, images, audio, worker_id: str, master_url: str,
                        job_id: str) -> None:
        """POST the envelopes in order. Transport failures and 5xx answers
        retry under the HTTP policy (the master drops a repeated
        envelope); a 4xx is the master's verdict and raises."""
        url = f"{master_url.rstrip('/')}/distributed/job_complete"
        # the trace is active on this (executor) thread, not on the server
        # loop that sends
        from ..telemetry import TRACE_HEADER, current_trace_id

        trace_id = current_trace_id()
        headers = {TRACE_HEADER: trace_id} if trace_id else None

        async def post(envelope):
            status, out = await request_json_async("POST", url, envelope, timeout=120.0,
                                                   headers=headers)
            if status >= 500:
                raise TransientServerError(f"job_complete -> HTTP {status}: {out}", worker_id)
            if status != 200:
                raise WorkerError(f"job_complete -> HTTP {status}: {out}", worker_id)

        async def send_all():
            for envelope in self.envelopes(images, worker_id, job_id, audio):
                await retry_async(lambda: post(envelope), http_policy(),
                                  retryable=transport_errors() + (TransientServerError,),
                                  label=f"job_complete:{worker_id}")

        run_async_in_server_loop(send_all(), timeout=300)

    # --- master side --------------------------------------------------------

    def _collect_master(self, images, audio, job_id: str, enabled_worker_ids: list[str],
                        context):
        server = getattr(context, "server", None)
        if server is None:
            return (images, audio)
        try:
            if not enabled_worker_ids:
                return (images, audio)
            collected = self._drain_worker_results(server, job_id, enabled_worker_ids, context)
        finally:
            # the orchestration made this job for the prompt: it ends here
            run_async_in_server_loop(server.job_store.cleanup_collector(job_id), timeout=30)
        batches: dict[int, np.ndarray] = {0: img_utils.ensure_numpy(images)}
        order = {wid: i + 1 for i, wid in enumerate(enabled_worker_ids)}
        per_worker: dict[str, list[tuple[int, np.ndarray]]] = {}
        audio_parts: list[tuple[np.ndarray, int]] = []
        if audio is not None:
            audio_parts.append((img_utils.ensure_numpy(audio["waveform"]),
                                int(audio["sample_rate"])))
        for item in collected:
            if item.get("audio") is not None:
                audio_parts.append(item["audio"])
            if item.get("empty"):
                continue  # zero-batch marker: the worker finished with no images
            per_worker.setdefault(str(item["worker_id"]), []).append(
                (int(item["batch_idx"]), item["tensor"]))
        next_straggler = len(enabled_worker_ids) + 1
        for wid in sorted(per_worker, key=lambda w: (order.get(w, 10**6), w)):
            idx = order.get(wid)
            if idx is None:
                idx = next_straggler
                next_straggler += 1
            batches[idx] = np.stack([t for _, t in sorted(per_worker[wid], key=lambda p: p[0])])
        ordered = reorder_participant_first(batches, list(range(1, next_straggler)))
        nonempty = [a for a in ordered if a.size]
        if len({a.shape[1:] for a in nonempty}) > 1:
            # keep the first non-empty size (the master's batch may be an
            # empty delegate placeholder of a nominal size)
            target = nonempty[0].shape[1:]
            log(f"collector: mismatched image sizes {sorted({a.shape[1:] for a in nonempty})}; "
                f"keeping {target}")
            nonempty = [a for a in nonempty if a.shape[1:] == target]
        combined_audio = None
        if audio_parts:
            wave, rate = audio_utils.combine_audio(audio_parts)
            device = getattr(audio["waveform"], "device", images.device) if audio is not None \
                else images.device
            combined_audio = {"waveform": torch.from_numpy(wave).to(device), "sample_rate": rate}
        if not nonempty:
            return (images, combined_audio)
        combined = torch.from_numpy(np.concatenate(nonempty, axis=0))
        return (combined.to(images.device), combined_audio)

    def _drain_worker_results(self, server, job_id: str, enabled_worker_ids: list[str],
                              context) -> list[dict[str, Any]]:
        """Sliced waits on the collector job's queue until every enabled
        worker has sent its last envelope and the queue is empty. A stall
        of the configured worker timeout probes the missing workers: one
        busy extends the grace, else they are given up."""
        timeout = worker_timeout_seconds(getattr(context, "config", None) or {})
        slice_s = max(timeout / COLLECTOR_WAIT_SLICES, 0.05)
        expected = set(map(str, enabled_worker_ids))
        store = server.job_store
        collected: list[dict[str, Any]] = []
        seen: set[tuple[str, int]] = set()
        stall_deadline = time.monotonic() + timeout

        async def get_one():
            job = await store.wait_for_collector(job_id, JOB_INIT_GRACE_SECONDS)
            if job is None:  # drained and cleaned up before: nothing more comes
                return None, expected, True
            try:
                item = await asyncio.wait_for(job.queue.get(), slice_s)
            except asyncio.TimeoutError:
                item = None
            # read on the loop, where put_collector_result queues an item
            # before it marks its worker finished
            finished = job.finished_workers & expected
            return item, finished, finished == expected and job.queue.empty()

        while True:
            context.check_interrupted()
            item, finished, done = run_async_in_server_loop(
                get_one(), timeout=slice_s + JOB_INIT_GRACE_SECONDS + 5)
            if item is not None:
                stall_deadline = time.monotonic() + timeout
                key = (str(item["worker_id"]), int(item["batch_idx"]))
                if key in seen:
                    debug_log(f"collector {job_id}: dropped a repeated envelope {key}")
                else:
                    seen.add(key)
                    collected.append(item)
            if done:
                return collected
            if time.monotonic() >= stall_deadline:
                missing = sorted(expected - finished)
                if self._probe_any_busy(missing, context):
                    debug_log(f"collector {job_id}: {missing} busy; extending the grace")
                    stall_deadline = time.monotonic() + timeout
                    continue
                log(f"collector {job_id}: giving up on workers {missing}")
                return collected

    @staticmethod
    def _probe_any_busy(worker_ids: list[str], context) -> bool:
        config = getattr(context, "config", None) or {}
        workers = {str(w.get("id")): w for w in config.get("workers", [])}

        async def probe_all():
            for wid in worker_ids:
                worker = workers.get(wid)
                if worker is None:
                    continue
                result = await probe_worker(build_worker_url(worker))
                if result["online"] and (result["queue_remaining"] or 0) > 0:
                    return True
            return False

        return run_async_in_server_loop(probe_all(), timeout=30)
