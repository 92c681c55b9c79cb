"""Pipelined tile execution for the elastic USDU tier.

The port's own copy of comfyui_distributed_tpu/graph/tile_pipeline.py:

- **GrantSampler** runs a grant (a list of tile indices) through the
  per-tile processor, one tile after another: the JAX CPU value of the
  tile batch, K = 1, and no mesh sharding. K > 1 tile batching rides
  the cross-job tier, ROADMAP Queue 1 item 4b; the multi-GPU tier is
  Queue 1, item 6.
- **TilePipeline** is a three-stage pipeline over any grant source:
  pull prefetch (one grant ahead), device sampling, and host readback +
  encode + submit flush on an I/O thread, so the next tile's sampling is
  launched while the previous tile's result is read back, encoded and
  shipped. Heartbeats flow from the I/O stage, including while a tile
  samples. `threaded=False` (CDT_PIPELINE=0) runs the same stages
  serially on the calling thread.

Readback on the I/O thread: `to_host` copies tensors the sampling
thread produced. Both threads issue work on the device's legacy default
stream, so the copy is ordered after the kernels that wrote the tensor;
work moved to another stream would need an event the I/O thread waits
on.

Determinism: pipelining changes when tiles run, never their inputs:
initial and step noise are drawn per GLOBAL tile index, so a requeued
tile gives the same pixels wherever it runs.

Interrupts: claimed-but-unsubmitted tiles go to the `release` callback
on an interrupt (InterruptedError) so they requeue at once;
any other failure leaves them to the master's heartbeat timeout, like a
crashed worker.

Telemetry, at the JAX package's seams:

- `stage_span` opens a tracer span ``tile.<stage>`` (pull | sample |
  dispatch | readback | encode | submit | decode | blend | cache.probe
  | cache.hit) and observes ``cdt_tile_stage_seconds{stage, role}``; an
  empty pull is left out of the histogram. Readback, encode, decode and
  submit wall time also lands in the transfer ledger's gather, encode
  and ship buckets.
- `GrantSampler.sample` brackets each dispatch in a ``tile.dispatch``
  span and hands its wall time to the usage meter (one real slot a
  tile, ``tier="scan"``, ``chips=1``) and to the ledger. While the
  ledger is on (CDT_PROFILING) and the tile ran on the card, the
  bracket ends with a CUDA event recorded on the sampler's stream after
  the tile's launches and waited on with `event.synchronize()`, so the
  bracket is the card's execution, as `jax.block_until_ready` makes it
  in the JAX package; only that stream is waited on, never the whole
  device, so the I/O thread's readback of the previous tile is not
  serialised with it. A failed wait raises. On the CPU nothing is
  waited on and the dispatch is host time (``device=False``).
- `GrantSampler.collect` notes the readback's bytes as D2H.
- The pipeline's puller and I/O threads join their caller's trace, so
  their spans land in the same tree.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from typing import Any, Callable, Optional, Sequence

from ..telemetry import current_trace_id, get_tracer
from ..telemetry.instruments import pipeline_batches_total, pipeline_inflight, tile_stage_seconds
from ..telemetry.profiling import D2H, STAGE_HOST_BUCKETS, ledger_if_enabled
from ..utils.constants import HEARTBEAT_INTERVAL_SECONDS, PIPELINE_DEPTH, PIPELINE_PREFETCH
from ..utils.logging import debug_log


@contextlib.contextmanager
def stage_span(stage: str, role: str, tile_idx: int | None = None, **attrs):
    """Span + latency histogram around one tile stage. The yielded span's
    `attrs` are free to annotate; a pull that drained empty (the caller
    sets attrs["outcome"] = "empty") stays out of the histogram and the
    ledger, since an empty poll lasts its full timeout by construction
    (cdt_store_pulls_total{outcome="empty"} counts them). The span clock
    is the tracer's (injectable); the histogram uses the monotonic wall
    clock."""
    span_attrs: dict[str, Any] = {"stage": stage, "role": role, **attrs}
    if tile_idx is not None:
        span_attrs["tile_idx"] = int(tile_idx)
    started = time.monotonic()
    span = None
    try:
        with get_tracer().span(f"tile.{stage}", **span_attrs) as span:
            yield span
    finally:
        if span is None or span.attrs.get("outcome") != "empty":
            elapsed = time.monotonic() - started
            tile_stage_seconds().observe(elapsed, stage=stage, role=role)
            bucket = STAGE_HOST_BUCKETS.get(stage)
            if bucket is not None:
                ledger = ledger_if_enabled()
                if ledger is not None:
                    ledger.note_host(bucket, elapsed)


class GrantSampler:
    """Runs grants through the per-tile processor over a prepared tile set,
    one tile a dispatch (K = 1).

    `process(tile, tile_index, noise, pos, neg, yx)` is the per-tile
    processor (ops/upscale.py::_process_tile_fn); `noise(tile_index,
    shape)` draws a tile's noise from its global index. `sample(idxs)`
    returns the processed tiles [n, B, th, tw, C] on the processor's
    device; `collect` reads them back to the host. `role` and `job_id`
    label the dispatch's span, histogram and usage record (the process's
    usage meter, while CDT_USAGE is on)."""

    def __init__(self, process: Callable, extracted: Any, positions: Sequence[tuple[int, int]],
                 pos: Any, neg: Any, noise: Callable, role: str = "worker", job_id: str = ""):
        from ..telemetry.usage import get_usage_meter
        from ..utils.constants import USAGE_ENABLED

        self.process = process
        self.extracted = extracted
        self.positions = positions
        self.pos = pos
        self.neg = neg
        self.noise = noise
        self.role = role
        self.job_id = str(job_id)
        self.usage = get_usage_meter() if USAGE_ENABLED else None
        # a dispatch on the card is device time; on the CPU it is host
        # work, and the run's host-tax reads 1.0
        self._device = bool(getattr(extracted, "is_cuda", False))

    def chunks(self, grant: Sequence[int]) -> list[list[int]]:
        """Split a grant into dispatch-sized chunks (one tile each)."""
        return [[int(t)] for t in grant]

    def _dispatch_span(self, idxs: Sequence[int], real: int):
        """One ``tile.dispatch`` span per device dispatch, with the JAX
        package's attributes."""
        attrs: dict[str, Any] = {"real": int(real), "bucket": int(real), "jobs": 1,
                                 "device": self._device}
        if self.job_id:
            attrs["slot_jobs"] = {self.job_id: int(real)}
        return stage_span("dispatch", self.role, int(idxs[0]), **attrs)

    def _wait_for_card(self) -> None:
        """Block until the card has run every launch this thread made so
        far on the tiles' device: an event recorded on the current stream,
        then waited on. Raises if the wait fails."""
        import torch

        stream = torch.cuda.current_stream(self.extracted.device)
        event = torch.cuda.Event()
        event.record(stream)
        event.synchronize()

    def sample(self, idxs: Sequence[int]):
        import torch

        idxs = [int(t) for t in idxs]
        n = len(idxs)
        pipeline_batches_total().inc(n, role=self.role, bucket="1")
        started = time.monotonic()
        with self._dispatch_span(idxs, real=n):
            out = torch.stack([
                self.process(self.extracted[i], i, self.noise, self.pos, self.neg,
                             self.positions[i])
                for i in idxs
            ])
            if self._device and ledger_if_enabled() is not None:
                # launches are asynchronous: the ledger wants the card's
                # execution, so the bracket ends when the card is done
                self._wait_for_card()
        elapsed = time.monotonic() - started
        self._note_usage(elapsed, real=n)
        self._note_profiling(elapsed, real=n)
        return out

    def _note_usage(self, elapsed_s: float, real: int) -> None:
        """The dispatch's slot-exact attribution record: every slot is a
        real tile of this job (no padding at K = 1), and each real slot
        is a finished tile."""
        if self.usage is None:
            return
        from ..telemetry.usage import SLOT_REAL

        self.usage.note_dispatch(tier="scan", role=self.role, elapsed_s=elapsed_s, chips=1,
                                 slots=[{"job_id": self.job_id, "kind": SLOT_REAL}] * int(real))
        self.usage.note_tiles(self.role, self.job_id, int(real))

    def _note_profiling(self, elapsed_s: float, real: int) -> None:
        ledger = ledger_if_enabled()
        if ledger is None:
            return
        ledger.note_dispatch(elapsed_s, tier="scan", role=self.role, device=self._device)
        ledger.note_tiles(int(real))

    def collect(self, result):
        """Read a sample() result back to the host as float32 numpy; the
        bytes and the wall time are the ledger's D2H transfer."""
        from ..utils import image as img_utils

        ledger = ledger_if_enabled()
        started = time.monotonic()
        host = img_utils.ensure_numpy(result)
        if ledger is not None:
            ledger.note_transfer(D2H, int(host.nbytes), time.monotonic() - started)
        return host


class _Stop:
    pass


_STOP = _Stop()


class TilePipeline:
    """Staged executor over a grant source; see the module docstring.

    Callbacks:
      pull()                -> list[int] | None   (None/[] = drained)
      sample(idxs)          -> device result [n, B, ...]
      to_host(result)       -> host ndarray (default: utils.image.ensure_numpy)
      emit(tile_idx, arr)   per-tile encode/queue (arr is [B, h, w, C])
      flush(final: bool)    submit pending results (thresholds inside)
      heartbeat()           optional liveness ping (the I/O stage owns it)
      check_interrupted()   optional; raising stops the pipeline
      release(idxs)         optional; claimed-but-unsubmitted tiles on an
                            interrupt (InterruptedError only)
    """

    def __init__(
        self,
        *,
        pull: Callable[[], Optional[Sequence[int]]],
        sample: Callable[[Sequence[int]], Any],
        emit: Callable[[int, Any], None],
        flush: Callable[[bool], None],
        chunks: Callable[[Sequence[int]], list[list[int]]] | None = None,
        to_host: Callable[[Any], Any] | None = None,
        heartbeat: Callable[[], None] | None = None,
        check_interrupted: Callable[[], None] | None = None,
        release: Callable[[list[int]], None] | None = None,
        depth: int | None = None,
        prefetch: bool | None = None,
        threaded: bool = True,
        role: str = "worker",
        span_attrs: dict[str, Any] | None = None,
    ) -> None:
        self._pull = pull
        self._sample = sample
        self._emit = emit
        self._flush = flush
        self._chunks = chunks or (lambda grant: [list(grant)])
        self._to_host = to_host or self._default_to_host
        self._heartbeat = heartbeat
        self._check_interrupted = check_interrupted
        self._release = release
        self.depth = max(1, depth if depth is not None else PIPELINE_DEPTH)
        self.threaded = bool(threaded)
        prefetch = PIPELINE_PREFETCH if prefetch is None else bool(prefetch)
        self.prefetch = prefetch and self.threaded
        self.role = role
        # extra attributes of every stage span (the worker's id)
        self.span_attrs = dict(span_attrs or {})
        self._stop = threading.Event()
        self._errors: list[BaseException] = []
        self._error_lock = threading.Lock()
        self._claimed: list[int] = []
        self._emitted: set[int] = set()
        # notified as each tile is encoded (wait_emitted)
        self._emitted_cond = threading.Condition()
        self.batches = 0
        self.tiles = 0

    # --- plumbing ---------------------------------------------------------

    @staticmethod
    def _default_to_host(result):
        from ..utils import image as img_utils

        return img_utils.ensure_numpy(result)

    def _record_error(self, exc: BaseException) -> None:
        with self._error_lock:
            self._errors.append(exc)
        self._stop.set()

    def _first_error(self) -> Optional[BaseException]:
        with self._error_lock:
            return self._errors[0] if self._errors else None

    def _put(self, q: queue.Queue, item: Any) -> bool:
        """Bounded put that stays responsive to stop; False = stopped."""
        while not self._stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    # --- stages -----------------------------------------------------------

    def _pull_grant(self) -> Optional[list[int]]:
        with stage_span("pull", self.role, **self.span_attrs) as span:
            grant = self._pull()
            if not grant:
                span.attrs["outcome"] = "empty"
                return None
            grant = [int(t) for t in grant]
            span.attrs["tile_idx"] = grant[0]
            if len(grant) > 1:
                span.attrs["batch"] = list(grant)
        return grant

    def _puller_body(self, grant_q: queue.Queue, trace_id: Optional[str]) -> None:
        tracer = get_tracer()
        token = tracer.activate(trace_id) if trace_id else None
        try:
            while not self._stop.is_set():
                grant = self._pull_grant()
                if grant is None:
                    self._put(grant_q, _STOP)
                    return
                self._claimed.extend(grant)
                if not self._put(grant_q, grant):
                    return
        except BaseException as exc:  # noqa: BLE001 - forwarded to run()
            self._record_error(exc)
            with contextlib.suppress(queue.Full):
                grant_q.put_nowait(_STOP)
        finally:
            if token is not None:
                tracer.deactivate(token)

    def _io_body(self, work_q: queue.Queue, trace_id: Optional[str]) -> None:
        tracer = get_tracer()
        token = tracer.activate(trace_id) if trace_id else None
        try:
            while True:
                try:
                    item = work_q.get(timeout=HEARTBEAT_INTERVAL_SECONDS)
                except queue.Empty:
                    if self._stop.is_set():
                        return
                    # the device stage is mid-tile or the puller waits on
                    # the master: keep liveness flowing
                    if self._heartbeat is not None:
                        self._heartbeat()
                    continue
                if isinstance(item, _Stop):
                    return
                idxs, result = item
                # +1: the tile just popped is sampled but not read back
                pipeline_inflight().set(work_q.qsize() + 1, role=self.role)
                try:
                    self._drain_item(idxs, result)
                finally:
                    work_q.task_done()
                    pipeline_inflight().set(work_q.qsize(), role=self.role)
        except BaseException as exc:  # noqa: BLE001 - forwarded to run()
            self._record_error(exc)
        finally:
            if token is not None:
                tracer.deactivate(token)

    def _drain_item(self, idxs: list[int], result: Any) -> None:
        """Readback + per-tile encode + flush for one device result. The
        flush callback is consulted after every tile (it applies its size
        thresholds itself)."""
        with stage_span("readback", self.role, idxs[0], batch=list(idxs), **self.span_attrs):
            host = self._to_host(result)
        for i, tile_idx in enumerate(idxs):
            with stage_span("encode", self.role, tile_idx, **self.span_attrs):
                self._emit(tile_idx, host[i])
            with self._emitted_cond:
                self._emitted.add(int(tile_idx))
                self._emitted_cond.notify_all()
            self.tiles += 1
            if self._heartbeat is not None:
                self._heartbeat()
            self._flush(False)

    def wait_emitted(self) -> bool:
        """Block until every tile claimed so far has been encoded (handed
        to `emit`), or the pipeline stopped; True when they all were. A
        worker about to park for more work calls it from `pull` before it
        ships what it holds: the sampling and I/O stages run on other
        threads, and the puller's wait does not hold them up."""
        with self._emitted_cond:
            while not self._stop.is_set() and not set(self._claimed) <= self._emitted:
                self._emitted_cond.wait(0.1)
            return set(self._claimed) <= self._emitted

    def _sample_chunk(self, chunk: list[int]) -> Any:
        with stage_span("sample", self.role, chunk[0], batch=list(chunk), **self.span_attrs):
            result = self._sample(chunk)
        self.batches += 1
        return result

    # --- main loop --------------------------------------------------------

    def _run_sync(self) -> None:
        """CDT_PIPELINE=0: the same stages, strictly serial."""
        while True:
            if self._check_interrupted is not None:
                self._check_interrupted()
            grant = self._pull_grant()
            if grant is None:
                return
            self._claimed.extend(grant)
            for chunk in self._chunks(grant):
                if self._check_interrupted is not None:
                    self._check_interrupted()
                self._drain_item(list(chunk), self._sample_chunk(chunk))

    def _run_threaded(self) -> None:
        # the stage threads join this thread's trace
        trace_id = current_trace_id()
        work_q: queue.Queue = queue.Queue(maxsize=self.depth)
        io_thread = threading.Thread(target=self._io_body, args=(work_q, trace_id),
                                     name="cdt-tile-io", daemon=True)
        io_thread.start()
        grant_q: queue.Queue = queue.Queue(maxsize=1)
        puller: Optional[threading.Thread] = None
        if self.prefetch:
            puller = threading.Thread(target=self._puller_body, args=(grant_q, trace_id),
                                      name="cdt-tile-pull", daemon=True)
            puller.start()
        try:
            while True:
                if self._check_interrupted is not None:
                    self._check_interrupted()
                if self._first_error() is not None:
                    break
                if puller is not None:
                    try:
                        grant = grant_q.get(timeout=0.1)
                    except queue.Empty:
                        continue
                    if isinstance(grant, _Stop):
                        break
                else:
                    grant = self._pull_grant()
                    if grant is None:
                        break
                    self._claimed.extend(grant)
                for chunk in self._chunks(grant):
                    if self._check_interrupted is not None:
                        self._check_interrupted()
                    if self._first_error() is not None:
                        break
                    if not self._put(work_q, (list(chunk), self._sample_chunk(chunk))):
                        break
                if self._first_error() is not None:
                    break
        except BaseException as exc:  # noqa: BLE001 - unified exit in run()
            self._record_error(exc)
        finally:
            self._stop.set()
            # deliver the sentinel even while the queue is momentarily
            # full: losing it would stall shutdown for an idle interval
            while io_thread.is_alive():
                try:
                    work_q.put(_STOP, timeout=0.1)
                    break
                except queue.Full:
                    continue
            io_thread.join(timeout=30)
            if puller is not None:
                puller.join(timeout=30)
            pipeline_inflight().set(0, role=self.role)

    def run(self) -> dict[str, Any]:
        """Run until the grant source drains; returns summary stats.
        Raises the first stage error after shutting the stages down; on
        an interrupt, claimed-but-unsubmitted tiles go to `release` first
        so they requeue at once."""
        if self.threaded:
            self._run_threaded()
        else:
            try:
                self._run_sync()
            except BaseException as exc:  # noqa: BLE001 - unified exit below
                self._record_error(exc)
        error = self._first_error()
        if error is None:
            self._flush(True)  # the final flush marks this worker done
            return {"batches": self.batches, "tiles": self.tiles}
        if isinstance(error, InterruptedError):
            # ship what is already encoded, then hand back the rest
            try:
                self._flush(True)
            except Exception as exc:  # noqa: BLE001 - best effort
                debug_log(f"final flush after interrupt failed: {exc}")
            if self._release is not None:
                orphaned = sorted(set(self._claimed) - self._emitted)
                if orphaned:
                    try:
                        self._release(orphaned)
                    except Exception as exc:  # noqa: BLE001 - best effort
                        debug_log(f"grant release after interrupt failed: {exc}")
        raise error
