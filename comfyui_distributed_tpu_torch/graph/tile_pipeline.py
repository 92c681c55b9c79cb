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

`stage_span` times one stage (pull | sample | readback | encode |
submit | decode | blend | cache.probe | cache.hit) and adds its wall seconds to the StageTotals
passed as its `totals` attribute; the JAX package's tracer spans are
not ported yet.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from typing import Any, Callable, Optional, Sequence

from ..utils.constants import HEARTBEAT_INTERVAL_SECONDS, PIPELINE_DEPTH, PIPELINE_PREFETCH
from ..utils.logging import debug_log


class StageTotals:
    """Wall seconds per stage, summed over one participant's run of a
    job; thread-safe (the pipeline's threads all add to it)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._seconds: dict[str, float] = {}

    def add(self, stage: str, seconds: float) -> None:
        with self._lock:
            self._seconds[stage] = self._seconds.get(stage, 0.0) + seconds

    def seconds(self) -> dict[str, float]:
        with self._lock:
            return dict(self._seconds)


class _Span:
    def __init__(self, attrs: dict[str, Any]):
        self.attrs = attrs


@contextlib.contextmanager
def stage_span(stage: str, role: str, tile_idx: int | None = None, **attrs):
    """Time one tile stage. The yielded span's `attrs` are free to
    annotate; a pull that drained empty (the caller sets
    attrs["outcome"] = "empty") is not counted, since an empty poll
    lasts its full timeout by construction. `totals`, if given, is the
    StageTotals the wall time is added to."""
    totals: Optional[StageTotals] = attrs.pop("totals", None)
    span = _Span({"stage": stage, "role": role, **attrs})
    if tile_idx is not None:
        span.attrs["tile_idx"] = int(tile_idx)
    started = time.monotonic()
    try:
        yield span
    finally:
        if totals is not None and span.attrs.get("outcome") != "empty":
            totals.add(stage, time.monotonic() - started)


class GrantSampler:
    """Runs grants through the per-tile processor over a prepared tile set,
    one tile a dispatch (K = 1).

    `process(tile, tile_index, noise, pos, neg, yx)` is the per-tile
    processor (ops/upscale.py::_process_tile_fn); `noise(tile_index,
    shape)` draws a tile's noise from its global index. `sample(idxs)`
    returns the processed tiles [n, B, th, tw, C] on the processor's
    device; `collect` reads them back to the host."""

    def __init__(self, process: Callable, extracted: Any, positions: Sequence[tuple[int, int]],
                 pos: Any, neg: Any, noise: Callable):
        self.process = process
        self.extracted = extracted
        self.positions = positions
        self.pos = pos
        self.neg = neg
        self.noise = noise

    def chunks(self, grant: Sequence[int]) -> list[list[int]]:
        """Split a grant into dispatch-sized chunks (one tile each)."""
        return [[int(t)] for t in grant]

    def sample(self, idxs: Sequence[int]):
        import torch

        return torch.stack([
            self.process(self.extracted[i], i, self.noise, self.pos, self.neg, self.positions[i])
            for i in (int(t) for t in idxs)
        ])

    def collect(self, result):
        """Read a sample() result back to the host as float32 numpy."""
        from ..utils import image as img_utils

        return img_utils.ensure_numpy(result)


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
        stage_totals: StageTotals | None = None,
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
        self.stage_totals = stage_totals if stage_totals is not None else StageTotals()
        self._stop = threading.Event()
        self._errors: list[BaseException] = []
        self._error_lock = threading.Lock()
        self._claimed: list[int] = []
        self._emitted: set[int] = set()
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
        with stage_span("pull", self.role, totals=self.stage_totals) as span:
            grant = self._pull()
            if not grant:
                span.attrs["outcome"] = "empty"
                return None
            grant = [int(t) for t in grant]
            span.attrs["tile_idx"] = grant[0]
        return grant

    def _puller_body(self, grant_q: queue.Queue) -> None:
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

    def _io_body(self, work_q: queue.Queue) -> None:
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
                try:
                    self._drain_item(idxs, result)
                finally:
                    work_q.task_done()
        except BaseException as exc:  # noqa: BLE001 - forwarded to run()
            self._record_error(exc)

    def _drain_item(self, idxs: list[int], result: Any) -> None:
        """Readback + per-tile encode + flush for one device result. The
        flush callback is consulted after every tile (it applies its size
        thresholds itself)."""
        with stage_span("readback", self.role, idxs[0], totals=self.stage_totals):
            host = self._to_host(result)
        for i, tile_idx in enumerate(idxs):
            with stage_span("encode", self.role, tile_idx, totals=self.stage_totals):
                self._emit(tile_idx, host[i])
            self._emitted.add(int(tile_idx))
            self.tiles += 1
            if self._heartbeat is not None:
                self._heartbeat()
            self._flush(False)

    def _sample_chunk(self, chunk: list[int]) -> Any:
        with stage_span("sample", self.role, chunk[0], totals=self.stage_totals):
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
        work_q: queue.Queue = queue.Queue(maxsize=self.depth)
        io_thread = threading.Thread(target=self._io_body, args=(work_q,), name="cdt-tile-io",
                                     daemon=True)
        io_thread.start()
        grant_q: queue.Queue = queue.Queue(maxsize=1)
        puller: Optional[threading.Thread] = None
        if self.prefetch:
            puller = threading.Thread(target=self._puller_body, args=(grant_q,),
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
