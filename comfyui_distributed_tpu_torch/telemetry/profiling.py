"""Device-time attribution: the transfer ledger.

The port's own copy of the ledger half of
comfyui_distributed_tpu/telemetry/profiling.py. Of each tile's wall
time, how much was the card computing and how much the host gathering,
encoding and shipping around it? The spans time whole stages; the
ledger splits the device/host seam inside them.

:class:`TransferLedger` keeps cumulative integer-nanosecond accounting
of the device↔host boundary, fed by the elastic tier's seams
(graph/tile_pipeline.py: ``GrantSampler.sample``, ``GrantSampler.collect``
and ``stage_span``):

- device-execute time: the wall time of each dispatch bracket, which
  ends in a wait for a CUDA event recorded on the sampler's stream
  after the tile's launches. Only dispatches that ran on the card
  count; a dispatch on the CPU (the tests) is host work by
  construction, so a run that never touched a card reports a host-tax
  of 1.0, never a fiction;
- bytes moved each direction (``h2d``/``d2h``);
- host time split into ``gather`` (device→host readback), ``encode``
  (PNG encode and decode) and ``ship`` (submit RPCs).

The roll-up is the **host-tax ratio** ``host_ns / (host_ns +
device_ns)``: the host share of the bracketed tile time. It is not the
card's idle share: the bracket also holds the host's own launch time.
There is one ledger a process, so participants sharing a process share
one ratio. It is mirrored into
``cdt_transfer_bytes_total`` / ``cdt_device_execute_seconds`` /
``cdt_host_tax_ratio`` at scrape time (telemetry/instruments.py).

:class:`ProfilerCapture` is the on-demand device trace behind
``/distributed/profile`` (api/profile_routes.py): a bounded
``torch.profiler`` capture where the JAX package takes a
``jax.profiler`` trace, one Chrome-trace JSON a capture directory, with
the JAX manager's single flight, duration cap, auto-stop and retention.

All clocks are injectable and used only for durations.
"""

from __future__ import annotations

import contextlib
import os
import re
import shutil
import threading
import time
from typing import Any, Callable, Optional

from ..utils import constants

_NS = 1_000_000_000

# Transfer directions (metric label vocabulary).
H2D = "h2d"
D2H = "d2h"

# Host-time buckets; stage_span feeds these via STAGE_HOST_BUCKETS.
HOST_BUCKETS = ("gather", "encode", "ship")

# tile.<stage> span names -> the host bucket their wall time charges.
# `readback` is the device→host gather, `encode`/`decode` are pixel
# codec work, `submit` is the ship RPC. `pull`/`blend`/`dispatch` are
# deliberately absent: pull is wait, blend is master canvas math, and
# dispatch is attributed through note_dispatch's device/eager split.
STAGE_HOST_BUCKETS = {
    "readback": "gather",
    "encode": "encode",
    "decode": "encode",
    "submit": "ship",
}


def _to_ns(seconds: float) -> int:
    """Non-negative integer nanoseconds (the usage meter's conservation idiom:
    all arithmetic downstream is integral, so sums are exact)."""
    return max(0, int(round(float(seconds) * _NS)))


def transfer_nbytes(array: Any) -> int:
    """Byte size of one transferred array (a torch tensor or a numpy
    array), 0 when it cannot say: the ledger must never turn a dispatch
    into a crash, and an unanswerable size still lands the transfer's
    TIME."""
    nbytes = getattr(array, "nbytes", None)
    if nbytes is None and hasattr(array, "element_size") and hasattr(array, "numel"):
        nbytes = array.element_size() * array.numel()
    try:
        return int(nbytes) if nbytes is not None else 0
    except (TypeError, ValueError):
        return 0


class TransferLedger:
    """Cumulative device/host attribution for one process.

    Thread-safe; every count is a non-negative integer (ns or bytes).
    ``clock`` is injectable for the few places the ledger measures
    itself (``timed_sync``); seams that already bracket their own work
    pass ``elapsed_s`` in.
    """

    def __init__(self, clock: Callable[[], float] = time.monotonic) -> None:
        self.clock = clock
        self._lock = threading.Lock()
        self.device_ns = 0
        self.device_dispatches = 0
        # wall of dispatches that ran on no card (the CPU): tracked so
        # the split is auditable, but NEVER counted as device time — a
        # run on the CPU has no device, and its host-tax must read 1.0
        self.eager_ns = 0
        self.eager_dispatches = 0
        self.host_ns: dict[str, int] = {b: 0 for b in HOST_BUCKETS}
        self.transfer: dict[str, dict[str, int]] = {
            H2D: {"bytes": 0, "ns": 0, "count": 0},
            D2H: {"bytes": 0, "ns": 0, "count": 0},
        }
        self.tiles = 0
        # scrape-time delta marks for the mirrored counters (the
        # flight-recorder idiom — see instruments.bind_server_collectors)
        self.scrape_mirrored: dict[str, int] = {}

    # -- seams -------------------------------------------------------------

    def note_dispatch(
        self,
        elapsed_s: float,
        *,
        tier: str = "scan",
        role: str = "worker",
        device: bool = True,
    ) -> None:
        """One device dispatch's bracketed wall time. ``device=False``
        (the dispatch ran on the CPU — nothing ran on a card) keeps the
        time out of ``device_ns``."""
        ns = _to_ns(elapsed_s)
        with self._lock:
            if device:
                self.device_ns += ns
                self.device_dispatches += 1
            else:
                self.eager_ns += ns
                self.eager_dispatches += 1
        if device:
            try:
                from .instruments import device_execute_seconds

                device_execute_seconds().observe(
                    float(elapsed_s), role=role, tier=tier
                )
            except Exception:  # noqa: BLE001 - accounting is best effort
                pass

    def note_host(self, bucket: str, elapsed_s: float) -> None:
        """Host-side wall time in one of the gather/encode/ship
        buckets; unknown buckets are ignored (the stage vocabulary can
        grow without version-locking the ledger)."""
        if bucket not in self.host_ns:
            return
        ns = _to_ns(elapsed_s)
        with self._lock:
            self.host_ns[bucket] += ns

    def note_transfer(
        self, direction: str, nbytes: int, elapsed_s: float = 0.0
    ) -> None:
        """Bytes crossing the device↔host boundary (``h2d``/``d2h``)
        plus the transfer's wall time when the caller measured it."""
        entry = self.transfer.get(direction)
        if entry is None:
            return
        with self._lock:
            entry["bytes"] += max(0, int(nbytes))
            entry["ns"] += _to_ns(elapsed_s)
            entry["count"] += 1

    def note_tiles(self, n: int = 1) -> None:
        with self._lock:
            self.tiles += int(n)

    @contextlib.contextmanager
    def timed_sync(self, *, bucket: str = "gather"):
        """Bracket a host-side materialisation (a ``device_get`` /
        ``block_until_ready`` sync point) on the ledger's clock; the
        elapsed wall charges ``bucket``."""
        started = self.clock()
        try:
            yield
        finally:
            self.note_host(bucket, self.clock() - started)

    # -- roll-ups ----------------------------------------------------------

    def host_total_ns(self) -> int:
        with self._lock:
            return sum(self.host_ns.values())

    def host_tax(self) -> float:
        """``host_ns / (host_ns + device_ns)``. A run that never
        touched a device (device_ns == 0 — a run on the CPU) reports 1.0: all attributable time was
        host time. Never NaN."""
        with self._lock:
            host = sum(self.host_ns.values())
            device = self.device_ns
        if device <= 0:
            return 1.0
        return host / float(host + device)

    def snapshot(self, role: str = "worker") -> dict[str, Any]:
        """The cumulative block the fleet snapshot piggyback carries.
        All integers except the derived ratio."""
        with self._lock:
            return {
                "role": role,
                "device_ns": self.device_ns,
                "device_dispatches": self.device_dispatches,
                "eager_ns": self.eager_ns,
                "eager_dispatches": self.eager_dispatches,
                "host_ns": dict(self.host_ns),
                "transfer": {
                    d: dict(v) for d, v in self.transfer.items()
                },
                "tiles": self.tiles,
                "host_tax": self._host_tax_locked(),
            }

    def _host_tax_locked(self) -> float:
        host = sum(self.host_ns.values())
        if self.device_ns <= 0:
            return 1.0
        return host / float(host + self.device_ns)

    def totals(self, role: str = "worker") -> dict[str, Any]:
        snap = self.snapshot(role)
        snap["host_total_ns"] = sum(snap["host_ns"].values())
        return snap


def merge_profiling_blocks(blocks: list) -> dict[str, Any]:
    """Sum snapshot() blocks into one profiling roll-up (several
    participants' ledgers, e.g. a master and its worker processes).
    Malformed blocks contribute
    nothing; the derived host-tax follows the same zero-device rule."""
    device_ns = 0
    host_ns = {b: 0 for b in HOST_BUCKETS}
    transfer = {
        H2D: {"bytes": 0, "ns": 0, "count": 0},
        D2H: {"bytes": 0, "ns": 0, "count": 0},
    }
    dispatches = 0
    tiles = 0
    for block in blocks:
        if not isinstance(block, dict):
            continue
        try:
            device_ns += int(block.get("device_ns") or 0)
            dispatches += int(block.get("device_dispatches") or 0)
            tiles += int(block.get("tiles") or 0)
            for bucket in HOST_BUCKETS:
                host_ns[bucket] += int(
                    (block.get("host_ns") or {}).get(bucket) or 0
                )
            for direction in (H2D, D2H):
                src = (block.get("transfer") or {}).get(direction) or {}
                for field in ("bytes", "ns", "count"):
                    transfer[direction][field] += int(src.get(field) or 0)
        except (TypeError, ValueError):
            continue
    host_total = sum(host_ns.values())
    tax = 1.0 if device_ns <= 0 else host_total / float(host_total + device_ns)
    return {
        "device_ns": device_ns,
        "device_dispatches": dispatches,
        "host_ns": host_ns,
        "host_total_ns": host_total,
        "transfer": transfer,
        "tiles": tiles,
        "host_tax": tax,
    }


# --- process-global accessors (telemetry/usage.py's meter idiom) -----------

_ledger: TransferLedger | None = None
_ledger_lock = threading.Lock()


def get_transfer_ledger() -> TransferLedger:
    """The process-global ledger (created on first use). Callers gate
    on ``constants.PROFILING_ENABLED``; the ledger itself is always
    constructible so tests can meter with the knob off."""
    global _ledger
    with _ledger_lock:
        if _ledger is None:
            _ledger = TransferLedger()
        return _ledger


def peek_transfer_ledger() -> TransferLedger | None:
    """The global ledger if one exists — never creates (scrape-time
    mirrors must not allocate state on an idle process)."""
    with _ledger_lock:
        return _ledger


def set_transfer_ledger(
    ledger: TransferLedger | None,
) -> TransferLedger | None:
    """Install a specific ledger (tests, profilers); returns the
    previous one so callers can restore it."""
    global _ledger
    with _ledger_lock:
        prev = _ledger
        _ledger = ledger
        return prev


def _reset_transfer_ledger_for_tests() -> None:
    set_transfer_ledger(None)


def ledger_if_enabled() -> TransferLedger | None:
    """The global ledger when CDT_PROFILING is on, else None — the one
    call hot seams make (a disabled plane costs one attribute read and
    a None check)."""
    if not constants.PROFILING_ENABLED:
        return None
    return get_transfer_ledger()


# --- on-demand torch.profiler capture ---------------------------------------

_CAPTURE_DIR_RE = re.compile(r"trace-(\d{4,})(?:-[a-z0-9_]+)?")
_TAG_SAFE_RE = re.compile(r"[^a-z0-9_]+")
# each capture directory holds one Chrome trace of this name
TRACE_FILE = "trace.json"
# how long a start waits for the profiler thread to report, and a stop
# for the trace's export; past either the call answers instead of
# hanging the route
START_WAIT_SECONDS = 120.0
STOP_WAIT_SECONDS = 600.0


def other_profiler_active() -> bool:
    """Whether a torch.profiler is recording anywhere in this process.
    torch keeps that flag module-global (the per-thread profiler state is
    not visible from another thread), and the card's activity tracer is
    one a process: a second capture would corrupt the first."""
    import torch.autograd.profiler as autograd_profiler

    return bool(getattr(autograd_profiler, "_is_profiler_enabled", False))


class _Recording:
    """One capture's profiler, started and stopped on a thread of its own:
    torch.profiler's enable and disable are per thread, while a capture
    starts on a route's worker thread and stops on another, or on the
    auto-stop timer. CPU ops are recorded on that thread only; the
    card's kernels and runtime calls are traced for the whole process."""

    def __init__(self, path: str, cuda: bool) -> None:
        self.path = path
        self.cuda = cuda
        self.error: Optional[str] = None
        self.result: dict[str, Any] = {}
        self._started = threading.Event()
        self._stop = threading.Event()
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._run, name="cdt-profiler", daemon=True)

    def start(self) -> Optional[str]:
        """Begin recording; the refusal's reason, or None once recording."""
        self._thread.start()
        if not self._started.wait(START_WAIT_SECONDS):
            self._stop.set()
            return f"TimeoutError: the profiler did not start in {START_WAIT_SECONDS:g} s"
        return self.error

    def stop(self) -> dict[str, Any]:
        """End recording and export the trace: {"stop_s", "export_s"}, or
        {"error": reason}."""
        self._stop.set()
        if not self._done.wait(STOP_WAIT_SECONDS):
            return {"error": f"TimeoutError: the trace was not written in "
                             f"{STOP_WAIT_SECONDS:g} s"}
        return dict(self.result)

    def _run(self) -> None:
        try:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if self.cuda:
                activities.append(ProfilerActivity.CUDA)
            prof = profile(activities=activities)
            prof.start()
        except Exception as exc:  # noqa: BLE001 - reported as the refusal
            self.error = f"{type(exc).__name__}: {exc}"
            self._started.set()
            self._done.set()
            return
        self._started.set()
        self._stop.wait()
        try:
            started = time.perf_counter()
            prof.stop()
            stopped = time.perf_counter()
            prof.export_chrome_trace(os.path.join(self.path, TRACE_FILE))
            self.result = {"stop_s": round(stopped - started, 6),
                           "export_s": round(time.perf_counter() - stopped, 6)}
        except Exception as exc:  # noqa: BLE001 - reported by stop()
            self.result = {"error": f"{type(exc).__name__}: {exc}"}
        finally:
            self._done.set()


class ProfilerCapture:
    """Single-flight on-demand torch.profiler capture with bounded
    retention. One capture at a time: a start while one is active (or
    still stopping) answers ``busy``, and a start while another
    torch.profiler records in the process answers a refusal with the
    reason. Captures auto-stop at their duration cap through a daemon
    timer, so an operator who never POSTs /stop cannot leave the
    profiler running. The activities follow the device a start names:
    the CPU and the card for "cuda", the CPU alone for "cpu"."""

    def __init__(self, directory: str, *, clock: Callable[[], float] = time.monotonic,
                 max_seconds: Optional[float] = None, max_captures: Optional[int] = None,
                 max_bytes: Optional[float] = None) -> None:
        self.directory = directory
        self.clock = clock
        self.max_seconds = (float(max_seconds) if max_seconds is not None
                            else constants.PROFILE_MAX_SECONDS)
        self.max_captures = (int(max_captures) if max_captures is not None
                             else constants.PROFILE_MAX_CAPTURES)
        self.max_bytes = (int(max_bytes) if max_bytes is not None
                          else int(constants.PROFILE_MAX_MB * 1024 * 1024))
        self._lock = threading.Lock()
        self._active: Optional[dict[str, Any]] = None
        # the id of a capture still starting or stopping: the slot stays
        # taken until its profiler is on, or its trace written
        self._pending: Optional[str] = None
        self._recording: Optional[_Recording] = None
        self._timer: Optional[threading.Timer] = None
        self._seq = self._scan_seq()
        self.counters = {"started": 0, "stopped": 0, "busy": 0, "errors": 0,
                         "auto_stopped": 0}
        # scrape-time delta marks of the mirrored counter (the flight
        # recorder's idiom, telemetry/instruments.py)
        self.scrape_mirrored: dict[str, int] = {}

    # -- capture lifecycle -------------------------------------------------

    def start(self, duration_s: Optional[float] = None, tag: str = "manual", *,
              device: str) -> dict[str, Any]:
        """Begin a capture; returns the disposition the route serves
        verbatim. The duration is clamped to the cap; the auto-stop timer
        fires even if nobody calls stop(). `device` is the server's and
        picks the activities. Never raises."""
        duration = self.max_seconds
        if duration_s is not None:
            try:
                duration = float(duration_s)
            except (TypeError, ValueError):
                return {"started": False, "reason": "bad_duration"}
        duration = max(0.1, min(duration, self.max_seconds))
        tag_safe = _TAG_SAFE_RE.sub("_", str(tag).lower())[:32] or "manual"
        with self._lock:
            if self._active is not None or self._pending is not None:
                self.counters["busy"] += 1
                active = self._active["id"] if self._active is not None else self._pending
                return {"started": False, "reason": "busy", "active": active}
            self._seq += 1
            capture_id = f"trace-{self._seq:04d}-{tag_safe}"
            # the slot is held while the profiler starts, outside the lock
            self._pending = capture_id
        path = os.path.join(self.directory, capture_id)
        reason = None
        try:
            import torch

            cuda = str(device).startswith("cuda")
            if other_profiler_active():
                reason = "RuntimeError: another torch.profiler is recording in this process"
            elif cuda and not torch.cuda.is_available():
                reason = "RuntimeError: a capture on the card, and CUDA is not available"
            if reason is None:
                os.makedirs(path, exist_ok=True)
                recording = _Recording(path, cuda)
                reason = recording.start()
        except Exception as exc:  # noqa: BLE001 - degrade, never 500
            reason = f"{type(exc).__name__}: {exc}"
        with self._lock:
            self._pending = None
            if reason is not None:
                self.counters["errors"] += 1
                shutil.rmtree(path, ignore_errors=True)
                return {"started": False, "reason": reason}
            self._recording = recording
            self._active = {"id": capture_id, "path": path, "tag": tag_safe,
                            "duration_s": duration, "started_at": self.clock()}
            self.counters["started"] += 1
            timer = threading.Timer(duration, self._auto_stop, args=(capture_id,))
            timer.daemon = True
            timer.start()
            self._timer = timer
            return {"started": True, "id": capture_id, "path": path, "duration_s": duration}

    def stop(self) -> dict[str, Any]:
        """End the active capture and write its trace (no active capture
        answers ``stopped: False``); prunes retention afterwards."""
        with self._lock:
            active, self._active = self._active, None
            recording, self._recording = self._recording, None
            timer, self._timer = self._timer, None
            if active is not None:
                self._pending = active["id"]
        if timer is not None:
            timer.cancel()
        if active is None:
            return {"stopped": False, "reason": "not_running"}
        try:
            elapsed = self.clock() - active["started_at"]
            result = recording.stop()
        finally:
            with self._lock:
                self._pending = None
        if "error" in result:
            with self._lock:
                self.counters["errors"] += 1
            return {"stopped": False, "id": active["id"], "reason": result["error"]}
        with self._lock:
            self.counters["stopped"] += 1
        self._prune()
        return {"stopped": True, "id": active["id"], "path": active["path"],
                "elapsed_s": round(elapsed, 6), "bytes": _dir_bytes(active["path"]),
                "export_s": result["export_s"]}

    def _auto_stop(self, capture_id: str) -> None:
        """Timer callback: stop only if the SAME capture is still active
        (a manual stop and a fresh start must not be ended by the old
        capture's timer)."""
        with self._lock:
            active = self._active
            if active is None or active["id"] != capture_id:
                return
            self.counters["auto_stopped"] += 1
        self.stop()

    # -- retention / listing -----------------------------------------------

    def _scan_seq(self) -> int:
        """Resume the sequence past the directories already there, so ids
        never collide across restarts."""
        seq = 0
        try:
            names = sorted(os.listdir(self.directory))
        except OSError:
            return 0
        for name in names:
            match = _CAPTURE_DIR_RE.fullmatch(name)
            if match:
                seq = max(seq, int(match.group(1)))
        return seq

    def _capture_dirs(self) -> list[tuple[str, str]]:
        """(name, path) pairs, oldest first: zero-padded sequence ids
        make lexical order capture order."""
        try:
            names = sorted(os.listdir(self.directory))
        except OSError:
            return []
        return [(name, os.path.join(self.directory, name)) for name in names
                if _CAPTURE_DIR_RE.fullmatch(name)
                and os.path.isdir(os.path.join(self.directory, name))]

    def _prune(self) -> None:
        dirs = self._capture_dirs()
        with self._lock:
            active_path = self._active["path"] if self._active else None
        sizes = {path: _dir_bytes(path) for _name, path in dirs}
        total = sum(sizes.values())
        while len(dirs) > 1 and (len(dirs) > self.max_captures
                                 or (self.max_bytes > 0 and total > self.max_bytes)):
            _name, oldest = dirs.pop(0)
            if oldest == active_path:
                continue
            total -= sizes.get(oldest, 0)
            shutil.rmtree(oldest, ignore_errors=True)

    def captures(self) -> list[dict[str, Any]]:
        """Newest-first index of the retained trace directories."""
        return [{"id": name, "bytes": _dir_bytes(path)}
                for name, path in reversed(self._capture_dirs())]

    def status(self) -> dict[str, Any]:
        with self._lock:
            active = dict(self._active) if self._active else None
            counters = dict(self.counters)
        if active is not None:
            active["elapsed_s"] = round(self.clock() - active.pop("started_at"), 6)
        return {"directory": self.directory, "active": active,
                "max_seconds": self.max_seconds, "max_captures": self.max_captures,
                "max_bytes": self.max_bytes, "counters": counters}


def _dir_bytes(path: str) -> int:
    total = 0
    try:
        for root, _dirs, files in os.walk(path):
            for name in files:
                with contextlib.suppress(OSError):
                    total += os.path.getsize(os.path.join(root, name))
    except OSError:
        return total
    return total


_capture: ProfilerCapture | None = None
_capture_lock = threading.Lock()


def get_profiler_capture() -> ProfilerCapture | None:
    """The process-global capture manager, or None when CDT_PROFILE_DIR
    is unset (no directory, no capture plane). Made on first use."""
    global _capture
    with _capture_lock:
        if _capture is not None:
            return _capture
        directory = constants.profile_dir_from_env()
        if not directory:
            return None
        os.makedirs(directory, exist_ok=True)
        _capture = ProfilerCapture(directory)
        return _capture


def set_profiler_capture(capture: ProfilerCapture | None) -> ProfilerCapture | None:
    """Install a specific capture manager (tests, harnesses); returns
    the previous one."""
    global _capture
    with _capture_lock:
        prev = _capture
        _capture = capture
        return prev
