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

Not ported: the on-demand ``jax.profiler`` capture (``ProfilerCapture``)
and its routes; torch.profiler takes their place in a later step
(ROADMAP.md, Queue 1 step 7). All clocks are injectable and used only
for durations.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Callable

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
