"""Append-only write-ahead journal for the control plane (the port's own
copy of comfyui_distributed_tpu/durability/journal.py: the same frames,
records and files, so either package replays the other's journal).

ARIES discipline, scoped to the job store's state machine: every
mutation is appended (and optionally fsync'd) BEFORE the caller
acknowledges it, so a master killed at any instant can reconstruct
the exact set of acknowledged transitions on restart.

On-disk format — a directory of numbered segment files
(``segment-<n>.wal``), each a sequence of length-prefixed frames::

    [4B payload length, big-endian][4B CRC32 of payload][payload]

where payload is one UTF-8 JSON record carrying its log sequence
number (``lsn``) plus the typed fields the job store emitted
(docs/durability.md lists the record schema). Properties:

- **rotation** — when a segment crosses ``CDT_JOURNAL_SEGMENT_BYTES``
  it is fsync'd, closed, and a new segment is created with a directory
  fsync, so segment boundaries are themselves durable;
- **torn-tail truncation** — a crash mid-append leaves a final frame
  that is short or CRC-broken; replay truncates the LAST segment back
  to its last complete frame (the record was never acknowledged, so
  dropping it is correct). A broken frame anywhere else — mid-segment,
  or in a non-final segment — is real corruption and raises
  ``JournalCorruption`` loudly instead of skipping records;
- **fsync policy** — ``CDT_JOURNAL_FSYNC``: ``1`` (default) syncs
  every append (a power cut loses nothing acknowledged) and ``N>1``
  syncs every N appends — both write SYNCHRONOUSLY on the caller
  before the mutation is acknowledged (strict write-ahead). ``0`` is
  the page-cache **write-behind** mode: frames are serialized and
  sequenced on the caller (so ordering is exact) but written by a
  dedicated journal-writer thread, keeping filesystem latency spikes
  off the serving loop — the <5% overhead mode. Its loss window is
  the writer's in-flight queue: a SIGKILL can drop a SUFFIX of
  acknowledged records, and replay then recovers a consistent earlier
  prefix whose missing tiles recompute bit-identically (recovery
  correctness never depends on journal completeness, only on prefix
  consistency — docs/durability.md).
"""

from __future__ import annotations

import os
import struct
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Any, Iterator, Optional

import json

from ..telemetry import instruments
from ..utils.constants import _env_int
from ..utils.fsio import fsync_dir
from ..utils.logging import log

_HEADER = struct.Struct(">II")  # payload length, CRC32(payload)
SEGMENT_PREFIX = "segment-"
SEGMENT_SUFFIX = ".wal"
DEFAULT_SEGMENT_BYTES = 4 * 1024 * 1024


class JournalCorruption(Exception):
    """A CRC-broken or structurally impossible record that is NOT the
    journal's torn tail: state has been damaged after it was
    acknowledged, and recovery must stop rather than silently skip."""


def segment_path(directory: str, index: int) -> str:
    return os.path.join(directory, f"{SEGMENT_PREFIX}{index:08d}{SEGMENT_SUFFIX}")


def list_segments(directory: str) -> list[tuple[int, str]]:
    """(index, path) pairs in index order. Sorted numerically — replay
    order must never depend on readdir order."""
    out: list[tuple[int, str]] = []
    try:
        names = sorted(os.listdir(directory))
    except FileNotFoundError:
        return out
    for name in names:
        if not (name.startswith(SEGMENT_PREFIX) and name.endswith(SEGMENT_SUFFIX)):
            continue
        stem = name[len(SEGMENT_PREFIX) : -len(SEGMENT_SUFFIX)]
        try:
            out.append((int(stem), os.path.join(directory, name)))
        except ValueError:
            continue
    return sorted(out)


@dataclass
class ReplayResult:
    """What ``replay_journal`` saw on disk."""

    records: list[dict] = field(default_factory=list)
    last_lsn: int = 0
    segments: int = 0
    truncated_bytes: int = 0  # torn tail dropped from the final segment


def _iter_frames(path: str) -> Iterator[tuple[int, bool, bytes]]:
    """Yield (frame_offset, crc_ok, payload) for every structurally
    complete frame; a final short frame is signalled by a terminal
    (offset, False, b"") sentinel (payload empty = short, not CRC)."""
    with open(path, "rb") as fh:
        data = fh.read()
    offset = 0
    total = len(data)
    while offset < total:
        if offset + _HEADER.size > total:
            yield offset, False, b""
            return
        length, crc = _HEADER.unpack_from(data, offset)
        start = offset + _HEADER.size
        end = start + length
        if end > total:
            yield offset, False, b""
            return
        payload = data[start:end]
        yield offset, zlib.crc32(payload) == crc, payload
        offset = end


def replay_journal(
    directory: str, after_lsn: int = 0, truncate_torn_tail: bool = True
) -> ReplayResult:
    """Read every record with lsn > ``after_lsn`` across all segments.

    The final segment's torn tail (short or CRC-broken LAST frame) is
    truncated away when ``truncate_torn_tail`` — that frame was never
    acknowledged. Any other broken frame raises ``JournalCorruption``.
    Pure function of the directory contents otherwise: replaying twice
    yields identical results (test-enforced).
    """
    result = ReplayResult()
    segments = list_segments(directory)
    result.segments = len(segments)
    for seg_pos, (_idx, path) in enumerate(segments):
        is_last_segment = seg_pos == len(segments) - 1
        frames = list(_iter_frames(path))
        for frame_pos, (offset, ok, payload) in enumerate(frames):
            is_last_frame = frame_pos == len(frames) - 1
            if not ok:
                if is_last_segment and is_last_frame:
                    if truncate_torn_tail:
                        size = os.path.getsize(path)
                        with open(path, "r+b") as fh:
                            fh.truncate(offset)
                            fh.flush()
                            os.fsync(fh.fileno())
                        result.truncated_bytes = size - offset
                        log(
                            f"journal: truncated torn tail of {path} "
                            f"({result.truncated_bytes} bytes)"
                        )
                    else:
                        result.truncated_bytes = os.path.getsize(path) - offset
                    break
                raise JournalCorruption(
                    f"{path}: broken record at byte {offset} is not the "
                    "journal tail; refusing to skip acknowledged state"
                )
            try:
                record = json.loads(payload.decode("utf-8"))
            except (UnicodeDecodeError, json.JSONDecodeError) as exc:
                raise JournalCorruption(
                    f"{path}: CRC-valid frame at byte {offset} is not "
                    f"JSON: {exc}"
                ) from exc
            lsn = int(record.get("lsn", 0))
            if lsn <= 0:
                raise JournalCorruption(
                    f"{path}: record at byte {offset} carries no lsn"
                )
            if lsn <= result.last_lsn and lsn > after_lsn:
                raise JournalCorruption(
                    f"{path}: lsn {lsn} at byte {offset} is not "
                    f"monotonic (last {result.last_lsn})"
                )
            result.last_lsn = max(result.last_lsn, lsn)
            if lsn > after_lsn:
                result.records.append(record)
    return result


class Journal:
    """The append side. Thread-safe: appends may arrive from any loop
    or thread (the job store's asyncio methods and test fallbacks).

    Two write modes by fsync policy:

    - ``fsync_every >= 1`` — strict write-ahead: frame, write, flush
      (and fsync per policy) happen synchronously on the caller before
      ``append`` returns;
    - ``fsync_every == 0`` — write-behind group commit: the frame is
      serialized and sequenced on the caller (ordering is exact) and
      handed to a dedicated writer thread, so a filesystem latency
      spike never stalls the serving loop mid-pipeline. A writer-side
      failure is surfaced on the NEXT append/close — the journal never
      silently drops acknowledged state.
    """

    _CLOSE = object()

    def __init__(
        self,
        directory: str,
        next_lsn: int = 1,
        segment_bytes: Optional[int] = None,
        fsync_every: Optional[int] = None,
    ) -> None:
        self.directory = directory
        self.segment_bytes = (
            segment_bytes
            if segment_bytes is not None
            else _env_int("CDT_JOURNAL_SEGMENT_BYTES", DEFAULT_SEGMENT_BYTES)
        )
        self.fsync_every = (
            fsync_every if fsync_every is not None else _env_int("CDT_JOURNAL_FSYNC", 1)
        )
        # Reentrant: the sync write path appends (and may rotate) while
        # holding the lock; the writer thread takes it briefly for the
        # shared rotation bookkeeping.
        self._lock = threading.RLock()
        self._next_lsn = max(1, int(next_lsn))
        self._fh = None
        self._segment_index = 0
        self._appends_since_sync = 0
        # (path, last_lsn) of segments closed by rotation, for pruning.
        self._closed: list[tuple[str, int]] = []
        self._writer: Optional[threading.Thread] = None
        self._queue = None
        # Sticky: once a write-behind frame fails, the journal is dead
        # — later frames are DISCARDED (suffix loss, the documented
        # contract) and every subsequent append raises. Writing past a
        # failed frame would punch an undetectable mid-stream hole in
        # acknowledged state instead.
        self._writer_error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)
        existing = list_segments(directory)
        self._segment_index = (existing[-1][0] + 1) if existing else 1
        # Segments already on disk are never appended to again (their
        # tails may have been truncated by replay); note them as closed
        # with "everything before next_lsn" so pruning can retire them.
        for _idx, path in existing:
            self._closed.append((path, self._next_lsn - 1))
        self._open_segment()
        if self.fsync_every == 0:
            import queue as _queue

            self._queue = _queue.SimpleQueue()
            self._writer = threading.Thread(
                target=self._writer_body, name="cdt-journal-writer", daemon=True
            )
            self._writer.start()

    # --- segment lifecycle ------------------------------------------------

    @property
    def _syncing(self) -> bool:
        """False in the page-cache mode (CDT_JOURNAL_FSYNC=0): fsync
        only buys power-cut durability there, and on slow filesystems
        costs tens of ms per call — the documented overhead trade."""
        return self.fsync_every > 0

    def _open_segment(self) -> None:
        path = segment_path(self.directory, self._segment_index)
        self._fh = open(path, "ab")
        if self._syncing:
            fsync_dir(self.directory)

    def _rotate(self, last_lsn: int) -> None:
        """Close the current segment and open the next. Called by
        whichever thread owns the file (caller in sync mode, the writer
        thread in write-behind mode)."""
        fh = self._fh
        path = segment_path(self.directory, self._segment_index)
        fh.flush()
        if self._syncing:
            os.fsync(fh.fileno())
        fh.close()
        with self._lock:
            self._closed.append((path, last_lsn))
            self._segment_index += 1
        self._open_segment()

    # --- appends ----------------------------------------------------------

    def append(self, record: dict) -> int:
        """Frame one record and make it durable per the fsync policy;
        returns its assigned lsn. The record dict is not mutated.
        Thread-safe: lsn assignment and the write/enqueue happen under
        one lock, so concurrent appenders can never land frames out of
        lsn order (replay treats non-monotonic lsns as corruption)."""
        with self._lock:
            if self._writer_error is not None:
                raise self._writer_error  # sticky: the journal is dead
            lsn = self._next_lsn
            payload = json.dumps(
                {"lsn": lsn, **record}, separators=(",", ":"), sort_keys=True
            ).encode("utf-8")
            self._next_lsn += 1
            frame = _HEADER.pack(len(payload), zlib.crc32(payload)) + payload
            if self._queue is not None:
                self._queue.put((frame, lsn))
            else:
                self._write_frame(frame, lsn)
        instruments.journal_appends_total().inc(
            record=str(record.get("type", "unknown"))
        )
        return lsn

    def _write_frame(self, frame: bytes, lsn: int) -> None:
        fh = self._fh
        fh.write(frame)
        fh.flush()
        if self._syncing:
            self._appends_since_sync += 1
            if self._appends_since_sync >= self.fsync_every:
                started = time.monotonic()
                os.fsync(fh.fileno())
                instruments.journal_fsync_seconds().observe(
                    time.monotonic() - started
                )
                self._appends_since_sync = 0
        if fh.tell() >= self.segment_bytes:
            self._rotate(lsn)

    def _writer_body(self) -> None:
        """Write-behind drain loop: frames arrive in lsn order and are
        written in lsn order, so a SIGKILL mid-queue loses only a
        SUFFIX — replay still reconstructs a consistent prefix. The
        same prefix rule governs failures: after the FIRST failed
        frame, every later frame is discarded (never written past the
        hole) and the sticky error fails all subsequent appends."""
        failed = False
        while True:
            item = self._queue.get()
            if item is self._CLOSE:
                return
            if isinstance(item, threading.Event):  # sync barrier
                try:
                    if not failed:
                        self._fh.flush()
                        os.fsync(self._fh.fileno())
                except OSError as exc:
                    failed = True
                    with self._lock:
                        if self._writer_error is None:
                            self._writer_error = exc
                finally:
                    item.set()
                continue
            frame, lsn = item
            if failed:
                continue  # discard: suffix loss, never a mid-stream hole
            try:
                self._write_frame(frame, lsn)
            except Exception as exc:  # noqa: BLE001 - surfaced on next append
                failed = True
                with self._lock:
                    if self._writer_error is None:
                        self._writer_error = exc
                log(
                    f"journal: write-behind append of lsn {lsn} failed; "
                    f"journal halted, later frames discarded: {exc}"
                )

    # --- maintenance ------------------------------------------------------

    @property
    def next_lsn(self) -> int:
        with self._lock:
            return self._next_lsn

    def prune(self, upto_lsn: int) -> list[str]:
        """Delete closed segments whose every record is covered by a
        snapshot at ``upto_lsn``; returns the removed paths."""
        removed: list[str] = []
        with self._lock:
            keep: list[tuple[str, int]] = []
            for path, last_lsn in self._closed:
                if last_lsn <= upto_lsn:
                    try:
                        os.remove(path)
                        removed.append(path)
                    except OSError as exc:
                        log(f"journal: prune of {path} failed: {exc}")
                        keep.append((path, last_lsn))
                else:
                    keep.append((path, last_lsn))
            self._closed = keep
        if removed:
            fsync_dir(self.directory)
        return removed

    def sync(self) -> None:
        """Block until everything appended so far is fsync'd (barrier
        through the writer thread in write-behind mode)."""
        if self._queue is not None:
            barrier = threading.Event()
            self._queue.put(barrier)
            barrier.wait(timeout=60)
            return
        self._fh.flush()
        os.fsync(self._fh.fileno())
        self._appends_since_sync = 0

    def close(self) -> None:
        if self._writer is not None:
            self._queue.put(self._CLOSE)
            self._writer.join(timeout=60)
            self._writer = None
        with self._lock:
            error, self._writer_error = self._writer_error, None
            if self._fh is not None:
                self._fh.flush()
                if self._syncing:
                    os.fsync(self._fh.fileno())
                self._fh.close()
                self._fh = None
        if error is not None:
            raise error

    def status(self) -> dict[str, Any]:
        with self._lock:
            return {
                "directory": self.directory,
                "next_lsn": self._next_lsn,
                "segment_index": self._segment_index,
                "segment_bytes": self.segment_bytes,
                "fsync_every": self.fsync_every,
                "write_behind": self._queue is not None,
                "closed_segments": len(self._closed),
            }
