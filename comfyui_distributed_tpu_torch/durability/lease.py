"""Epoch-numbered master lease: who is allowed to write the journal (the
port's own copy of comfyui_distributed_tpu/durability/lease.py).

The warm-standby failover protocol (docs/durability.md §failover)
needs two things a plain "is the master up?" probe can't give:

- **arbitration** — exactly one process may append to the journal at a
  time, decided by a medium both contenders share (the journal
  directory itself: ``lease.json``, written atomically via
  utils/fsio);
- **fencing** — a deposed master must be *unable* to keep mutating
  acknowledged state, even if its process is still alive and its
  clock is wrong. The lease carries a monotonically increasing
  **epoch**; every takeover bumps it, and the write-ahead seam
  (``DurabilityManager.record``) checks ``Lease.held()`` before every
  append — a holder whose epoch no longer matches the file raises
  ``FencedOut`` instead of journaling (the fencing-token pattern).

Acquisition policy:

- ``acquire()`` — takes a free or *expired* lease (epoch+1); raises
  ``LeaseHeld`` while another owner's lease is live. This is the
  standby's promotion path: it can only take over once the active
  master has missed renewals for a full TTL.
- ``acquire(force=True)`` — takes the lease unconditionally (epoch+1).
  This is the *restarting master's* path: a process that owns the
  journal directory and is booting on it is the newest claimant by
  construction; waiting out the dead incarnation's TTL would just add
  downtime. The deposed holder (if somehow still alive) is fenced by
  the epoch bump on its next ``held()`` re-read.

``held()`` is the hot-path check: it trusts the local clock for
``ttl/4`` after the last successful file verification, then re-reads
the file — so a zombie keeps serving for at most ``ttl/4`` beyond the
takeover before its journal appends start raising, and the steady
state costs one small file read every ``ttl/4`` seconds.

Split-brain analysis lives in docs/durability.md: the lease file is
the arbitration medium, so fencing is exactly as strong as the
filesystem's rename atomicity plus ``flock(2)`` (local fs / NFSv4 both
qualify) — every acquire/renew/release read-modify-write cycle
serializes under a flocked sidecar file (``lease.lock``) so two
claimants racing an expired lease can never both take the same epoch,
and a transient read error (EIO/ESTALE) is classified as
*indeterminate*, never as a takeover — one NFS blip cannot depose a
healthy active. Two
masters pointed at *different* directories are two clusters, not a
split brain — the replication stream carries the active epoch so a
remote standby can at least detect the misconfiguration.
"""

from __future__ import annotations

import contextlib
import dataclasses
import fcntl
import json
import os
import time
from typing import Any, Callable, Iterator, Optional

from ..utils.constants import LEASE_TTL_SECONDS
from ..utils.fsio import atomic_write_json
from ..utils.logging import log

LEASE_FILENAME = "lease.json"
CLAIM_LOCK_FILENAME = "lease.lock"


class LeaseHeld(Exception):
    """Another owner's lease is still live; the caller may not take it."""


class LeaseLost(Exception):
    """We no longer own the lease (a newer epoch exists): the caller
    has been deposed and must stop acting as the active master."""


class FencedOut(Exception):
    """A journal append was attempted after losing the lease. The
    mutation was NOT journaled and must not be acknowledged."""


@dataclasses.dataclass
class LeaseState:
    epoch: int
    owner: str
    expires_at: float
    renewed_at: float

    def as_json(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, data: dict[str, Any]) -> "LeaseState":
        return cls(
            epoch=int(data["epoch"]),
            owner=str(data["owner"]),
            expires_at=float(data["expires_at"]),
            renewed_at=float(data.get("renewed_at", 0.0)),
        )


def lease_path(directory: str) -> str:
    return os.path.join(directory, LEASE_FILENAME)


@contextlib.contextmanager
def _claim_mutex(directory: str, owner: str, ttl: float) -> Iterator[None]:
    """Serialize lease.json read-modify-write cycles across processes.

    ``atomic_write_json`` makes each *write* atomic, but acquire/renew/
    release are read-THEN-write: without mutual exclusion two claimants
    racing an expired lease can both read epoch N and both write N+1 —
    the same-epoch split brain the lease exists to prevent. The mutex
    is ``flock(2)`` on a persistent sidecar file: kernel-arbitrated
    (per open-file-description, so it excludes threads and processes
    alike), and a holder that dies releases the lock with its fd —
    there is no stale-lock breaking, and therefore no break/recreate
    race two contenders could use to both enter the cycle. NFSv4 maps
    flock onto leased byte-range locks; the cycle it guards lasts
    milliseconds, so the 10ms contention poll (bounded by one TTL)
    resolves immediately in practice."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, CLAIM_LOCK_FILENAME)
    fd = os.open(path, os.O_CREAT | os.O_RDWR, 0o644)
    try:
        deadline = time.monotonic() + max(1.0, float(ttl))
        while True:
            try:
                fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                break
            except OSError:
                if time.monotonic() >= deadline:
                    raise LeaseHeld(
                        f"lease claim lock busy for over {ttl:.1f}s: {path}"
                    )
                time.sleep(0.01)
        with contextlib.suppress(OSError):
            os.ftruncate(fd, 0)
            os.write(fd, owner.encode("utf-8", "replace"))
        yield
    finally:
        with contextlib.suppress(OSError):
            fcntl.flock(fd, fcntl.LOCK_UN)
        os.close(fd)


def read_lease(
    directory: str, strict: bool = False
) -> Optional[LeaseState]:
    """Parse the directory's lease file; None when absent or corrupt
    (a corrupt lease reads as free — arbitration falls back to the
    epoch bump, which stays monotonic because a fresh acquire still
    reads whatever epoch digits survive). With ``strict=True`` a
    *transient I/O error* (EIO, ESTALE, ...) raises instead of reading
    as free: holders use this so one NFS blip is never mistaken for a
    takeover — absent and unreadable are different verdicts."""
    try:
        with open(lease_path(directory), encoding="utf-8") as fh:
            return LeaseState.from_json(json.load(fh))
    except (FileNotFoundError, ValueError, KeyError, TypeError):
        return None
    except OSError:
        if strict:
            raise
        return None


class Lease:
    """One contender's handle on the directory's lease file.

    Not thread-safe by design: acquire/renew run on one owner thread
    (the server's renewal task or the standby's promotion path);
    ``held()`` is safe to call from the journal seam because it only
    reads."""

    def __init__(
        self,
        directory: str,
        owner: str,
        ttl: Optional[float] = None,
        clock: Callable[[], float] = time.time,
    ) -> None:
        self.directory = directory
        self.owner = owner
        self.ttl = float(ttl) if ttl is not None else LEASE_TTL_SECONDS
        self.clock = clock
        self._epoch = 0  # epoch we hold; 0 = not holding
        self._lost = False
        self._last_verified = 0.0

    # --- state ------------------------------------------------------------

    @property
    def epoch(self) -> int:
        """The epoch this handle holds (0 when not holding)."""
        return 0 if self._lost else self._epoch

    def read(self, strict: bool = False) -> Optional[LeaseState]:
        return read_lease(self.directory, strict=strict)

    # --- acquisition ------------------------------------------------------

    def acquire(self, force: bool = False) -> int:
        """Take the lease (epoch+1) and return the new epoch. Without
        ``force``, a live lease owned by someone else raises
        ``LeaseHeld`` — the standby promotion gate. With ``force`` the
        newest claimant always wins (restarting-master policy); the
        previous holder is fenced by the epoch bump. The whole
        read-check-write cycle runs under the directory's claim mutex
        so racing claimants serialize: exactly one takes epoch N+1,
        the rest re-read its fresh lease and raise ``LeaseHeld``."""
        with _claim_mutex(self.directory, self.owner, self.ttl):
            now = self.clock()
            current = self.read(strict=True)
            if (
                not force
                and current is not None
                and current.owner != self.owner
                and current.expires_at > now
            ):
                raise LeaseHeld(
                    f"lease held by {current.owner!r} "
                    f"(epoch {current.epoch}) for another "
                    f"{current.expires_at - now:.1f}s"
                )
            epoch = (current.epoch if current is not None else 0) + 1
            self._write(LeaseState(epoch, self.owner, now + self.ttl, now))
            self._epoch = epoch
            self._lost = False
            self._last_verified = now
        if current is not None and current.owner != self.owner:
            log(
                f"lease: {self.owner} took over from {current.owner} "
                f"(epoch {current.epoch} -> {epoch}"
                f"{', forced' if force and current.expires_at > now else ''})"
            )
        return epoch

    def renew(self) -> None:
        """Extend the expiry. Raises ``LeaseLost`` when the file no
        longer carries our (epoch, owner) — someone took over; the
        caller must demote immediately. A *transient* read error
        (strict read) propagates as OSError instead: the renewal loop
        retries on those — one NFS blip must never read as a takeover
        and permanently depose a healthy active."""
        if self._epoch <= 0 or self._lost:
            raise LeaseLost("lease was never acquired (or already lost)")
        with _claim_mutex(self.directory, self.owner, self.ttl):
            current = self.read(strict=True)
            now = self.clock()
            if (
                current is None
                or current.epoch != self._epoch
                or current.owner != self.owner
            ):
                self._lost = True
                raise LeaseLost(
                    f"lease superseded: file carries "
                    f"{(current.owner, current.epoch) if current else None}, "
                    f"we held epoch {self._epoch}"
                )
            self._write(LeaseState(self._epoch, self.owner, now + self.ttl, now))
            self._last_verified = now

    def release(self) -> None:
        """Clean shutdown: expire our lease NOW (same epoch) so a
        standby or restart can take over without waiting out the TTL.
        A no-op if we don't hold it anymore."""
        if self._epoch <= 0 or self._lost:
            return
        with _claim_mutex(self.directory, self.owner, self.ttl):
            current = self.read()
            if (
                current is None
                or current.epoch != self._epoch
                or current.owner != self.owner
            ):
                return
            now = self.clock()
            self._write(LeaseState(self._epoch, self.owner, now, now))
            self._epoch = 0

    # --- the fencing check (journal seam) ---------------------------------

    def held(self, verify: bool = False) -> bool:
        """Do we still own the lease? Trusts the local clock within
        ``ttl/4`` of the last successful file verification; beyond that
        (or with ``verify=True``) re-reads the file and compares epochs
        — the bounded-staleness fencing check ``DurabilityManager``
        runs before every journal append."""
        if self._lost or self._epoch <= 0:
            return False
        now = self.clock()
        if not verify and now - self._last_verified <= self.ttl / 4:
            return True
        try:
            current = self.read(strict=True)
        except OSError:
            # Transient I/O blip: neither confirms nor denies a
            # takeover, so keep the cached verdict WITHOUT advancing
            # the trust window — a real takeover is caught on the next
            # successful re-read, and a genuinely dead disk fails the
            # journal append itself (nothing gets acknowledged).
            return True
        if (
            current is None
            or current.epoch != self._epoch
            or current.owner != self.owner
        ):
            self._lost = True
            return False
        self._last_verified = now
        return True

    # --- internals --------------------------------------------------------

    def _write(self, state: LeaseState) -> None:
        atomic_write_json(lease_path(self.directory), state.as_json())

    def status(self) -> dict[str, Any]:
        current = self.read()
        return {
            "owner": self.owner,
            "epoch": self.epoch,
            "ttl_seconds": self.ttl,
            "file": (current.as_json() if current is not None else None),
        }
