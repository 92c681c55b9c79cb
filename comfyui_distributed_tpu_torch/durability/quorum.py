"""Quorum lease: master arbitration without a shared filesystem (the
port's own copy of comfyui_distributed_tpu/durability/quorum.py).

The flock-sidecar lease (lease.py) arbitrates through the journal
directory itself, which works exactly as far as the filesystem is
shared and its rename/flock semantics hold. Region mode removes that
dependency: ``QuorumLease`` presents the *same* interface (acquire /
renew / release / held / epoch) but decides ownership by majority
agreement across N independent **lease peers** — single-register
stores that accept or reject ``(holder, epoch, ttl)`` proposals under
a compare-and-swap rule. Epoch fencing, the indeterminate-read
semantics, and the ``FencedOut`` append gate all carry over unchanged:
``DurabilityManager`` only ever calls ``lease.held()`` and reads
``lease.epoch``, so the two backends are drop-in interchangeable.

Protocol (a classical majority-register lease, not full Paxos — the
register per peer is the stable storage, the epoch is the ballot):

- **peer accept rule** (evaluated atomically per peer): a proposal
  ``(epoch, owner)`` is accepted iff the peer's stored epoch is lower,
  OR equal with the same owner (renew/release). Same epoch + different
  owner is rejected — two claimants racing the same epoch can never
  both assemble a majority, because any two majorities intersect.
- **acquire**: read all peers; a majority of *determinate* responses
  is required (fewer raises ``OSError`` — indeterminate, mirroring the
  file lease's strict read). The max-epoch view decides liveness
  (``LeaseHeld`` when a foreign lease is live and ``force`` is off);
  then ``epoch = view.epoch + 1`` is proposed everywhere and the
  acquire succeeds only on a majority of accepts. A partial write
  (proposer or peer crash mid-acquire) burns the epoch but corrupts
  nothing: the next claimant reads the burned epoch from the surviving
  peers and goes higher — epochs stay monotonic.
- **renew**: re-propose our own epoch with a fresh expiry. A lagging
  peer (missed the acquire, or restarted empty) catches up here — its
  stored epoch is lower, so it accepts. A rejection revealing a higher
  epoch is ``LeaseLost``; anything short of a majority with no higher
  epoch seen is ``OSError`` (transient — the renewal loop retries; a
  blip must never read as a takeover).
- **held()**: trusts the local clock for ``ttl/4`` after the last
  verified read, then re-reads the cluster. Fewer than a majority of
  determinate responses keeps the cached verdict WITHOUT advancing the
  trust window (one unreachable peer set cannot depose a healthy
  active); a majority view showing a higher epoch is a takeover —
  fenced. Majority intersection makes this sound: any majority of
  reads overlaps the usurper's write majority in at least one peer.

Peers are duck-typed (``read()`` + ``propose(state)``), which is the
external-KV shim seam: anything that can CAS a small JSON record — an
etcd key, a cloud KV entry, a tiny HTTP register service — can serve.
In-repo peers: ``FileLeasePeer`` (one register directory per peer,
flock-serialized, modelling one node-local disk each) and
``MemoryLeasePeer`` (in-process, with fault hooks for chaos).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, NamedTuple, Optional

from ..utils.constants import LEASE_TTL_SECONDS
from ..utils.fsio import atomic_write_json
from ..utils.logging import debug_log, log
from .lease import LeaseHeld, LeaseLost, LeaseState

PEER_REGISTER_FILENAME = "peer_register.json"
PEER_LOCK_FILENAME = "peer_register.lock"


class LeasePeerError(Exception):
    """One peer neither confirmed nor denied (I/O trouble, crash
    injection): an *indeterminate* response. Counted toward neither
    accepts nor rejects."""


class PeerDecision(NamedTuple):
    accepted: bool
    state: Optional[LeaseState]  # the peer's post-decision register


class MemoryLeasePeer:
    """In-process register peer: the unit-test and chaos-suite medium.

    Fault hooks (all one-shot counters or latches, set by the chaos
    scenarios):

    - ``fail_reads`` / ``fail_writes`` — the next N calls raise
      ``LeasePeerError`` (indeterminate);
    - ``crashed`` — every call raises until cleared (a dead peer);
    - ``crash_next_propose`` — ``"before"`` loses the proposal then
      raises (write never applied), ``"after"`` applies it then raises
      (ack lost): the two halves of a mid-acquire peer crash.
    """

    def __init__(self, name: str = "peer") -> None:
        self.name = name
        self._lock = threading.Lock()
        self._state: Optional[LeaseState] = None
        self.fail_reads = 0
        self.fail_writes = 0
        self.crashed = False
        self.crash_next_propose: Optional[str] = None

    def read(self) -> Optional[LeaseState]:
        with self._lock:
            if self.crashed:
                raise LeasePeerError(f"peer {self.name} is down")
            if self.fail_reads > 0:
                self.fail_reads -= 1
                raise LeasePeerError(f"peer {self.name} read blip")
            return self._state

    def propose(self, state: LeaseState) -> PeerDecision:
        with self._lock:
            if self.crashed:
                raise LeasePeerError(f"peer {self.name} is down")
            if self.fail_writes > 0:
                self.fail_writes -= 1
                raise LeasePeerError(f"peer {self.name} write blip")
            if self.crash_next_propose == "before":
                self.crash_next_propose = None
                raise LeasePeerError(
                    f"peer {self.name} crashed before applying"
                )
            decision = self._decide(state)
            if self.crash_next_propose == "after":
                self.crash_next_propose = None
                raise LeasePeerError(
                    f"peer {self.name} crashed after applying (ack lost)"
                )
            return decision

    def _decide(self, state: LeaseState) -> PeerDecision:
        cur = self._state
        if (
            cur is None
            or state.epoch > cur.epoch
            or (state.epoch == cur.epoch and state.owner == cur.owner)
        ):
            self._state = state
            return PeerDecision(True, state)
        return PeerDecision(False, cur)


class FileLeasePeer:
    """One register directory per peer — each directory models one
    lease-holder node's local disk (no directory is shared between
    peers, so no single filesystem is a correctness dependency). The
    per-peer flock sidecar serializes this peer's read-modify-write;
    cross-peer agreement comes from the quorum, not from locking."""

    def __init__(self, directory: str, name: Optional[str] = None) -> None:
        self.directory = directory
        self.name = name or os.path.basename(os.path.normpath(directory))

    def _path(self) -> str:
        return os.path.join(self.directory, PEER_REGISTER_FILENAME)

    def read(self) -> Optional[LeaseState]:
        import json

        try:
            with open(self._path(), encoding="utf-8") as fh:
                return LeaseState.from_json(json.load(fh))
        except FileNotFoundError:
            return None
        except (ValueError, KeyError, TypeError):
            # corrupt register reads as empty: the epoch CAS still
            # holds cluster-wide because the other peers carry it
            return None
        except OSError as exc:
            raise LeasePeerError(f"peer {self.name}: {exc}") from exc

    def propose(self, state: LeaseState) -> PeerDecision:
        import fcntl

        try:
            os.makedirs(self.directory, exist_ok=True)
            lock_path = os.path.join(self.directory, PEER_LOCK_FILENAME)
            fd = os.open(lock_path, os.O_CREAT | os.O_RDWR, 0o644)
        except OSError as exc:
            raise LeasePeerError(f"peer {self.name}: {exc}") from exc
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            cur = self.read()
            if (
                cur is None
                or state.epoch > cur.epoch
                or (state.epoch == cur.epoch and state.owner == cur.owner)
            ):
                atomic_write_json(self._path(), state.as_json())
                return PeerDecision(True, state)
            return PeerDecision(False, cur)
        except LeasePeerError:
            raise
        except OSError as exc:
            raise LeasePeerError(f"peer {self.name}: {exc}") from exc
        finally:
            try:
                fcntl.flock(fd, fcntl.LOCK_UN)
            except OSError:
                pass
            os.close(fd)


class QuorumLease:
    """Majority-register lease with the file lease's exact interface.

    Not thread-safe by design (same contract as ``Lease``): acquire /
    renew run on one owner thread; ``held()`` only reads."""

    def __init__(
        self,
        peers: list,
        owner: str,
        ttl: Optional[float] = None,
        clock: Callable[[], float] = time.time,
    ) -> None:
        if not peers:
            raise ValueError("QuorumLease needs at least one peer")
        self.peers = list(peers)
        self.owner = owner
        self.ttl = float(ttl) if ttl is not None else LEASE_TTL_SECONDS
        self.clock = clock
        self.quorum = len(self.peers) // 2 + 1
        self._epoch = 0
        self._lost = False
        self._last_verified = 0.0

    # --- state ------------------------------------------------------------

    @property
    def epoch(self) -> int:
        return 0 if self._lost else self._epoch

    def _read_cluster(self) -> tuple[list[Optional[LeaseState]], int]:
        """Every peer's register (None = empty), plus the count of
        indeterminate (errored) peers."""
        states: list[Optional[LeaseState]] = []
        errors = 0
        for peer in self.peers:
            try:
                states.append(peer.read())
            except LeasePeerError as exc:
                debug_log(f"quorum lease read: {exc}")
                errors += 1
        return states, errors

    @staticmethod
    def _view(states: list[Optional[LeaseState]]) -> Optional[LeaseState]:
        """The max-epoch register among determinate responses."""
        best: Optional[LeaseState] = None
        for state in states:
            if state is not None and (best is None or state.epoch > best.epoch):
                best = state
        return best

    def read(self, strict: bool = False) -> Optional[LeaseState]:
        states, errors = self._read_cluster()
        if len(states) < self.quorum:
            if strict:
                raise OSError(
                    f"lease quorum indeterminate: only {len(states)}/"
                    f"{len(self.peers)} peers answered"
                )
            return None
        return self._view(states)

    # --- acquisition ------------------------------------------------------

    def acquire(self, force: bool = False) -> int:
        """Take the lease (majority epoch+1) and return the new epoch.
        Raises ``LeaseHeld`` on a live foreign lease (or a racing
        claimant that out-voted us), ``OSError`` when the cluster is
        too indeterminate to decide either way."""
        states, _ = self._read_cluster()
        if len(states) < self.quorum:
            raise OSError(
                f"lease quorum indeterminate: only {len(states)}/"
                f"{len(self.peers)} peers answered the acquire read"
            )
        now = self.clock()
        view = self._view(states)
        if (
            not force
            and view is not None
            and view.owner != self.owner
            and view.expires_at > now
        ):
            raise LeaseHeld(
                f"lease held by {view.owner!r} (epoch {view.epoch}) for "
                f"another {view.expires_at - now:.1f}s"
            )
        epoch = (view.epoch if view is not None else 0) + 1
        proposal = LeaseState(epoch, self.owner, now + self.ttl, now)
        accepts, best_reject = self._propose_all(proposal)
        if accepts >= self.quorum:
            self._epoch = epoch
            self._lost = False
            self._last_verified = now
            if view is not None and view.owner != self.owner:
                log(
                    f"quorum lease: {self.owner} took over from "
                    f"{view.owner} (epoch {view.epoch} -> {epoch}"
                    f"{', forced' if force and view.expires_at > now else ''})"
                )
            return epoch
        if best_reject is not None and best_reject.epoch >= epoch:
            # a racing claimant assembled the majority for this (or a
            # higher) epoch — we lost the election cleanly
            raise LeaseHeld(
                f"lease race lost to {best_reject.owner!r} "
                f"(epoch {best_reject.epoch})"
            )
        raise OSError(
            f"lease acquire indeterminate: {accepts}/{len(self.peers)} "
            f"accepts (quorum {self.quorum}); epoch {epoch} burned"
        )

    def renew(self) -> None:
        if self._epoch <= 0 or self._lost:
            raise LeaseLost("lease was never acquired (or already lost)")
        now = self.clock()
        proposal = LeaseState(self._epoch, self.owner, now + self.ttl, now)
        accepts, best_reject = self._propose_all(proposal)
        if accepts >= self.quorum:
            self._last_verified = now
            return
        if best_reject is not None and best_reject.epoch > self._epoch:
            self._lost = True
            raise LeaseLost(
                f"lease superseded: quorum carries "
                f"({best_reject.owner!r}, epoch {best_reject.epoch}), "
                f"we held epoch {self._epoch}"
            )
        raise OSError(
            f"lease renew indeterminate: {accepts}/{len(self.peers)} "
            f"accepts (quorum {self.quorum}); will retry"
        )

    def release(self) -> None:
        """Clean shutdown: expire our lease NOW (same epoch) on every
        reachable peer. Best effort — an unreachable minority just sees
        the TTL run out."""
        if self._epoch <= 0 or self._lost:
            return
        now = self.clock()
        self._propose_all(LeaseState(self._epoch, self.owner, now, now))
        self._epoch = 0

    def _propose_all(
        self, proposal: LeaseState
    ) -> tuple[int, Optional[LeaseState]]:
        accepts = 0
        best_reject: Optional[LeaseState] = None
        for peer in self.peers:
            try:
                decision = peer.propose(proposal)
            except LeasePeerError as exc:
                debug_log(f"quorum lease propose: {exc}")
                continue
            if decision.accepted:
                accepts += 1
            elif decision.state is not None and (
                best_reject is None or decision.state.epoch > best_reject.epoch
            ):
                best_reject = decision.state
        return accepts, best_reject

    # --- the fencing check (journal seam) ---------------------------------

    def held(self, verify: bool = False) -> bool:
        if self._lost or self._epoch <= 0:
            return False
        now = self.clock()
        if not verify and now - self._last_verified <= self.ttl / 4:
            return True
        states, _ = self._read_cluster()
        if len(states) < self.quorum:
            # Indeterminate cluster: neither confirms nor denies a
            # takeover — keep the cached verdict WITHOUT advancing the
            # trust window (same contract as the file lease's OSError
            # path; a real takeover is caught on the next majority
            # read, which must intersect the usurper's write set).
            return True
        view = self._view(states)
        if view is not None and view.epoch > self._epoch:
            self._lost = True
            return False
        if any(
            s is not None
            and s.epoch == self._epoch
            and s.owner == self.owner
            for s in states
        ):
            self._last_verified = now
            return True
        # A majority answered but none carries our register and none
        # supersedes it (peers restarted empty): indeterminate — keep
        # the cached verdict, don't advance the window.
        return True

    # --- introspection ----------------------------------------------------

    def status(self) -> dict[str, Any]:
        peers = []
        for peer in self.peers:
            entry: dict[str, Any] = {"name": getattr(peer, "name", "?")}
            try:
                state = peer.read()
                entry["state"] = state.as_json() if state is not None else None
            except LeasePeerError as exc:
                entry["error"] = str(exc)
            peers.append(entry)
        return {
            "backend": "quorum",
            "owner": self.owner,
            "epoch": self.epoch,
            "ttl_seconds": self.ttl,
            "quorum": self.quorum,
            "peers": peers,
        }


def quorum_lease_from_env(
    owner: str, ttl: Optional[float] = None
) -> Optional[QuorumLease]:
    """Build the region-mode lease from CDT_LEASE_PEERS (a comma list
    of peer register directories); None when the knob is unset — the
    caller falls back to the shared-filesystem file lease."""
    from ..utils import constants

    peer_dirs = constants.LEASE_PEERS
    if not peer_dirs:
        return None
    peers = [
        FileLeasePeer(directory, name=f"peer{i}")
        for i, directory in enumerate(peer_dirs)
    ]
    return QuorumLease(peers, owner=owner, ttl=ttl)
