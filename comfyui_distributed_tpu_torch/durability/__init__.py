"""Durable control plane (L2, zero-dependency): the port's own copy of
comfyui_distributed_tpu/durability/, which imports nothing of torch.

Write-ahead journal + snapshot + crash recovery under the JobStore and
the scheduler, removing the master as the one component whose crash
loses work — and, with the high-availability layer, whose crash causes
downtime at all. See docs/durability.md for the record schema, the
rotation/compaction policy, the recovery sequence, and the failover
protocol (lease, epoch fencing, replication lag).

    journal.py   — append-only CRC32 WAL, segment rotation, torn-tail
                   truncation on replay
    state.py     — the journaled state machine (one apply_record
                   shared by snapshot shadow, recovery replay, and the
                   standby replica)
    snapshot.py  — atomic snapshot write + segment/snapshot pruning
    recovery.py  — snapshot + WAL tail → live JobStore/scheduler
    manager.py   — DurabilityManager: the JobStore's journal_sink,
                   replication tee, and promotion adopter
    lease.py     — epoch-numbered master lease + FencedOut fencing
    quorum.py    — quorum lease backend (region mode: no shared fs)
    replicate.py — replication subscriptions + the standby replica
"""

from .journal import Journal, JournalCorruption, replay_journal
from .lease import FencedOut, Lease, LeaseHeld, LeaseLost, read_lease
from .manager import DurabilityManager, journal_dir_from_env
from .quorum import (
    FileLeasePeer,
    LeasePeerError,
    MemoryLeasePeer,
    QuorumLease,
    quorum_lease_from_env,
)
from .recovery import RecoveryReport, recover, recover_state
from .replicate import ReplicationSubscription, StandbyReplica
from .state import SnapshotVersionMismatch

__all__ = [
    "DurabilityManager",
    "FencedOut",
    "FileLeasePeer",
    "Journal",
    "JournalCorruption",
    "Lease",
    "LeaseHeld",
    "LeaseLost",
    "LeasePeerError",
    "MemoryLeasePeer",
    "QuorumLease",
    "RecoveryReport",
    "ReplicationSubscription",
    "SnapshotVersionMismatch",
    "StandbyReplica",
    "journal_dir_from_env",
    "quorum_lease_from_env",
    "read_lease",
    "recover",
    "recover_state",
    "replay_journal",
]
