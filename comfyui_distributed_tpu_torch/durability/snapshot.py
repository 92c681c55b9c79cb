"""Snapshot compaction for the control-plane journal (the port's own
copy of comfyui_distributed_tpu/durability/snapshot.py).

A snapshot is the shadow state (``durability/state.py``) serialized as
one atomically-renamed JSON file, ``snapshot-<last_lsn>.json``. It is
written through ``utils.fsio.atomic_write_json`` (tmp + fsync + rename
+ directory fsync), so a crash mid-snapshot leaves the previous
snapshot intact and at worst a stray tmp file.

Compaction policy: after a snapshot at lsn L lands, every CLOSED
journal segment whose records are all ≤ L is superseded and pruned,
and older snapshots are deleted. Recovery therefore reads exactly one
snapshot plus the WAL tail (records with lsn > L).

The snapshot also carries the scheduler's exported aggregates (tenant
DRR deficits, tenant weights, placement speed EWMAs) sampled at write
time — those mutate outside the job-store journal seam, so their
durability granularity is the snapshot cadence, not per-mutation
(documented trade-off: losing sub-cadence EWMA updates re-learns worker
speeds in seconds and cannot affect output correctness).
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Optional

from ..utils.fsio import atomic_write_json, fsync_dir
from ..utils.logging import log
from .state import SNAPSHOT_VERSION, SnapshotVersionMismatch

SNAPSHOT_PREFIX = "snapshot-"
SNAPSHOT_SUFFIX = ".json"
_SNAPSHOT_RE = re.compile(
    re.escape(SNAPSHOT_PREFIX) + r"(\d+)" + re.escape(SNAPSHOT_SUFFIX) + r"$"
)


def snapshot_path(directory: str, last_lsn: int) -> str:
    return os.path.join(
        directory, f"{SNAPSHOT_PREFIX}{last_lsn:012d}{SNAPSHOT_SUFFIX}"
    )


def list_snapshots(directory: str) -> list[tuple[int, str]]:
    """(last_lsn, path) pairs, oldest first. Sorted numerically —
    never readdir order."""
    out: list[tuple[int, str]] = []
    try:
        names = sorted(os.listdir(directory))
    except FileNotFoundError:
        return out
    for name in names:
        match = _SNAPSHOT_RE.match(name)
        if match:
            out.append((int(match.group(1)), os.path.join(directory, name)))
    return sorted(out)


def prune_snapshots(directory: str, keep_path: str, upto_lsn: int) -> None:
    """Delete snapshots superseded by the one at ``keep_path``."""
    for lsn, old_path in list_snapshots(directory):
        if old_path != keep_path and lsn <= upto_lsn:
            try:
                os.remove(old_path)
            except OSError as exc:
                log(f"snapshot: prune of {old_path} failed: {exc}")
    fsync_dir(directory)


def write_snapshot(directory: str, state: dict[str, Any]) -> str:
    """Serialize ``state`` atomically; prunes superseded snapshots.
    Returns the written path."""
    last_lsn = int(state.get("last_lsn", 0))
    path = snapshot_path(directory, last_lsn)
    atomic_write_json(path, state, indent=None, sort_keys=True)
    prune_snapshots(directory, path, last_lsn)
    return path


def load_latest_snapshot(directory: str) -> Optional[dict[str, Any]]:
    """The newest snapshot's state, or None when the directory holds
    none (first boot / journal-only recovery). A version mismatch
    raises ``SnapshotVersionMismatch`` loudly — recovery must never
    guess at an incompatible schema."""
    snapshots = list_snapshots(directory)
    if not snapshots:
        return None
    _lsn, path = snapshots[-1]
    with open(path, "r", encoding="utf-8") as fh:
        state = json.load(fh)
    version = state.get("version")
    if version != SNAPSHOT_VERSION:
        raise SnapshotVersionMismatch(
            f"{path}: snapshot version {version!r} != supported "
            f"{SNAPSHOT_VERSION}; refusing to reinterpret acknowledged state"
        )
    return state
