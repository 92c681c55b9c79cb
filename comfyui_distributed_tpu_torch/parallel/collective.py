"""The collector's participant ordering.

The port's own copy of `reorder_participant_first` from
comfyui_distributed_tpu/parallel/collective.py, pure Python. The rest of
that module (`host_collect`, the mesh all-gather) belongs to the
multi-GPU tier, ROADMAP.md Queue 1 item 6.
"""

from __future__ import annotations

from typing import Any


def reorder_participant_first(batches: dict[int, Any], enabled_order: list[int]) -> list[Any]:
    """Deterministic ordering for the elastic (HTTP) tier: the master
    (index 0) first, then enabled workers in configured order, then
    stragglers sorted."""
    ordered: list[Any] = []
    seen: set[int] = set()
    for idx in [0, *enabled_order]:
        if idx in batches and idx not in seen:
            ordered.append(batches[idx])
            seen.add(idx)
    for idx in sorted(batches):
        if idx not in seen:
            ordered.append(batches[idx])
            seen.add(idx)
    return ordered
