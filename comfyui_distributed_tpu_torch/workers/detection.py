"""Machine identity and same-host checks.

The port's own copy of comfyui_distributed_tpu/workers/detection.py:
the machine id from the MAC-derived uuid node, docker detection from
/.dockerenv and /proc/1/cgroup, and same-physical-host by comparing
machine ids over the worker's /distributed/system_info.
"""

from __future__ import annotations

import os
import uuid
from typing import Any

from ..utils.network import build_worker_url, is_loopback_host, request_json_async


def get_machine_id() -> str:
    return f"{uuid.getnode():012x}"


def is_docker() -> bool:
    if os.path.exists("/.dockerenv"):
        return True
    try:
        with open("/proc/1/cgroup", encoding="utf-8") as fh:
            content = fh.read()
    except OSError:
        return False
    return "docker" in content or "containerd" in content or "kubepods" in content


def is_local_worker(worker: dict[str, Any]) -> bool:
    """A worker of this host: type local, or a loopback address."""
    return worker.get("type") == "local" or is_loopback_host(str(worker.get("host", "")))


async def is_same_physical_host(worker: dict[str, Any]) -> bool:
    """Whether the worker's machine id is ours (asked over its API)."""
    if is_local_worker(worker):
        return True
    try:
        status, data = await request_json_async(
            "GET", build_worker_url(worker, "/distributed/system_info"), timeout=10)
    except Exception:  # noqa: BLE001 - unreachable: not known to be ours
        return False
    return status == 200 and isinstance(data, dict) and data.get("machine_id") == get_machine_id()
