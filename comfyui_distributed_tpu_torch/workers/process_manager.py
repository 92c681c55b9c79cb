"""Worker process lifecycle: launch, stop, PID records.

The port's own copy of comfyui_distributed_tpu/workers/process_manager.py.
A local worker is `python -m comfyui_distributed_tpu_torch --port N
--worker` plus its sanitised `extra_args` (`--platform cpu` puts it on
the CPU; without it the worker runs on the card). Its environment marks
the role (CDT_IS_WORKER), names the master's PID (CDT_MASTER_PID, read
by the worker's watchdog) and pins the card from the entry's
`cuda_device` (CUDA_VISIBLE_DEVICES). Output goes to a per-worker log
file; the PID goes into the config's `managed_processes` under the
config's one mutex, so a launch cannot lose a concurrent settings save.

The worker starts a session of its own (`start_new_session=True`), so
its process group is its tree: a stop sends SIGTERM to the group and to
every descendant found in /proc (one that left the group too), waits,
then SIGKILLs what is left. Liveness reads /proc (a zombie is dead). No
psutil: the card's machine has none.
"""

from __future__ import annotations

import datetime
import os
import shlex
import signal
import subprocess
import sys
import threading
import time
from typing import Any, Optional

from ..utils import config as config_mod
from ..utils.constants import CUDA_VISIBLE_DEVICES_ENV, MASTER_PID_ENV, WORKER_ENV_FLAG
from ..utils.exceptions import ProcessError
from ..utils.logging import debug_log, log

FORBIDDEN_ARG_CHARS = set(";&|`$<>\n\r")
STOP_GRACE_SECONDS = 5.0
# the directory that holds the package: a launched worker imports it from here
_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def logs_dir() -> str:
    return os.environ.get("CDT_LOG_DIR", os.path.join(os.getcwd(), "logs", "workers"))


def worker_log_path(name: str) -> str:
    date = datetime.date.today().isoformat()
    safe = "".join(c for c in name if c.isalnum() or c in "-_") or "worker"
    return os.path.join(logs_dir(), f"{safe}_{date}.log")


def get_python_executable() -> str:
    return sys.executable or "python3"


def _proc_stat(pid: int) -> Optional[list[str]]:
    """The fields of /proc/<pid>/stat after the command name (state
    first, then ppid, pgrp, ...); None if there is no such process."""
    try:
        with open(f"/proc/{pid}/stat", encoding="utf-8", errors="replace") as fh:
            raw = fh.read()
    except OSError:
        return None
    return raw.rsplit(")", 1)[-1].split()


def is_process_alive(pid: int) -> bool:
    """A running process (not a zombie) with this PID."""
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        pass  # it exists, under another user
    except OverflowError:
        return False
    stat = _proc_stat(pid)
    if stat is None:
        return not os.path.isdir("/proc")  # no /proc: the signal answered
    return stat[0] != "Z"


def descendants(pid: int) -> list[int]:
    """Every descendant of `pid`, from the parent links in /proc."""
    children: dict[int, list[int]] = {}
    try:
        entries = os.listdir("/proc")
    except OSError:
        return []
    for entry in entries:
        if not entry.isdigit():
            continue
        stat = _proc_stat(int(entry))
        if stat is not None and len(stat) > 1:
            children.setdefault(int(stat[1]), []).append(int(entry))
    found, stack = [], [pid]
    while stack:
        for child in children.get(stack.pop(), []):
            found.append(child)
            stack.append(child)
    return found


def sanitize_extra_args(extra: str) -> list[str]:
    """Split a worker's extra CLI arguments, refusing shell metacharacters."""
    if not extra:
        return []
    if any(c in FORBIDDEN_ARG_CHARS for c in extra):
        raise ProcessError(f"forbidden characters in extra_args: {extra!r}")
    return shlex.split(extra)


def visible_devices(cuda_device: Any) -> Optional[str]:
    """CUDA_VISIBLE_DEVICES for an entry's cuda_device (an index, a list
    of them, or a string); None when the entry names none."""
    if cuda_device is None or cuda_device == "" or cuda_device == []:
        return None
    if isinstance(cuda_device, (list, tuple)):
        return ",".join(str(int(d)) for d in cuda_device)
    return str(cuda_device)


class WorkerProcessManager:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._procs: dict[str, subprocess.Popen] = {}

    # --- launch -----------------------------------------------------------

    def build_launch_command(self, worker: dict[str, Any]) -> list[str]:
        cmd = [get_python_executable(), "-m", "comfyui_distributed_tpu_torch",
               "--port", str(worker.get("port") or 8189), "--worker"]
        return cmd + sanitize_extra_args(str(worker.get("extra_args", "") or ""))

    def launch_worker(self, worker: dict[str, Any], config_path: str | None = None
                      ) -> dict[str, Any]:
        worker_id = str(worker.get("id") or worker.get("name") or "worker")
        with self._lock:
            existing = self.managed_processes(config_path).get(worker_id)
            if existing and is_process_alive(int(existing.get("pid", -1))):
                raise ProcessError(f"worker {worker_id} already running (pid {existing['pid']})")
            env = dict(os.environ)
            env[WORKER_ENV_FLAG] = "1"
            env[MASTER_PID_ENV] = str(os.getpid())
            env["PYTHONPATH"] = os.pathsep.join(
                [_PACKAGE_ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
            devices = visible_devices(worker.get("cuda_device"))
            if devices is not None:
                env[CUDA_VISIBLE_DEVICES_ENV] = devices
            cmd = self.build_launch_command(worker)
            os.makedirs(logs_dir(), exist_ok=True)
            log_path = worker_log_path(str(worker.get("name") or worker_id))
            log(f"launching worker {worker_id}: {' '.join(cmd)} (log: {log_path})")
            with open(log_path, "ab") as log_file:
                proc = subprocess.Popen(cmd, stdout=log_file, stderr=subprocess.STDOUT, env=env,
                                        stdin=subprocess.DEVNULL, start_new_session=True)
            self._procs[worker_id] = proc
            self._persist(worker_id, proc.pid, config_path)
            return {"worker_id": worker_id, "pid": proc.pid, "log": log_path}

    # --- stop -------------------------------------------------------------

    def stop_worker(self, worker_id: str, config_path: str | None = None) -> bool:
        entry = self.managed_processes(config_path).get(worker_id)
        with self._lock:
            proc = self._procs.pop(worker_id, None)
        stopped = False
        if entry is not None and entry.get("pid") is not None:
            stopped = self._kill_tree(int(entry["pid"]), proc)
        self._unpersist(worker_id, config_path)
        return stopped

    def stop_all(self, config_path: str | None = None) -> int:
        return sum(1 for worker_id in list(self.managed_processes(config_path))
                   if self.stop_worker(worker_id, config_path))

    @staticmethod
    def _kill_tree(pid: int, proc: Optional[subprocess.Popen] = None,
                   grace: float = STOP_GRACE_SECONDS) -> bool:
        """SIGTERM the process's group and its descendants, wait up to
        `grace`, SIGKILL the rest. Reaps the process when it is our child.
        False when it was not running."""
        if not is_process_alive(pid):
            if proc is not None:
                proc.poll()
            return False
        tree = [pid] + descendants(pid)
        for sig in (signal.SIGTERM, signal.SIGKILL):
            try:
                os.killpg(pid, sig)  # the session the launch started
            except (ProcessLookupError, PermissionError):
                pass
            for member in tree:
                try:
                    os.kill(member, sig)
                except (ProcessLookupError, PermissionError):
                    pass
            deadline = time.monotonic() + grace
            while time.monotonic() < deadline:
                if proc is not None:
                    proc.poll()
                if not any(is_process_alive(p) for p in tree):
                    break
                time.sleep(0.05)
            else:
                debug_log(f"process tree of pid {pid} outlived {sig.name}")
                continue
            break
        if proc is not None:
            try:
                proc.wait(timeout=grace)
            except subprocess.TimeoutExpired:
                log(f"worker pid {pid} not reaped {grace} s after SIGKILL")
        debug_log(f"stopped the process tree of pid {pid}: {tree}")
        return True

    # --- PID records -----------------------------------------------------------

    def managed_processes(self, config_path: str | None = None) -> dict[str, Any]:
        return dict(config_mod.load_config(config_path).get("managed_processes", {}))

    def _persist(self, worker_id: str, pid: int, config_path: str | None) -> None:
        with config_mod.locked_config(config_path) as config:
            config.setdefault("managed_processes", {})[worker_id] = {
                "pid": pid,
                "started_at": time.time(),
                # cleared by clear_launching once the worker answers
                "launching": True,
            }

    def clear_launching(self, worker_id: str, config_path: str | None = None) -> bool:
        """Drop the 'launching' marker of a worker confirmed up; whether
        there was one."""
        with config_mod.locked_config(config_path) as config:
            entry = config.get("managed_processes", {}).get(worker_id)
            if entry is None or "launching" not in entry:
                return False
            del entry["launching"]
            return True

    def _unpersist(self, worker_id: str, config_path: str | None) -> None:
        with config_mod.locked_config(config_path) as config:
            config.get("managed_processes", {}).pop(worker_id, None)

    def clear_stale(self, config_path: str | None = None) -> list[str]:
        """Drop the records whose PIDs are dead (a master restarted)."""
        stale = []
        with config_mod.locked_config(config_path) as config:
            managed = config.get("managed_processes", {})
            for worker_id, entry in list(managed.items()):
                if not is_process_alive(int(entry.get("pid", -1))):
                    stale.append(worker_id)
                    del managed[worker_id]
        return stale


_manager: Optional[WorkerProcessManager] = None
_manager_lock = threading.Lock()


def get_worker_manager() -> WorkerProcessManager:
    global _manager
    with _manager_lock:
        if _manager is None:
            _manager = WorkerProcessManager()
        return _manager
