"""The master watchdog: a worker exits when its master is gone.

The port's own copy of comfyui_distributed_tpu/workers/monitor.py, on
/proc instead of psutil. Two ways to use it:

- in the worker: a worker launched by a master carries CDT_MASTER_PID;
  `start_master_watchdog` polls that PID on a daemon thread and ends
  the process when it dies, so an orphaned worker does not keep its
  card's memory;
- as a wrapper process:
  `CDT_MASTER_PID=<pid> python -m comfyui_distributed_tpu_torch.workers.monitor -- <cmd...>`
  runs the command and terminates it when the master dies.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
import time
from typing import Callable, Optional

from ..utils.constants import MASTER_PID_ENV, MONITOR_POLL_INTERVAL_SECONDS
from ..utils.logging import log
from .process_manager import is_process_alive


def start_master_watchdog(on_dead: Optional[Callable[[], None]] = None,
                          poll_seconds: float = MONITOR_POLL_INTERVAL_SECONDS
                          ) -> Optional[threading.Thread]:
    """With CDT_MASTER_PID set, watch that PID and exit the process (after
    `on_dead`) once it is gone; None when the variable is unset."""
    master_pid = os.environ.get(MASTER_PID_ENV)
    if not master_pid:
        return None
    pid = int(master_pid)

    def watch() -> None:
        while True:
            if not is_process_alive(pid):
                log(f"master pid {pid} gone; shutting down worker")
                if on_dead is not None:
                    on_dead()
                os._exit(0)
            time.sleep(poll_seconds)

    thread = threading.Thread(target=watch, name="cdt-master-watchdog", daemon=True)
    thread.start()
    return thread


def monitor_and_run(command: list[str], master_pid: int,
                    poll_seconds: float = MONITOR_POLL_INTERVAL_SECONDS) -> int:
    """Run `command`; terminate it when the master dies. The command's
    exit code, or 0 after the master died."""
    proc = subprocess.Popen(command)

    def forward(signum, _frame):
        try:
            proc.send_signal(signum)
        except ProcessLookupError:
            pass

    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, forward)
    while True:
        ret = proc.poll()
        if ret is not None:
            return ret
        if not is_process_alive(master_pid):
            log(f"master pid {master_pid} gone; terminating worker {proc.pid}")
            proc.terminate()
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10)
            return 0
        time.sleep(poll_seconds)


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    command = argv[argv.index("--") + 1:] if "--" in argv else argv
    master_pid = int(os.environ.get(MASTER_PID_ENV, "0") or 0)
    if not command or not master_pid:
        print("usage: CDT_MASTER_PID=<pid> python -m comfyui_distributed_tpu_torch.workers."
              "monitor -- <command...>", file=sys.stderr)
        return 2
    return monitor_and_run(command, master_pid)


if __name__ == "__main__":
    raise SystemExit(main())
