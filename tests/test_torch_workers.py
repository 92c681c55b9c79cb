"""Worker processes in the port (workers/): tests/test_workers.py's and
tests/test_worker_drain.py's cases on the port's modules, beside the
JAX package's where the two can run on the same inputs, and two real
launches on the CPU:

- POST /distributed/launch_worker with extra_args "--platform cpu": the
  worker process answers its probe, takes a tiny txt2img prompt over the
  websocket and sends its image to the master's collector; then
  /distributed/stop_worker: its port goes dead, its PID leaves /proc and
  its record leaves managed_processes;
- the master watchdog: a worker CLI whose CDT_MASTER_PID names a
  stand-in process exits once that process is gone.

Every subprocess wait has its own timeout.
"""

import asyncio
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import pytest
import torch

from comfyui_distributed_tpu.workers import detection as jdetection
from comfyui_distributed_tpu.workers import process_manager as jpm
from comfyui_distributed_tpu_torch.api.server import DistributedServer
from comfyui_distributed_tpu_torch.utils import config as tconfig
from comfyui_distributed_tpu_torch.utils.exceptions import ProcessError
from comfyui_distributed_tpu_torch.utils.network import probe_worker, request_json
from comfyui_distributed_tpu_torch.workers import detection as tdetection
from comfyui_distributed_tpu_torch.workers import monitor as tmonitor
from comfyui_distributed_tpu_torch.workers import process_manager as tpm
from comfyui_distributed_tpu_torch.workers import startup as tstartup

from test_torch_collector import PNG_STEP, _free_port, _txt2img_prompt, _wait_done
from test_torch_parity import one_torch_thread, port_loop  # noqa: F401  (fixtures)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH_TIMEOUT = 60
pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture
def config_path(tmp_path, monkeypatch):
    path = str(tmp_path / "config.json")
    monkeypatch.setenv("CDT_CONFIG_PATH", path)
    monkeypatch.setenv("CDT_LOG_DIR", str(tmp_path / "logs"))
    monkeypatch.delenv("CDT_IS_WORKER", raising=False)
    return path


def test_build_launch_command_matches_the_jax_packages_but_the_module():
    worker = {"id": "w1", "port": 8190, "extra_args": "--platform cpu --config 'a b.json'"}
    port_cmd = tpm.WorkerProcessManager().build_launch_command(worker)
    jax_cmd = jpm.WorkerProcessManager().build_launch_command(worker)
    assert port_cmd[1:] == ["-m", "comfyui_distributed_tpu_torch", "--port", "8190", "--worker",
                            "--platform", "cpu", "--config", "a b.json"]
    assert port_cmd[3:] == jax_cmd[3:] and jax_cmd[2] == "comfyui_distributed_tpu"
    assert tpm.WorkerProcessManager().build_launch_command({"id": "w"})[4] == "8189"


@pytest.mark.parametrize("extra", ["--foo; rm -rf /", "$(evil)", "a | b", "x > y", "`id`",
                                   "a\nb", '--a "b c"', ""])
def test_extra_args_sanitized_as_in_the_jax_package(extra):
    try:
        expected = jpm.sanitize_extra_args(extra)
    except Exception as exc:  # noqa: BLE001 - the JAX package's ProcessError
        assert type(exc).__name__ == "ProcessError"
        with pytest.raises(ProcessError):
            tpm.sanitize_extra_args(extra)
    else:
        assert tpm.sanitize_extra_args(extra) == expected


def test_visible_devices_from_cuda_device():
    assert tpm.visible_devices(None) is None and tpm.visible_devices([]) is None
    assert tpm.visible_devices(0) == "0" and tpm.visible_devices([1, 3]) == "1,3"
    assert tpm.visible_devices("2") == "2"


def test_is_process_alive_reads_proc_as_psutil_does():
    assert tpm.is_process_alive(os.getpid()) == jpm.is_process_alive(os.getpid()) is True
    proc = subprocess.Popen([sys.executable, "-c", "pass"])
    deadline = time.monotonic() + 30
    while proc.poll() is None and time.monotonic() < deadline:
        time.sleep(0.01)
    # exited but not reaped: a zombie, dead to both
    assert tpm.is_process_alive(proc.pid) == jpm.is_process_alive(proc.pid) is False
    proc.wait(timeout=10)
    for pid in (999999, 0, -1):
        assert tpm.is_process_alive(pid) is False
    assert jpm.is_process_alive(999999) is False


def test_pid_persistence_and_stale_recovery(config_path):
    manager = tpm.WorkerProcessManager()
    manager._persist("w1", 999999, None)
    assert "w1" in manager.managed_processes()
    assert manager.clear_stale() == ["w1"]
    assert "w1" not in manager.managed_processes()


def test_concurrent_persist_does_not_lose_writers(config_path):
    manager = tpm.WorkerProcessManager()
    barrier = threading.Barrier(8)

    def persist(i):
        barrier.wait()
        manager._persist(f"w{i}", 100000 + i, None)
        manager.clear_launching(f"w{i}")

    threads = [threading.Thread(target=persist, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    managed = manager.managed_processes()
    assert sorted(managed) == [f"w{i}" for i in range(8)]
    assert all("launching" not in e for e in managed.values())


def test_config_transactions_and_locked_writes_exclude_each_other(config_path):
    """An async transaction on a loop and locked_config on threads, all
    at once: no write is lost."""
    async def bump(i):
        async with tconfig.config_transaction() as cfg:
            cfg.setdefault("async", []).append(i)

    def locked(i):
        with tconfig.locked_config() as cfg:
            cfg.setdefault("sync", []).append(i)

    async def body():
        threads = [threading.Thread(target=locked, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        await asyncio.gather(*(bump(i) for i in range(6)))
        for t in threads:
            await asyncio.to_thread(t.join, 30)

    asyncio.run(body())
    cfg = tconfig.load_config()
    assert sorted(cfg["async"]) == list(range(6)) and sorted(cfg["sync"]) == list(range(6))


def test_launch_and_stop_a_process_tree(config_path, monkeypatch):
    """A launched process with a child of its own: the stop takes both."""
    manager = tpm.WorkerProcessManager()
    script = ("import subprocess, sys, time; "
              "c = subprocess.Popen([sys.executable, '-c', 'import time; time.sleep(120)']); "
              "print(c.pid, flush=True); time.sleep(120)")
    monkeypatch.setattr(manager, "build_launch_command",
                        lambda worker: [sys.executable, "-c", script])
    info = manager.launch_worker({"id": "w2", "name": "w2", "port": 0})
    assert tpm.is_process_alive(info["pid"]) and "w2" in manager.managed_processes()
    assert manager.managed_processes()["w2"]["launching"] is True
    with pytest.raises(ProcessError, match="already running"):
        manager.launch_worker({"id": "w2", "name": "w2", "port": 0})
    deadline = time.monotonic() + LAUNCH_TIMEOUT
    child = None
    while child is None and time.monotonic() < deadline:
        kids = tpm.descendants(info["pid"])
        child = kids[0] if kids else None
        time.sleep(0.05)
    assert child is not None and tpm.is_process_alive(child)
    assert manager.stop_worker("w2") is True
    assert not tpm.is_process_alive(info["pid"]) and not tpm.is_process_alive(child)
    assert "w2" not in manager.managed_processes()
    assert manager.stop_worker("w2") is False


def test_clear_launching_marker(config_path):
    manager = tpm.WorkerProcessManager()
    manager._persist("w1", os.getpid(), None)
    assert manager.clear_launching("w1") is True
    entry = manager.managed_processes()["w1"]
    assert "launching" not in entry and entry["pid"] == os.getpid()
    assert manager.clear_launching("w1") is False
    assert manager.clear_launching("missing") is False


def test_auto_populate_once(config_path, monkeypatch):
    """One disabled entry per spare card, the master's card left out, once."""
    monkeypatch.setattr(tstartup, "_device_count", lambda: 8)
    created = tstartup.auto_populate_workers()
    assert [w["cuda_device"] for w in created] == list(range(1, 8))
    assert [w["port"] for w in created] == list(range(8189, 8196))
    assert all(not w["enabled"] and w["type"] == "local" for w in created)
    cfg = tconfig.load_config()
    assert len(cfg["workers"]) == 7 and cfg["settings"]["has_auto_populated_workers"] is True
    assert tstartup.auto_populate_workers() == []
    assert len(tconfig.load_config()["workers"]) == 7


def test_auto_populate_skips_workers_and_a_card_less_host(config_path, monkeypatch):
    monkeypatch.setenv("CDT_IS_WORKER", "1")
    assert tstartup.auto_populate_workers() == []
    monkeypatch.delenv("CDT_IS_WORKER")
    monkeypatch.setattr(tstartup, "_device_count", lambda: 0)
    assert tstartup.auto_populate_workers() == []
    assert tconfig.load_config()["settings"]["has_auto_populated_workers"] is True


def test_detection_helpers_equal_the_jax_packages():
    assert tdetection.get_machine_id() == jdetection.get_machine_id()
    assert len(tdetection.get_machine_id()) == 12
    assert tdetection.is_docker() == jdetection.is_docker()
    for worker in ({"type": "local"}, {"type": "remote", "host": "127.0.0.1"},
                   {"type": "remote", "host": "10.1.2.3"}, {"type": "remote", "host": "localhost"},
                   {"type": "cloud", "host": "[::1]:8189"}):
        assert tdetection.is_local_worker(worker) == jdetection.is_local_worker(worker), worker
    assert asyncio.run(tdetection.is_same_physical_host({"type": "local"})) is True


class _FakeServer:
    def __init__(self):
        self.interrupted = False
        self.stopped = False
        self._executing = threading.Event()
        self.is_worker = True

    def interrupt(self):
        self.interrupted = True

    async def stop(self):
        self.stopped = True


@pytest.mark.parametrize("finishes", [True, False])
def test_drain_worker(finishes):
    async def body():
        server = _FakeServer()
        server._executing.set()
        if finishes:
            async def finish_soon():
                await asyncio.sleep(0.05)
                server._executing.clear()

            asyncio.get_running_loop().create_task(finish_soon())
        drained = await tstartup.drain_worker(server, grace_seconds=5.0 if finishes else 0.2)
        assert drained is finishes
        assert server.interrupted and server.stopped

    asyncio.run(body())


def test_register_worker_drain_installs_handlers_on_workers_only(monkeypatch):
    monkeypatch.delenv("CDT_IS_WORKER", raising=False)

    async def body():
        loop = asyncio.get_running_loop()
        installed = {}
        monkeypatch.setattr(loop, "add_signal_handler", lambda sig, cb: installed.setdefault(
            sig, cb))
        master = _FakeServer()
        master.is_worker = False
        tstartup.register_worker_drain(loop, master)
        assert installed == {}
        server = _FakeServer()
        stopped = []
        tstartup.register_worker_drain(loop, server, grace_seconds=1.0,
                                       on_stopped=lambda: stopped.append(True))
        assert set(installed) == {signal.SIGINT, signal.SIGTERM}
        installed[signal.SIGTERM]()
        for _ in range(100):
            await asyncio.sleep(0.01)
            if stopped:
                break
        assert server.interrupted and server.stopped and stopped

    asyncio.run(body())


def test_monitor_and_run_ends_the_command_when_the_master_dies():
    master = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(120)"])
    result = {}

    def run():
        result["code"] = tmonitor.monitor_and_run(
            [sys.executable, "-c", "import time; time.sleep(120)"], master.pid, poll_seconds=0.05)

    thread = threading.Thread(target=run)
    # signal.signal needs the main thread: the wrapper installs its
    # forwarders only there, so run it with them stubbed
    original = signal.signal
    signal.signal = lambda *a: None
    try:
        thread.start()
        time.sleep(0.3)
        master.kill()
        master.wait(timeout=10)
        thread.join(timeout=30)
    finally:
        signal.signal = original
    assert not thread.is_alive() and result["code"] == 0
    assert tmonitor.main([]) == 2


def _dead(port: int) -> bool:
    with socket.socket() as sock:
        sock.settimeout(1.0)
        return sock.connect_ex(("127.0.0.1", port)) != 0


def test_a_master_launches_a_cpu_worker_process_that_serves_a_prompt(tmp_path, monkeypatch,
                                                                     port_loop):
    """The real thing on the CPU: the master (in this process) launches w1
    through its route, queues a tiny txt2img prompt with w1, and stops w1."""
    monkeypatch.setenv("CDT_LOG_DIR", str(tmp_path / "logs"))
    monkeypatch.delenv("CDT_IS_WORKER", raising=False)
    worker_port = _free_port()
    worker_config = str(tmp_path / "w1.json")
    tconfig.save_config({"settings": {"input_dir": str(tmp_path / "w1_in")}}, worker_config)
    config_path = str(tmp_path / "master.json")
    tconfig.save_config({
        "master": {"host": "127.0.0.1"},
        "workers": [{"id": "w1", "name": "w1", "type": "local", "host": "127.0.0.1",
                     "port": worker_port, "enabled": True,
                     "extra_args": f"--platform cpu --config {worker_config}"}],
        "settings": {"output_dir": str(tmp_path / "out")},
    }, config_path)
    master = DistributedServer(port=_free_port(), is_worker=False, config_path=config_path,
                               device="cpu")
    asyncio.run_coroutine_threadsafe(master.start(), port_loop.loop).result(timeout=30)
    base = f"http://127.0.0.1:{master.port}"
    pid = None
    try:
        started = time.monotonic()
        status, launched = request_json("POST", f"{base}/distributed/launch_worker",
                                        {"worker_id": "w1"}, 30)
        assert status == 200 and launched["status"] == "ok", launched
        pid = launched["pid"]
        assert pid != os.getpid() and tpm.is_process_alive(pid)
        probe = {"online": False}
        while not probe["online"] and time.monotonic() - started < LAUNCH_TIMEOUT:
            assert tpm.is_process_alive(pid), open(launched["log"]).read()
            probe = asyncio.run(probe_worker(f"http://127.0.0.1:{worker_port}", timeout=2))
            time.sleep(0.2)
        assert probe["online"], open(launched["log"]).read()
        status, info = request_json("GET", f"http://127.0.0.1:{worker_port}/distributed/"
                                    "system_info", None, 10)
        assert info["is_worker"] is True and info["device"] == "cpu" and info["pid"] == pid
        status, managed = request_json("GET", f"{base}/distributed/managed", None, 10)
        assert managed["managed"]["w1"]["pid"] == pid
        assert request_json("POST", f"{base}/distributed/worker/clear_launching",
                            {"worker_id": "w1"}, 10) == (200, {"status": "success",
                                                               "cleared": True})

        status, queued = request_json("POST", f"{base}/distributed/queue", {
            "prompt": _txt2img_prompt(), "client_id": "t", "workers": ["w1"]}, 30)
        assert status == 200 and queued["workers"] == ["w1"], queued
        history = _wait_done(f"{base}/history/{queued['prompt_id']}", timeout=120)
        assert history["error"] is None, history["error"]
        images = master.get_job(queued["prompt_id"]).outputs["9"][0]["images"]
        assert tuple(images.shape) == (2, 32, 32, 3)
        status, info = request_json("GET", f"http://127.0.0.1:{worker_port}/distributed/"
                                    "system_info", None, 10)
        assert info["status"]["ws_prompts"] == 1  # over the websocket, not the fallback
        # w1 loaded tiny-unet's registry weights in its own process: its
        # image is the master's pipeline at seed + 1
        from comfyui_distributed_tpu_torch.graph import ExecutionContext, GraphExecutor

        context = ExecutionContext(device="cpu")
        context.pipelines.update(master.execution_context.pipelines)
        executor = GraphExecutor(context)
        executor.execute(_txt2img_prompt(12))
        torch.testing.assert_close(images[1], executor.last_results["8"][0][0],
                                   atol=PNG_STEP + 1e-6, rtol=0)

        status, stopped = request_json("POST", f"{base}/distributed/stop_worker",
                                       {"worker_id": "w1"}, 30)
        assert (status, stopped) == (200, {"status": "ok", "stopped": True})
        assert _dead(worker_port)
        assert not os.path.exists(f"/proc/{pid}")  # stopped and reaped
        assert tpm.descendants(pid) == []
        assert request_json("GET", f"{base}/distributed/managed", None, 10)[1] == {"managed": {}}
        status, lines = request_json("GET", f"{base}/distributed/worker_log/w1?tail=500", None,
                                     10)
        assert status == 200 and any("listening" in line for line in lines["lines"])
    finally:
        if pid is not None and tpm.is_process_alive(pid):
            tpm.WorkerProcessManager._kill_tree(pid)
        asyncio.run_coroutine_threadsafe(master.stop(), port_loop.loop).result(timeout=60)


def test_the_watchdog_ends_a_worker_whose_master_is_gone(tmp_path):
    stand_in = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(120)"])
    port = _free_port()
    env = {**os.environ, "CDT_MASTER_PID": str(stand_in.pid), "CDT_MONITOR_POLL_INTERVAL": "0.2",
           "CDT_CONFIG_PATH": str(tmp_path / "config.json"), "PYTHONPATH": REPO}
    worker = subprocess.Popen(
        [sys.executable, "-m", "comfyui_distributed_tpu_torch", "--port", str(port), "--worker",
         "--platform", "cpu"], cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + LAUNCH_TIMEOUT
        while _dead(port):
            assert worker.poll() is None, worker.stdout.read().decode()
            assert time.monotonic() < deadline, "the worker never listened"
            time.sleep(0.1)
        assert worker.poll() is None
        stand_in.kill()
        stand_in.wait(timeout=10)
        assert worker.wait(timeout=30) == 0
        output = worker.stdout.read().decode()
        assert f"master pid {stand_in.pid} gone" in output
    finally:
        for proc in (worker, stand_in):
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
        worker.stdout.close()
