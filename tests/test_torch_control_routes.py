"""The port's config, job and worker routes against the JAX package's,
served by aiohttp on the CPU: the same requests get the same status and
the same body fields.

- config: settings patches (types and ranges), worker add/update/409/
  400s, the master patch, the bulk POST, DELETE of a worker, GET;
- jobs: cancel (the refund accounting, idempotence, 404), queue_status,
  clear_memory, load_image, upload_image (a name that escapes the input
  directory lands inside it);
- workers: clear_launching and managed;
- the queue request's `extra` and the config transactions (the shared
  lock, saves only on change), as the JAX package parses and keeps them;
- load balance end to end through /distributed/queue on a tiny-unet
  master and w1: one worker takes the whole prompt, the master queues
  none, and w1's image reaches the master's store. A worker whose master
  announced no collector job (load balance) ends its prompt as the JAX
  worker does: its envelopes wait the init grace, the master makes the
  job, and the prompt completes.
"""

import asyncio
import os
import types

import numpy as np
import pytest
import torch
from aiohttp import web

from comfyui_distributed_tpu.api import config_routes as jconfig_routes
from comfyui_distributed_tpu.api import job_routes as jjob_routes
from comfyui_distributed_tpu.api import worker_routes as jworker_routes
from comfyui_distributed_tpu.jobs.store import JobStore as JaxJobStore
from comfyui_distributed_tpu.resilience import health as jhealth
from comfyui_distributed_tpu.utils import config as jconfig
from comfyui_distributed_tpu_torch.api import job_routes as tjob_routes
from comfyui_distributed_tpu_torch.api.httpd import encode_multipart
from comfyui_distributed_tpu_torch.api.server import DistributedServer
from comfyui_distributed_tpu_torch.resilience import health as thealth
from comfyui_distributed_tpu_torch.utils import config as tconfig
from comfyui_distributed_tpu_torch.utils.network import request_bytes, request_json
from comfyui_distributed_tpu_torch.workers import process_manager as tpm

from test_torch_collector import (  # noqa: F401  (the bundle fixture)
    PNG_STEP,
    _config,
    _free_port,
    _local,
    _start,
    _stop,
    _txt2img_prompt,
    _wait_done,
    bundle,
)
from test_torch_parity import one_torch_thread, port_loop  # noqa: F401  (fixtures)

TIMEOUT = 30
pytestmark = pytest.mark.usefixtures("one_torch_thread")


class _JaxServer:
    """What the JAX route classes read of their server."""

    def __init__(self, config_path: str):
        self.config_path = config_path
        self.job_store = JaxJobStore()
        self.queue_remaining = 0
        self.execution_context = types.SimpleNamespace(pipelines={"tiny-unet": object()})

    @property
    def config(self):
        return jconfig.load_config(self.config_path)


@pytest.fixture
def apps(tmp_path, port_loop, monkeypatch):
    """(the port server, its URL, the JAX fake server, its URL), each on
    its own config; the input directory is CDT_INPUT_DIR for both."""
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    monkeypatch.setenv("CDT_INPUT_DIR", str(in_dir))
    monkeypatch.setenv("CDT_LOG_DIR", str(tmp_path / "logs"))
    monkeypatch.setattr(jhealth, "_registry", None)
    monkeypatch.setattr(thealth, "_registry", None)
    port_server = DistributedServer(port=0, is_worker=False,
                                    config_path=str(tmp_path / "port.json"), device="cpu")
    jax_server = _JaxServer(str(tmp_path / "jax.json"))
    app = web.Application()
    for module in (jconfig_routes, jjob_routes, jworker_routes):
        module.register(app, jax_server)
    runner = web.AppRunner(app)

    async def boot():
        await port_server.start()
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        return site._server.sockets[0].getsockname()[1]

    jax_port = asyncio.run_coroutine_threadsafe(boot(), port_loop.loop).result(timeout=TIMEOUT)
    yield (port_server, f"http://127.0.0.1:{port_server.http.port}", jax_server,
           f"http://127.0.0.1:{jax_port}", in_dir)

    async def teardown():
        await runner.cleanup()
        await port_server.stop()

    asyncio.run_coroutine_threadsafe(teardown(), port_loop.loop).result(timeout=60)


def _both(apps, method, path, body=None):
    _, port_base, _, jax_base, _ = apps
    return (request_json(method, port_base + path, body, 10),
            request_json(method, jax_base + path, body, 10))


CONFIG_REQUESTS = [
    ("POST", "/distributed/config/setting", {"name": "debug", "value": True}),
    ("POST", "/distributed/config/setting", {"name": "probe_concurrency", "value": True}),
    ("POST", "/distributed/config/setting", {"name": "probe_concurrency", "value": 100}),
    ("POST", "/distributed/config/setting", {"name": "probe_concurrency", "value": 16}),
    ("POST", "/distributed/config/setting", {"name": "nope", "value": 1}),
    ("POST", "/distributed/config/setting", {"name": "worker_timeout_seconds", "value": 2.5}),
    ("POST", "/distributed/config/setting", {"name": "worker_timeout_seconds", "value": -1}),
    ("POST", "/distributed/config/setting", {"name": "master_delegate_only", "value": 1}),
    ("POST", "/distributed/config/worker", {"id": "w1", "name": "w1", "type": "local",
                                            "host": "127.0.0.1", "port": 8190,
                                            "enabled": True, "extra_args": "--x"}),
    ("POST", "/distributed/config/worker", {"id": "w2", "host": "127.0.0.1", "port": 8190}),
    ("POST", "/distributed/config/worker", {"id": "w1", "port": "x"}),
    ("POST", "/distributed/config/worker", {"id": "w1", "bogus": 1}),
    ("POST", "/distributed/config/worker", {"name": "anonymous"}),
    ("POST", "/distributed/config/worker", {"id": "w1", "enabled": False}),
    ("POST", "/distributed/config/worker", {"id": "w3", "host": "10.0.0.3", "port": 8191}),
    ("POST", "/distributed/config/master", {"host": "10.0.0.5", "ignored": 1}),
    ("POST", "/distributed/config", {"custom": {"a": 1}}),
    ("POST", "/distributed/config", [1, 2]),
    ("DELETE", "/distributed/config/worker/w3", None),
    ("DELETE", "/distributed/config/worker/w3", None),
]


def test_config_routes_answer_as_the_jax_routes(apps):
    for method, path, body in CONFIG_REQUESTS:
        port_answer, jax_answer = _both(apps, method, path, body)
        assert port_answer == jax_answer, (method, path, body)
    (status, port_config), (_, jax_config) = _both(apps, "GET", "/distributed/config")
    assert status == 200
    for key in ("debug", "probe_concurrency", "worker_timeout_seconds", "master_delegate_only",
                "auto_launch_workers", "stop_workers_on_master_exit",
                "websocket_orchestration", "media_sync_concurrency"):
        assert port_config["settings"][key] == jax_config["settings"][key], key
    assert port_config["master"]["host"] == jax_config["master"]["host"] == "10.0.0.5"
    assert port_config["custom"] == jax_config["custom"] == {"a": 1}
    fields = ("id", "name", "type", "host", "port", "enabled", "extra_args")
    assert [{k: w.get(k) for k in fields} for w in port_config["workers"]] == \
        [{k: w.get(k) for k in fields} for w in jax_config["workers"]]
    assert [w["id"] for w in port_config["workers"]] == ["w1"]
    # the port's card key, where the JAX package has tpu_chips
    assert port_config["workers"][0]["cuda_device"] is None
    status, _ = request_json("POST", apps[1] + "/distributed/config/worker",
                             {"id": "w1", "cuda_device": [0, 1]}, 10)
    assert status == 200 and tconfig.load_config(apps[0].config_path)["workers"][0][
        "cuda_device"] == [0, 1]


def test_cancel_and_queue_status_answer_as_the_jax_routes(apps):
    port_server, _, jax_server, _, _ = apps
    for path in ("/distributed/cancel/missing", "/distributed/queue_status/missing"):
        port_answer, jax_answer = _both(apps, "POST" if "cancel" in path else "GET", path)
        assert port_answer == jax_answer, path

    async def held(store):
        await store.init_tile_job("job", list(range(6)))
        await store.pull_task("job", "w1")
        await store.pull_task("job", "w1")
        await store.pull_task("job", "w2")
        await store.submit_result("job", "w2", 2, {"ok": True})

    for store in (port_server.job_store, jax_server.job_store):
        asyncio.run_coroutine_threadsafe(held(store), port_server.loop).result(timeout=TIMEOUT)
    port_status, jax_status = _both(apps, "GET", "/distributed/queue_status/job")
    assert port_status == jax_status
    assert port_status[1]["tile_job"] == {"total": 6, "completed": 1, "pending": 3,
                                          "in_flight": 2}
    for attempt in range(2):
        (pstatus, panswer), (jstatus, janswer) = _both(apps, "POST", "/distributed/cancel/job",
                                                       {"reason": "test"})
        assert pstatus == jstatus == 200
        assert panswer.pop("cancel_latency_ms") >= 0.0 and "cancel_latency_ms" in janswer
        janswer.pop("cancel_latency_ms")
        assert panswer == janswer
        if attempt == 0:
            assert (panswer["pending_refunded"], panswer["in_flight_refunded"],
                    panswer["workers"]) == (3, 2, ["w1"])
        else:
            assert panswer["already_cancelled"] is True


def test_media_and_memory_routes_answer_as_the_jax_routes(apps):
    port_server, port_base, jax_server, jax_base, in_dir = apps
    (in_dir / "pic.png").write_bytes(b"\x89PNG pixels")
    for query in ("pic.png", "../port.json", "none.png"):
        port_answer = request_bytes("GET", f"{port_base}/distributed/load_image?filename={query}",
                                    None, None, 10)
        jax_answer = request_bytes("GET", f"{jax_base}/distributed/load_image?filename={query}",
                                   None, None, 10)
        assert port_answer[0] == jax_answer[0], query
        if port_answer[0] == 200:
            assert port_answer[1] == jax_answer[1] == b"\x89PNG pixels"
    body, content_type = encode_multipart([("image", "../../up.png", b"one"),
                                           ("other", "skip.png", b"no"),
                                           ("file", "sub/two.png", b"two")])
    answers = []
    for base in (port_base, jax_base):
        status, raw = request_bytes("POST", f"{base}/upload/image", body,
                                    {"Content-Type": content_type}, 10)
        answers.append((status, raw))
    assert answers[0] == answers[1]
    assert sorted(os.listdir(in_dir)) == ["pic.png", "two.png", "up.png"]
    port_server.execution_context.pipelines["tiny-unet"] = object()
    port_server.execution_context.extras["node_cache"] = {"k": 1}
    assert _both(apps, "POST", "/distributed/clear_memory") == ((200, {"status": "ok"}),) * 2
    assert port_server.execution_context.pipelines == {}
    assert "node_cache" not in port_server.execution_context.extras
    assert jax_server.execution_context.pipelines == {}


def test_worker_records_answer_as_the_jax_routes(apps):
    from comfyui_distributed_tpu.workers import get_worker_manager as jax_manager
    from comfyui_distributed_tpu_torch.workers import get_worker_manager as port_manager

    port_server, _, jax_server, _, _ = apps
    entry = {"id": "w1", "name": "w1", "type": "local", "host": "127.0.0.1", "port": 8190}
    for base in (apps[1], apps[3]):
        assert request_json("POST", base + "/distributed/config/worker", entry, 10)[0] == 200
    pid = os.getpid()
    port_manager()._persist("w1", pid, port_server.config_path)
    jax_manager()._persist("w1", pid, jax_server.config_path)
    for body in ({}, {"worker_id": "ghost"}, {"worker_id": "w1"}, {"worker_id": "w1"}):
        port_answer, jax_answer = _both(apps, "POST", "/distributed/worker/clear_launching", body)
        assert port_answer == jax_answer, body
    (pstatus, pmanaged), (jstatus, jmanaged) = _both(apps, "GET", "/distributed/managed")
    assert pstatus == jstatus == 200
    assert {w: e["pid"] for w, e in pmanaged["managed"].items()} == \
        {w: e["pid"] for w, e in jmanaged["managed"].items()} == {"w1": pid}
    assert "launching" not in pmanaged["managed"]["w1"]
    assert _both(apps, "POST", "/distributed/launch_worker", {"worker_id": "ghost"}) == \
        ((404, {"error": "no such worker"}),) * 2
    assert _both(apps, "POST", "/distributed/launch_worker", {}) == \
        ((400, {"error": "worker_id required"}),) * 2
    # a live PID on record refuses a second launch in both
    port_answer, jax_answer = _both(apps, "POST", "/distributed/launch_worker",
                                    {"worker_id": "w1"})
    assert port_answer[0] == jax_answer[0] == 500
    assert "already running" in port_answer[1]["error"] and "already running" in \
        jax_answer[1]["error"]
    tpm.get_worker_manager()._unpersist("w1", port_server.config_path)
    jax_manager()._unpersist("w1", jax_server.config_path)


def test_system_info_names_the_machine_the_device_and_the_counters(apps):
    status, info = request_json("GET", apps[1] + "/distributed/system_info", None, 10)
    assert status == 200
    assert info["path_separator"] == os.sep and len(info["machine_id"]) == 12
    assert info["device"] == "cpu" and info["cuda_devices"] == [] and info["is_worker"] is False
    assert info["status"]["ws_prompts"] == 0 and info["pid"] == os.getpid()
    status, logs = request_json("GET", apps[1] + "/distributed/master_log?tail=5", None, 10)
    assert status == 200 and len(logs["lines"]) <= 5
    status, net = request_json("GET", apps[1] + "/distributed/network_info", None, 10)
    assert status == 200 and net["recommended"]


@pytest.fixture
def lb_cluster(tmp_path, port_loop, bundle):
    config_path, ports = _config(tmp_path)
    master = DistributedServer(port=_free_port(), is_worker=False, config_path=config_path,
                               device="cpu")
    worker = DistributedServer(port=ports["w1"], is_worker=True, config_path=config_path,
                               device="cpu")
    for server in (master, worker):
        server.execution_context.pipelines["tiny-unet"] = bundle
    _start(port_loop, (master, worker))
    yield master, worker
    _stop(port_loop, (master, worker))


def test_load_balance_places_the_whole_prompt_on_one_worker(lb_cluster, bundle):
    master, worker = lb_cluster
    base = f"http://127.0.0.1:{master.port}"
    prompt = _txt2img_prompt()
    prompt["8"]["inputs"]["load_balance"] = True  # the widget: accepted, no effect
    status, queued = request_json("POST", f"{base}/distributed/queue", {
        "prompt": prompt, "client_id": "t", "workers": ["w1"], "load_balance": True},
        timeout=30)
    assert status == 200
    assert {k: queued[k] for k in ("status", "mode", "worker")} == {
        "status": "dispatched", "mode": "load_balance", "worker": "w1"}
    history = _wait_done(f"http://127.0.0.1:{worker.port}/history/{queued['trace_id']}_lb",
                         timeout=90)
    assert history["error"] is None, history["error"]
    assert master.queue_remaining == 0 and master._history == {}
    assert worker.ws_prompts == 1
    # the worker ran at worker_index 0 (seed + 1) and sent its image to the
    # master's store, where no collector drains it (as in the JAX package)
    (job_id, job), = master.job_store.collectors.items()
    assert job.received == {"w1": 1} and job.finished_workers == {"w1"}
    item = job.queue.get_nowait()
    torch.testing.assert_close(torch.from_numpy(np.asarray(item["tensor"])),
                               _local(bundle, 12)[0], atol=PNG_STEP + 1e-7, rtol=0)


def test_an_unannounced_collector_job_ends_the_worker_prompt_as_in_jax(port_loop, monkeypatch):
    """Both packages' worker collectors post to a master that announced no
    job (the load-balance placement): after the init grace the master
    makes the job and answers ok, so the worker's prompt completes."""
    from comfyui_distributed_tpu.graph.nodes_distributed import (
        DistributedCollector as JaxCollector,
    )
    from comfyui_distributed_tpu_torch.graph.nodes_distributed import DistributedCollector

    monkeypatch.setattr(jjob_routes, "JOB_INIT_GRACE_SECONDS", 0.5)
    monkeypatch.setattr(tjob_routes, "JOB_INIT_GRACE_SECONDS", 0.5)
    port_master = DistributedServer(port=0, is_worker=False, config_path=os.devnull,
                                    device="cpu")
    jax_master = _JaxServer(os.devnull)
    app = web.Application()
    jjob_routes.register(app, jax_master)
    runner = web.AppRunner(app)

    async def boot():
        await port_master.start()
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        return site._server.sockets[0].getsockname()[1]

    jax_port = asyncio.run_coroutine_threadsafe(boot(), port_loop.loop).result(timeout=TIMEOUT)
    images = np.random.default_rng(5).random((2, 8, 8, 3), dtype=np.float32)
    try:
        DistributedCollector().run(torch.from_numpy(images), is_worker=True, worker_id="w1",
                                   master_url=f"http://127.0.0.1:{port_master.http.port}",
                                   job_id="lb_job")
        # the JAX worker side runs its sends under asyncio.run on this thread
        JaxCollector()._send_to_master(images, None, "w1", f"http://127.0.0.1:{jax_port}",
                                       "lb_job")
        for store in (port_master.job_store, jax_master.job_store):
            job = store.collectors["lb_job"]
            assert job.received == {"w1": 2} and job.finished_workers == {"w1"}
            assert job.queue.qsize() == 2
    finally:
        async def teardown():
            await runner.cleanup()
            await port_master.stop()

        asyncio.run_coroutine_threadsafe(teardown(), port_loop.loop).result(timeout=60)


def test_the_media_routes_read_the_servers_input_dir_where_the_jax_routes_ignore_it(
        tmp_path, port_loop, monkeypatch):
    """A deliberate divergence (ROADMAP Queue 3): the JAX check_file and
    upload_image resolve the input directory without the server's config
    (CDT_INPUT_DIR, else CDT_DATA_DIR/input), so an upload lands where
    that worker's LoadImage, reading settings.input_dir, never looks. The
    port's routes use the server's own directory, where its LoadImage
    reads."""
    monkeypatch.delenv("CDT_INPUT_DIR", raising=False)
    monkeypatch.setenv("CDT_DATA_DIR", str(tmp_path / "data"))
    configured = tmp_path / "configured_in"
    port_config = str(tmp_path / "port.json")
    tconfig.save_config({"settings": {"input_dir": str(configured)}}, port_config)
    jax_config = str(tmp_path / "jax.json")
    jconfig.save_config({**jconfig.load_config(jax_config),
                         "settings": {"input_dir": str(configured)}}, jax_config)
    port_server = DistributedServer(port=0, is_worker=True, config_path=port_config,
                                    device="cpu")
    jax_server = _JaxServer(jax_config)
    app = web.Application()
    jjob_routes.register(app, jax_server)
    runner = web.AppRunner(app)

    async def boot():
        await port_server.start()
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        return site._server.sockets[0].getsockname()[1]

    jax_port = asyncio.run_coroutine_threadsafe(boot(), port_loop.loop).result(timeout=TIMEOUT)
    try:
        for name, base in (("port.png", f"http://127.0.0.1:{port_server.http.port}"),
                           ("jax.png", f"http://127.0.0.1:{jax_port}")):
            body, content_type = encode_multipart([("image", name, name.encode())])
            assert request_bytes("POST", f"{base}/upload/image", body,
                                 {"Content-Type": content_type}, 10)[0] == 200
        assert sorted(os.listdir(configured)) == ["port.png"]
        assert sorted(os.listdir(tmp_path / "data" / "input")) == ["jax.png"]
    finally:
        async def teardown():
            await runner.cleanup()
            await port_server.stop()

        asyncio.run_coroutine_threadsafe(teardown(), port_loop.loop).result(timeout=60)


@pytest.mark.parametrize("body", [
    {"prompt": {"1": {}}, "client_id": "c"},
    {"prompt": {"1": {}}, "client_id": "c", "load_balance": True, "foo": 1},
    {"prompt": {"1": {}}, "client_id": "c", "tenant": "acme", "lane": "batch",
     "estimated_tiles": 16},
    {"workflow": {"prompt": {"1": {}}}, "client_id": "c", "worker_ids": ["w1", 2],
     "deadline_s": 30, "trace_id": "t1", "extra_data": {"k": 1}},
])
def test_queue_request_extra_equals_the_jax_packages(body):
    """tests/api/test_queue_request.py's bodies: the same `extra`, workers,
    prompt and deadline from both packages' parsers."""
    from comfyui_distributed_tpu.api.queue_request import (
        parse_queue_request_payload as jax_parse,
    )
    from comfyui_distributed_tpu_torch.api.queue_request import parse_queue_request_payload

    port, jax_ = parse_queue_request_payload(body), jax_parse(body)
    assert port.extra == jax_.extra
    assert (port.prompt, port.worker_ids, port.client_id, port.deadline_s) == (
        jax_.prompt, jax_.worker_ids, jax_.client_id, jax_.deadline_s)


@pytest.mark.parametrize("module", [jconfig, tconfig], ids=["jax", "torch"])
def test_config_transactions_persist_only_on_change_and_share_the_lock(tmp_path, module):
    """tests/test_config.py's transaction cases on both packages: a
    transaction saves only what changed, and locked_config (a thread) and
    config_transaction (a coroutine) exclude each other."""
    import concurrent.futures
    import threading

    path = str(tmp_path / "config.json")

    async def mutate():
        async with module.config_transaction(path) as config:
            config["settings"]["debug"] = True
        mtime = os.path.getmtime(path)
        async with module.config_transaction(path):
            pass
        assert os.path.getmtime(path) == mtime

    asyncio.run(mutate())
    entered, release, order = threading.Event(), threading.Event(), []

    def sync_side():
        with module.locked_config(path) as config:
            entered.set()
            release.wait(timeout=5)
            config["settings"]["debug"] = True
            order.append("sync")

    async def async_side():
        async with module.config_transaction(path) as config:
            order.append("async")
            config["settings"]["debug"] = False

    thread = threading.Thread(target=sync_side)
    thread.start()
    assert entered.wait(timeout=5)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        future = pool.submit(asyncio.run, async_side())
        release.set()
        future.result(timeout=10)
    thread.join(timeout=5)
    assert order == ["sync", "async"]
    assert module.load_config(path)["settings"]["debug"] is False
