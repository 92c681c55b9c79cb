"""The port's HTTP server end to end on localhost, on the CPU: two
DistributedServers (master and worker w1) queue a tiny-unet upscale of a
64-px PNG through /distributed/queue; the small HTTP server underneath
(api/httpd.py); and the CLI in a subprocess. Every network wait has its
own timeout.
"""

import asyncio
import json
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from comfyui_distributed_tpu_torch.api.httpd import HTTPServer, Router, json_response
from comfyui_distributed_tpu_torch.api.server import DistributedServer
from comfyui_distributed_tpu_torch.models import pipeline as tpl
from comfyui_distributed_tpu_torch.utils import config as config_mod
from comfyui_distributed_tpu_torch.utils import image as timg
from comfyui_distributed_tpu_torch.utils.exceptions import DistributedError
from comfyui_distributed_tpu_torch.utils.network import probe_worker, request_json

from test_torch_parity import one_torch_thread, port_loop  # noqa: F401  (fixtures)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
pytestmark = pytest.mark.usefixtures("one_torch_thread")



def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _wait_done(url, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        status, history = request_json("GET", url, timeout=10)
        if status == 200 and history.get("done"):
            return history
        time.sleep(0.1)
    raise AssertionError(f"{url} not done within {timeout} s")



@pytest.fixture
def cluster(tmp_path, port_loop):
    """A master and worker w1 on one loop, sharing a config whose input
    directory holds a seeded 64-px input.png."""
    (tmp_path / "in").mkdir()
    pixels = np.random.default_rng(0).random((64, 64, 3), dtype=np.float32)
    (tmp_path / "in" / "input.png").write_bytes(timg.encode_png(pixels))
    master_port, worker_port = _free_port(), _free_port()
    config_path = str(tmp_path / "config.json")
    config_mod.save_config({
        "master": {"host": "127.0.0.1"},
        "workers": [{"id": "w1", "name": "w1", "type": "remote", "host": "127.0.0.1",
                     "port": worker_port, "enabled": True}],
        "settings": {"input_dir": str(tmp_path / "in"), "output_dir": str(tmp_path / "out")},
    }, config_path)
    master = DistributedServer(port=master_port, is_worker=False, config_path=config_path,
                               device="cpu")
    worker = DistributedServer(port=worker_port, is_worker=True, config_path=config_path,
                               device="cpu")
    bundle = tpl.load_pipeline("tiny-unet", seed=0, device="cpu")
    for server in (master, worker):
        server.execution_context.pipelines["tiny-unet"] = bundle

    async def boot():
        await master.start()
        await worker.start()

    asyncio.run_coroutine_threadsafe(boot(), port_loop.loop).result(timeout=30)
    yield master, worker, tmp_path

    async def teardown():
        await master.stop()
        await worker.stop()

    asyncio.run_coroutine_threadsafe(teardown(), port_loop.loop).result(timeout=60)


def _upscale_prompt():
    with open(os.path.join(REPO, "workflows", "distributed-upscale.json"), encoding="utf-8") as fh:
        prompt = json.load(fh)
    prompt["1"]["inputs"]["ckpt_name"] = "tiny-unet"
    prompt["5"]["inputs"].update(steps=1, tile_width=64, tile_height=64, tile_padding=16)
    return prompt


def test_upscale_over_http_completes_every_tile_once(cluster):
    master, worker, tmp_path = cluster
    base = f"http://127.0.0.1:{master.port}"
    assert request_json("GET", f"{base}/prompt", timeout=10) == (
        200, {"exec_info": {"queue_remaining": 0}})
    status, info = request_json("GET", f"http://127.0.0.1:{worker.port}/distributed/system_info",
                                timeout=10)
    assert status == 200 and info["is_worker"] is True and info["device"] == "cpu"
    status, queued = request_json("POST", f"{base}/distributed/queue", {
        "prompt": _upscale_prompt(), "client_id": "test", "workers": ["w1"],
    }, timeout=30)
    assert status == 200, queued
    assert queued["status"] == "queued" and queued["workers"] == ["w1"]
    history = _wait_done(f"{base}/history/{queued['prompt_id']}")
    worker_history = _wait_done(
        f"http://127.0.0.1:{worker.port}/history/{queued['trace_id']}_w0")
    assert history["error"] is None and worker_history["error"] is None
    assert history["outputs"]["6"]["images"] == ["upscaled_00000.png"]
    record = master.job_store.finished[queued["job_ids"]["5"]]
    assert sorted(t for t, _ in record["completions"]) == [0, 1, 2, 3]
    assert record["duplicates"] == 0
    assert record["finished_workers"] == ["w1"]  # the worker's final flush arrived
    by_w1 = sum(1 for _, who in record["completions"] if who == "w1")
    assert record["received_bytes"] > 0 if by_w1 else record["received_bytes"] == 0
    out = master.get_job(queued["prompt_id"]).outputs["6"][0]["images"]
    assert out.shape == (1, 128, 128, 3) and bool(torch.isfinite(out).all())
    with open(tmp_path / "out" / "upscaled_00000.png", "rb") as fh:
        assert timg.decode_png_u8(fh.read()).shape == (128, 128, 3)
    status, info = request_json("GET", f"{base}/distributed/system_info", timeout=10)
    assert info["status"]["tile_jobs"] == 0 and info["status"]["in_flight_tiles"] == 0


def test_routes_answer_bad_requests_and_unknown_jobs(cluster):
    master, _, _ = cluster
    base = f"http://127.0.0.1:{master.port}"
    assert request_json("GET", f"{base}/history/none", timeout=10)[0] == 404
    assert request_json("POST", f"{base}/prompt", {"no": "prompt"}, timeout=10)[0] == 400
    status, body = request_json("POST", f"{base}/prompt", {
        "prompt": {"1": {"class_type": "NoSuchNode", "inputs": {}}}}, timeout=10)
    assert status == 400 and "1" in body["node_errors"]
    assert request_json("POST", f"{base}/distributed/queue", {"prompt": {}}, timeout=10)[0] == 400
    assert request_json("POST", f"{base}/distributed/heartbeat", {"job_id": "j"}, timeout=10)[0] \
        == 400
    assert request_json("POST", f"{base}/distributed/heartbeat",
                        {"job_id": "j", "worker_id": "w"}, timeout=10) == (
        200, {"status": "unknown_job"})
    assert request_json("POST", f"{base}/distributed/job_status", {"job_id": "j"}, timeout=10) \
        == (200, {"ready": False})
    assert request_json("POST", f"{base}/distributed/return_tiles",
                        {"job_id": "j", "worker_id": "w", "tile_idxs": "x"}, timeout=10)[0] == 400
    assert request_json("GET", f"{base}/distributed/queue", timeout=10)[0] == 405
    assert request_json("POST", f"{base}/interrupt", {}, timeout=10) == (
        200, {"interrupted": True})


def test_probe_reads_queue_depth_and_reports_a_dead_port(cluster):
    master, _, _ = cluster

    async def both():
        return (await probe_worker(f"http://127.0.0.1:{master.port}"),
                await probe_worker(f"http://127.0.0.1:{_free_port()}", timeout=2.0))

    alive, dead = asyncio.run(both())
    assert alive == {"online": True, "queue_remaining": 0}
    assert dead == {"online": False, "queue_remaining": None}


def test_httpd_path_parameters_413_500_and_clean_shutdown():
    router = Router()

    async def echo(request):
        return json_response({"id": request.match_info["item_id"], "body": request.json()})

    async def boom(request):
        raise RuntimeError("broken handler")

    async def slow(request):
        await asyncio.sleep(60)

    router.add_post("/items/{item_id}", echo)
    router.add_get("/boom", boom)
    router.add_get("/slow", slow)
    server = HTTPServer(router, max_body=1024)

    async def run():
        await server.start("127.0.0.1", 0)
        base = f"http://127.0.0.1:{server.port}"
        echoed = await asyncio.to_thread(request_json, "POST", f"{base}/items/a%20b", {"k": 1}, 10)
        broken = await asyncio.to_thread(request_json, "GET", f"{base}/boom", None, 10)
        reader, writer = await asyncio.open_connection("127.0.0.1", server.port)
        writer.write(b"POST /items/x HTTP/1.1\r\nContent-Length: 4096\r\n\r\n")
        await writer.drain()
        too_large = await asyncio.wait_for(reader.read(), 10)
        writer.close()
        pending = asyncio.ensure_future(asyncio.to_thread(request_json, "GET", f"{base}/slow",
                                                          None, 10))
        await asyncio.sleep(0.2)
        started = time.monotonic()
        await asyncio.wait_for(server.stop(), 10)
        stopped_in = time.monotonic() - started
        with pytest.raises(OSError):
            await pending
        return echoed, broken, too_large, stopped_in

    echoed, broken, too_large, stopped_in = asyncio.run(run())
    assert echoed == (200, {"id": "a b", "body": {"k": 1}})
    assert broken[0] == 500 and "broken handler" in broken[1]["error"]
    assert too_large.startswith(b"HTTP/1.1 413 ")
    assert stopped_in < 5.0


def test_run_async_in_server_loop_refuses_its_own_thread(port_loop):
    from comfyui_distributed_tpu_torch.utils.async_helpers import run_async_in_server_loop

    async def inner():
        return 1

    async def on_the_loop():
        with pytest.raises(DistributedError, match="deadlock"):
            run_async_in_server_loop(inner())
        return "refused"

    assert asyncio.run_coroutine_threadsafe(on_the_loop(), port_loop.loop).result(10) == "refused"
    assert run_async_in_server_loop(inner(), timeout=10) == 1


def test_cli_starts_answers_and_exits_on_sigterm(tmp_path):
    port = _free_port()
    env = {**os.environ, "CDT_CONFIG_PATH": str(tmp_path / "config.json"), "PYTHONPATH": REPO}
    proc = subprocess.Popen(
        [sys.executable, "-m", "comfyui_distributed_tpu_torch", "--port", str(port),
         "--platform", "cpu"],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
    )
    try:
        deadline = time.monotonic() + 20
        answer = None
        while time.monotonic() < deadline and answer is None:
            try:
                answer = request_json("GET", f"http://127.0.0.1:{port}/prompt", timeout=2)
            except OSError:
                assert proc.poll() is None, proc.stdout.read().decode()
                time.sleep(0.1)
        assert answer == (200, {"exec_info": {"queue_remaining": 0}})
        started = time.monotonic()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=10) == 0
        assert time.monotonic() - started < 10
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stdout.close()


def test_a_flush_between_the_collector_and_the_job_cleanup_is_taken(cluster, port_loop):
    """The master removes a job's announced collector, then the job
    (`usdu_elastic._finish_job`): a flush that lands in between, when
    `finished` holds the collector's record under the job's id, is
    served by the live job, not dropped against the collector's record
    (which has no duplicate count: the route answered 500)."""
    master, _, _ = cluster
    store = master.job_store

    async def between_the_cleanups():
        await store.ensure_collector("racing")
        await store.init_tile_job("racing", [0, 1])
        assert await store.pull_tasks("racing", "w1", timeout=1.0) == [0]
        await store.cleanup_collector("racing")

    asyncio.run_coroutine_threadsafe(between_the_cleanups(), port_loop.loop).result(10)
    assert "racing" in store.finished and "racing" in store.tile_jobs
    base = f"http://127.0.0.1:{master.port}/distributed"
    tile = {"tile_idx": 0, "batch_idx": 0, "image": timg.encode_image_data_url(
        np.zeros((4, 4, 3), np.float32))}
    assert request_json("POST", f"{base}/submit_tiles", {
        "job_id": "racing", "worker_id": "w1", "tiles": [tile], "is_final_flush": True,
    }, timeout=10) == (200, {"status": "ok", "accepted": 1})
    assert request_json("POST", f"{base}/request_image",
                        {"job_id": "racing", "worker_id": "w1"}, timeout=10)[1]["tile_idx"] == 1
    asyncio.run_coroutine_threadsafe(store.cleanup_tile_job("racing"), port_loop.loop).result(10)
    assert store.finished["racing"]["completions"] == [(0, "w1")]
    assert store.finished["racing"]["finished_workers"] == ["w1"]


def test_a_late_worker_finds_a_finished_job_drained_at_once(cluster, port_loop, monkeypatch):
    """A worker that arrives after the master cleaned the job up pulls
    nothing and its final flush is accepted as duplicates, both without
    waiting out the creation grace; an unknown job still answers 404
    once the grace (shortened here) has passed."""
    from comfyui_distributed_tpu_torch.api import usdu_routes

    monkeypatch.setattr(usdu_routes, "JOB_INIT_GRACE_SECONDS", 3.0)
    master, _, _ = cluster
    store = master.job_store

    async def finished_job():
        await store.init_tile_job("done", [0])
        tid = await store.pull_task("done", "master", timeout=1.0)
        await store.submit_result("done", "master", tid, None)
        await store.cleanup_tile_job("done")

    asyncio.run_coroutine_threadsafe(finished_job(), port_loop.loop).result(10)
    base = f"http://127.0.0.1:{master.port}/distributed"
    started = time.monotonic()
    assert request_json("POST", f"{base}/request_image",
                        {"job_id": "done", "worker_id": "w1"}, timeout=10) == (
        200, {"tile_idx": None, "estimated_remaining": 0, "batched_static": True})
    late = {"tile_idx": 0, "batch_idx": 0, "image": timg.encode_image_data_url(
        np.zeros((4, 4, 3), np.float32))}
    assert request_json("POST", f"{base}/submit_tiles", {
        "job_id": "done", "worker_id": "w1", "tiles": [late], "is_final_flush": True,
    }, timeout=10) == (200, {"status": "ok", "accepted": 0})
    assert time.monotonic() - started < 2.0  # no wait for the 3 s grace
    assert store.finished["done"]["duplicates"] == 1
    assert store.finished["done"]["completions"] == [(0, "master")]
    started = time.monotonic()
    status, _ = request_json("POST", f"{base}/submit_tiles", {
        "job_id": "never", "worker_id": "w1", "tiles": []}, timeout=30)
    assert status == 404 and time.monotonic() - started >= 3.0
