"""Seed-parallel txt2img over HTTP in the port, on the CPU: the
DistributedCollector, its /distributed/job_complete route and the job
store's collector jobs. The port's mirror of
tests/api/test_integration.py's txt2img cluster test, plus the
collector's own rules: envelope validation, dedup, the empty-batch
envelope, participant order, the size filter and the worker timeout.

Servers run on the CPU with one intra-op torch thread (two executor
threads share the cores). A worker's image travels as an 8-bit PNG, so
it lies within half a level (0.5 / 255) of the image the worker
computed.
"""

import asyncio
import json
import os
import socket
import time
import types

import numpy as np
import pytest
import torch

from comfyui_distributed_tpu.parallel.collective import (
    reorder_participant_first as jax_reorder_participant_first,
)
from comfyui_distributed_tpu_torch.api.server import DistributedServer
from comfyui_distributed_tpu_torch.graph import ExecutionContext, GraphExecutor
from comfyui_distributed_tpu_torch.graph.nodes_distributed import (
    DistributedCollector,
    DistributedEmptyImage,
    DistributedSeed,
    ImageBatchDivider,
)
from comfyui_distributed_tpu_torch.models import pipeline as tpl
from comfyui_distributed_tpu_torch.parallel.collective import reorder_participant_first
from comfyui_distributed_tpu_torch.utils import config as config_mod
from comfyui_distributed_tpu_torch.utils import image as timg
from comfyui_distributed_tpu_torch.utils.network import request_json

from test_torch_parity import one_torch_thread, port_loop  # noqa: F401  (fixtures)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PNG_STEP = 0.5 / 255
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
        time.sleep(0.05)
    raise AssertionError(f"{url} not done within {timeout} s")


def _txt2img_prompt(seed=11):
    """The bundled workflow at tiny-unet, 32 px, 2 steps, ending in a
    PreviewImage (nothing written), as tests/api/test_integration.py's."""
    with open(os.path.join(REPO, "workflows", "distributed-txt2img.json"), encoding="utf-8") as fh:
        prompt = json.load(fh)
    prompt["1"]["inputs"]["ckpt_name"] = "tiny-unet"
    prompt["2"]["inputs"]["text"] = "a cat"
    prompt["3"]["inputs"]["text"] = ""
    prompt["4"]["inputs"].update(width=32, height=32)
    prompt["5"]["inputs"]["seed"] = seed
    prompt["6"]["inputs"].update(steps=2, cfg=3.0)
    prompt["9"] = {"class_type": "PreviewImage", "inputs": {"images": ["8", 0]}}
    return prompt


@pytest.fixture(scope="module")
def bundle():
    """tiny-unet with seeded random weights and a non-zero out_conv."""
    b = tpl.load_pipeline("tiny-unet", seed=0, device="cpu")
    with torch.no_grad():
        weight = b.unet.out_conv.weight
        weight.copy_(torch.randn(weight.shape, generator=torch.Generator().manual_seed(0)) * 0.1)
    return b


def _config(tmp_path, worker_ids=("w1",), timeout=None):
    """A config naming workers on free ports; returns (path, ports)."""
    ports = {wid: _free_port() for wid in worker_ids}
    settings = {"output_dir": str(tmp_path / "out")}
    if timeout is not None:
        settings["worker_timeout_seconds"] = timeout
    path = str(tmp_path / "config.json")
    config_mod.save_config({
        "master": {"host": "127.0.0.1"},
        "workers": [{"id": wid, "name": wid, "type": "remote", "host": "127.0.0.1",
                     "port": port, "enabled": True} for wid, port in ports.items()],
        "settings": settings,
    }, path)
    return path, ports


def _start(port_loop, servers):
    async def boot():
        for server in servers:
            await server.start()

    asyncio.run_coroutine_threadsafe(boot(), port_loop.loop).result(timeout=30)


def _stop(port_loop, servers):
    async def teardown():
        for server in servers:
            await server.stop()

    asyncio.run_coroutine_threadsafe(teardown(), port_loop.loop).result(timeout=60)


@pytest.fixture
def cluster(tmp_path, port_loop, bundle):
    """A master and worker w1 on one loop, sharing tiny-unet."""
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


def _local(bundle, seed):
    context = ExecutionContext(device="cpu")
    context.pipelines["tiny-unet"] = bundle
    executor = GraphExecutor(context)
    executor.execute(_txt2img_prompt(seed))
    return executor.last_results["8"][0]


def test_distributed_queue_gathers_the_master_and_the_worker(cluster, bundle):
    master, worker = cluster
    base = f"http://127.0.0.1:{master.port}"
    status, queued = request_json("POST", f"{base}/distributed/queue", {
        "prompt": _txt2img_prompt(), "client_id": "test", "workers": ["w1"]}, timeout=30)
    assert status == 200 and queued["status"] == "queued" and queued["workers"] == ["w1"]
    history = _wait_done(f"{base}/history/{queued['prompt_id']}")
    worker_history = _wait_done(f"http://127.0.0.1:{worker.port}/history/{queued['trace_id']}_w0")
    assert history["error"] is None and worker_history["error"] is None
    images = master.get_job(queued["prompt_id"]).outputs["9"][0]["images"]
    assert tuple(images.shape) == (2, 32, 32, 3)
    assert not torch.equal(images[0], images[1])  # distinct seeds, distinct images
    torch.testing.assert_close(images[0], _local(bundle, 11)[0], atol=0, rtol=0)
    torch.testing.assert_close(images[1], _local(bundle, 12)[0], atol=PNG_STEP + 1e-7, rtol=0)
    # the master's collector cleaned its job up: the counts are its record
    assert not master.job_store.collectors
    record = master.job_store.finished[queued["job_ids"]["8"]]
    assert record["received"] == {"w1": 1} and record["finished_workers"] == ["w1"]
    assert record["received_bytes"] > 0 and record["late"] == 0


def test_collector_jobs_end_with_their_prompts_where_the_jax_store_keeps_them(
        cluster, server_loop, port_loop):
    """Three prompts through a master and w1: the master's collector
    removes each job once drained, so the store holds none, and a late
    envelope for a finished job is dropped without making the job again.
    The JAX master's collector, given the same three drained jobs, leaves
    all three in its store (a deliberate divergence, ROADMAP Queue 3)."""
    from comfyui_distributed_tpu.graph.nodes_distributed import (
        DistributedCollector as JaxCollector,
    )
    from comfyui_distributed_tpu.jobs.store import JobStore as JaxJobStore

    master, _ = cluster
    base = f"http://127.0.0.1:{master.port}"
    job_ids = []
    for seed in (1, 2, 3):
        status, queued = request_json("POST", f"{base}/distributed/queue", {
            "prompt": _txt2img_prompt(seed), "client_id": "test", "workers": ["w1"]}, timeout=30)
        assert status == 200 and queued["workers"] == ["w1"]
        assert _wait_done(f"{base}/history/{queued['prompt_id']}")["error"] is None
        job_ids.append(queued["job_ids"]["8"])
    assert master.job_store.collectors == {}
    assert all(master.job_store.finished[j]["received"] == {"w1": 1} for j in job_ids)
    assert _post(master, _envelope(0.2, job_id=job_ids[0])) == (200, {"status": "late"})
    assert master.job_store.collectors == {}
    assert master.job_store.finished[job_ids[0]]["late"] == 1

    jax_store = JaxJobStore()
    server = types.SimpleNamespace(job_store=jax_store)
    context = types.SimpleNamespace(check_interrupted=lambda: None, config={}, server=server)
    image = np.full((1, 8, 8, 3), 0.5, np.float32)
    for job_id in job_ids:
        for coro in (jax_store.ensure_collector(job_id),
                     jax_store.put_collector_result(job_id, {
                         "tensor": image[0], "worker_id": "w1", "batch_idx": 0,
                         "is_last": True})):
            asyncio.run_coroutine_threadsafe(coro, server_loop.loop).result(timeout=10)
        out = JaxCollector().run(image, job_id=job_id, enabled_worker_ids=["w1"],
                                 context=context)[0]
        assert tuple(out.shape) == (2, 8, 8, 3)
    assert sorted(jax_store.collectors) == sorted(job_ids)


@pytest.fixture
def master_only(tmp_path, port_loop):
    """A master alone, its collector job "job" announced as the
    orchestration announces it before dispatch (an envelope for an
    unknown job parks the 10 s creation grace); workers' envelopes are
    posted by hand."""
    config_path, _ = _config(tmp_path, worker_ids=("w1", "w2"), timeout=0.4)
    master = DistributedServer(port=_free_port(), is_worker=False, config_path=config_path,
                               device="cpu")
    _start(port_loop, (master,))
    asyncio.run_coroutine_threadsafe(master.job_store.ensure_collector("job"),
                                     port_loop.loop).result(timeout=10)
    yield master
    _stop(port_loop, (master,))


def _envelope(value, worker_id="w1", batch_idx=0, is_last=True, job_id="job", size=8):
    image = np.full((size, size, 3), value, np.float32)
    return {"job_id": job_id, "worker_id": worker_id, "batch_idx": batch_idx,
            "image": timg.encode_image_data_url(image), "is_last": is_last}


def _post(master, body):
    return request_json("POST", f"http://127.0.0.1:{master.port}/distributed/job_complete", body,
                        timeout=30)


def _collect(master, enabled, images=None, job_id="job"):
    """The master's collector as its executor thread runs it."""
    context = ExecutionContext(device="cpu", config=master.config, server=master)
    images = torch.full((1, 8, 8, 3), 0.5) if images is None else images
    return DistributedCollector().run(images, job_id=job_id, enabled_worker_ids=enabled,
                                      context=context)[0]


@pytest.mark.parametrize("field", ["job_id", "worker_id", "batch_idx", "image"])
def test_job_complete_answers_400_on_a_missing_field(master_only, field):
    body = _envelope(0.2)
    del body[field]
    status, out = _post(master_only, body)
    assert status == 400 and repr(field) in out["error"]


@pytest.mark.parametrize("change, match", [
    ({"batch_idx": "first"}, "batch_idx must be an int"),
    ({"image": "data:image/png;base64,bm90IGEgcG5n"}, "undecodable image"),
    ({"image": 7}, "image must be a base64 data-URL string"),
])
def test_job_complete_answers_400_on_a_bad_envelope(master_only, change, match):
    status, out = _post(master_only, {**_envelope(0.2), **change})
    assert status == 400 and match in out["error"]
    assert master_only.job_store.collectors["job"].received == {}
    assert request_json("POST", f"http://127.0.0.1:{master_only.port}/distributed/job_complete",
                        [1, 2], timeout=10)[0] == 400


def test_prepare_job_announces_a_collector(master_only):
    base = f"http://127.0.0.1:{master_only.port}"
    assert request_json("POST", f"{base}/distributed/prepare_job", {}, timeout=10)[0] == 400
    assert request_json("POST", f"{base}/distributed/prepare_job", {"job_id": "j9"},
                        timeout=10) == (200, {"status": "ok"})
    assert "j9" in master_only.job_store.collectors
    assert request_json("POST", f"{base}/distributed/job_status", {"job_id": "j9"},
                        timeout=10) == (200, {"ready": True})


def test_a_repeated_envelope_is_dropped_and_every_queued_one_is_drained(master_only):
    """w1 sends image 0 twice (a retried POST), then image 1 as its last:
    the batch holds each once, in batch order, although w1 had finished
    before the collector read its first envelope."""
    for body in (_envelope(0.2, batch_idx=0, is_last=False),
                 _envelope(0.2, batch_idx=0, is_last=False),
                 _envelope(0.8, batch_idx=1, is_last=True)):
        assert _post(master_only, body)[0] == 200
    assert master_only.job_store.collectors["job"].received == {"w1": 3}
    out = _collect(master_only, ["w1"])
    assert tuple(out.shape) == (3, 8, 8, 3)
    levels = [round(float(out[i].mean()) * 255) for i in range(3)]
    assert levels == [128, 51, 204]  # master 0.5, then w1's 0.2 and 0.8


def test_the_jax_drain_leaves_queued_envelopes_the_port_drains(server_loop, port_loop):
    """Both packages' drains on one sequence: w1's two envelopes (the
    second is_last) are queued before the master's collector starts. The
    JAX drain stops once every worker has finished and returns one; the
    port's empties the queue first."""
    from comfyui_distributed_tpu.graph.nodes_distributed import (
        DistributedCollector as JaxCollector,
    )
    from comfyui_distributed_tpu.jobs.store import JobStore as JaxJobStore
    from comfyui_distributed_tpu_torch.jobs import JobStore

    image = np.zeros((8, 8, 3), np.float32)
    items = [{"tensor": image + 0.2, "worker_id": "w1", "batch_idx": 0, "is_last": False},
             {"tensor": image + 0.8, "worker_id": "w1", "batch_idx": 1, "is_last": True}]
    counts = []
    for store, loop, collector in ((JaxJobStore(), server_loop, JaxCollector()),
                                   (JobStore(), port_loop, DistributedCollector())):
        for item in items:
            asyncio.run_coroutine_threadsafe(store.put_collector_result("job", dict(item)),
                                             loop.loop).result(timeout=10)
        server = types.SimpleNamespace(job_store=store)
        context = types.SimpleNamespace(check_interrupted=lambda: None, config={},
                                        server=server)
        counts.append(len(collector._drain_worker_results(server, "job", ["w1"], context)))
    assert counts == [1, 2]


def test_collector_store_sequence_equals_the_jax_stores(server_loop, port_loop):
    """One scripted sequence on both packages' stores: an envelope for a
    job nobody announced parks the grace, then creates the job; counts
    per worker; is_last marks a worker finished; cleanup removes the
    job; the queue keeps arrival order."""
    from comfyui_distributed_tpu.jobs.store import JobStore as JaxJobStore
    from comfyui_distributed_tpu_torch.jobs import JobStore

    async def script(store):
        parked = await store.wait_for_collector("late", 0.05)
        announced = await store.ensure_collector("j")
        for worker_id, idx, last in (("w1", 0, False), ("w2", 0, True), ("w1", 1, True),
                                     ("w1", 1, True)):
            await store.put_collector_result("j", {"worker_id": worker_id, "batch_idx": idx,
                                                   "is_last": last})
        order = [(item["worker_id"], item["batch_idx"])
                 for item in [announced.queue.get_nowait() for _ in range(4)]]
        await store.cleanup_collector("j")
        return (parked.job_id, sorted(store.collectors), announced.received,
                sorted(announced.finished_workers), order)

    results = [asyncio.run_coroutine_threadsafe(script(store), loop.loop).result(timeout=10)
               for store, loop in ((JaxJobStore(), server_loop), (JobStore(), port_loop))]
    assert results[0] == results[1]
    assert results[1] == ("late", ["late"], {"w1": 3, "w2": 1}, ["w1", "w2"],
                          [("w1", 0), ("w2", 0), ("w1", 1), ("w1", 1)])


def test_a_late_envelope_stays_late_once_its_record_is_evicted(master_only, port_loop):
    """The collector drains "job" and cleans it up; then as many tile jobs
    finish as `finished` keeps, which evicts the collector's record. An
    envelope for "job" that arrives after that is still late: the store
    makes no job for it."""
    from comfyui_distributed_tpu_torch.jobs import store as store_mod

    store = master_only.job_store
    assert _post(master_only, _envelope(0.2))[0] == 200
    assert tuple(_collect(master_only, ["w1"]).shape) == (2, 8, 8, 3)
    assert store.collectors == {} and store.finished["job"]["received"] == {"w1": 1}

    async def churn():
        for i in range(store_mod.FINISHED_KEPT):
            await store.init_tile_job(f"tiles{i}", [0])
            await store.cleanup_tile_job(f"tiles{i}")

    asyncio.run_coroutine_threadsafe(churn(), port_loop.loop).result(timeout=10)
    assert "job" not in store.finished
    assert _post(master_only, _envelope(0.3)) == (200, {"status": "late"})
    assert store.collectors == {}


def test_an_empty_batch_finishes_the_worker_at_once(master_only):
    (envelope,) = DistributedCollector.envelopes(torch.zeros((0, 8, 8, 3)), "w1", "job")
    assert envelope["empty"] and envelope["is_last"] and envelope["batch_idx"] == 0
    assert _post(master_only, envelope)[0] == 200
    started = time.monotonic()
    out = _collect(master_only, ["w1"])
    assert time.monotonic() - started < 0.4  # no wait for the timeout
    assert tuple(out.shape) == (1, 8, 8, 3) and float(out.mean()) == 0.5


def test_order_is_master_then_enabled_workers_then_stragglers(master_only):
    """Enabled ["w2", "w1"]; a straggler w9 that was not dispatched still
    reports. Arrival order is w9, w1, w2."""
    for body in (_envelope(0.9, worker_id="w9"), _envelope(0.1, worker_id="w1"),
                 _envelope(0.2, worker_id="w2", batch_idx=1, is_last=False),
                 _envelope(0.3, worker_id="w2", batch_idx=0, is_last=False),
                 _envelope(0.4, worker_id="w2", batch_idx=2)):
        assert _post(master_only, body)[0] == 200
    out = _collect(master_only, ["w2", "w1"])
    levels = [round(float(out[i].mean()) * 255) for i in range(out.shape[0])]
    assert levels == [128, 77, 51, 102, 26, 230]  # master, w2 0..2, w1, w9


def test_images_of_another_size_are_dropped(master_only):
    assert _post(master_only, _envelope(0.2, worker_id="w1", size=4))[0] == 200
    assert _post(master_only, _envelope(0.4, worker_id="w2"))[0] == 200
    out = _collect(master_only, ["w1", "w2"])
    assert tuple(out.shape) == (2, 8, 8, 3)
    assert round(float(out[1].mean()) * 255) == 102


def test_a_worker_that_never_reports_is_given_up_after_the_timeout(master_only):
    """worker_timeout_seconds is 0.4 here; w1 and w2 are configured on
    ports nobody listens on, so the busy probe finds them offline."""
    started = time.monotonic()
    out = _collect(master_only, ["w1", "w2"])
    elapsed = time.monotonic() - started
    assert 0.4 <= elapsed < 10
    assert tuple(out.shape) == (1, 8, 8, 3) and float(out.mean()) == 0.5


def test_a_busy_worker_is_given_more_time(master_only, monkeypatch):
    """The stall probe finds w1 busy once: the collector waits another
    timeout, in which w1's image arrives."""
    probes = []

    def probe(worker_ids, context):
        probes.append(list(worker_ids))
        _post(master_only, _envelope(0.2))
        return True

    monkeypatch.setattr(DistributedCollector, "_probe_any_busy", staticmethod(probe))
    out = _collect(master_only, ["w1"])
    assert probes == [["w1"]] and tuple(out.shape) == (2, 8, 8, 3)


def test_envelopes_carry_every_image_and_mark_the_last():
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.random((3, 8, 8, 3), dtype=np.float32))
    envelopes = DistributedCollector.envelopes(images, "w1", "job")
    assert [(e["batch_idx"], e["is_last"]) for e in envelopes] == [(0, False), (1, False),
                                                                    (2, True)]
    for envelope, image in zip(envelopes, images):
        decoded = timg.decode_image_data_url(envelope["image"])
        assert np.abs(decoded - image.numpy()).max() <= PNG_STEP + 1e-7


@pytest.mark.parametrize("batches, order", [
    ({0: "m", 1: "a", 2: "b"}, [1, 2]),
    ({0: "m", 2: "b", 1: "a"}, [2, 1]),
    ({1: "a", 5: "s", 2: "b"}, [1, 2]),
    ({0: "m", 3: "c", 7: "s", 4: "t"}, [1, 2]),
    ({}, [1]),
])
def test_reorder_participant_first_equals_the_jax_packages(batches, order):
    assert reorder_participant_first(batches, order) == jax_reorder_participant_first(batches,
                                                                                     order)


def test_unported_branches_raise_and_the_small_nodes_work():
    collector = DistributedCollector()
    images = torch.zeros((1, 8, 8, 3))
    # audio is ported: with no server the master's own audio comes back
    audio = {"waveform": torch.zeros(1, 1, 4), "sample_rate": 8}
    assert collector.run(images, audio=audio)[1] is audio
    # the load_balance widget is accepted and has no effect, as in the JAX
    # node: the same images come out of both packages' collectors
    from comfyui_distributed_tpu.graph.nodes_distributed import (
        DistributedCollector as JaxDistributedCollector,
    )

    pixels = np.random.default_rng(3).random((2, 8, 8, 3), dtype=np.float32)
    port_out = collector.run(torch.from_numpy(pixels), load_balance=True)[0]
    jax_out = JaxDistributedCollector().run(pixels, load_balance=True)[0]
    np.testing.assert_array_equal(port_out.numpy(), np.asarray(jax_out))
    np.testing.assert_array_equal(port_out.numpy(), pixels)
    assert collector.run(images, pass_through=True)[0] is images
    assert collector.run(images, enabled_worker_ids=["w1"])[0] is images  # no server: local
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        DistributedSeed().get_seed(3, context=types.SimpleNamespace(mesh=object()))
    assert DistributedSeed().get_seed(3, is_worker=True, worker_index=1)[0].effective_seed() == 5
    assert DistributedSeed().get_seed(3)[0].effective_seed() == 3
    parts = ImageBatchDivider().divide(torch.arange(5.0).reshape(5, 1, 1, 1), divide_by=3)
    assert [p.shape[0] for p in parts] == [2, 2, 1] + [0] * 7
    empty = DistributedEmptyImage().empty(context=ExecutionContext(device="cpu"))[0]
    assert tuple(empty.shape) == (0, 64, 64, 3)


def test_txt2img_prompt_rewrite_equals_the_jax_packages():
    """The worker's pruned prompt (SaveImage dropped, a PreviewImage on
    the collector) and each participant's overrides, as the JAX package
    writes them."""
    from comfyui_distributed_tpu.graph import prompt as jprompt
    from comfyui_distributed_tpu_torch.graph import prompt as tprompt

    with open(os.path.join(REPO, "workflows", "distributed-txt2img.json"), encoding="utf-8") as fh:
        workflow = json.load(fh)
    pruned = tprompt.prune_prompt_for_worker(workflow)
    assert pruned == jprompt.prune_prompt_for_worker(workflow)
    assert "9" not in pruned and pruned["10"]["class_type"] == "PreviewImage"
    job_ids = {"8": "exec_1_abcdef_8"}
    assert sorted(tprompt.generate_job_id_map(workflow)) == ["8"]
    for info in (dict(is_worker=True, worker_index=0, worker_id="w1",
                      master_url="http://127.0.0.1:8188", job_ids=job_ids,
                      enabled_worker_ids=["w1"]),
                 dict(is_worker=False, job_ids=job_ids, enabled_worker_ids=["w1"])):
        source = pruned if info["is_worker"] else workflow
        out = tprompt.apply_participant_overrides(source, tprompt.ParticipantInfo(**info))
        assert out == jprompt.apply_participant_overrides(source, jprompt.ParticipantInfo(**info))
        assert out["8"]["inputs"]["job_id"] == "exec_1_abcdef_8"
        assert out["5"]["inputs"]["worker_index"] == (0 if info["is_worker"] else -1)
