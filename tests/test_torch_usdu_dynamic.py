"""USDU's dynamic (frame-queue) mode in the port, on the CPU in f32 on
tiny-unet: a participant pulls a frame index, runs all of the frame's
tiles and submits the frame; the master assembles the batch in order.

The four tests of tests/graph/test_usdu_dynamic.py on the port (whole
frames from a worker, the ordered batch, mode selection, an upscale
model), with the worker held against the JAX package's worker on the
same weights and the JAX package's folded frame keys (through the
`noise` seam; decoded frames within one 8-bit level); a dead worker's
frame recovered bit-equal; a frame's result independent of its claimer
(a worker thread's frames within one PNG rounding of the frames run
locally); the video workflow as master + w1 over HTTP; and the
collector job the orchestration announces for the USDU node, which the
JAX dynamic master keeps and the port's removes.
"""

import asyncio
import copy
import json
import os
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_distributed_tpu.graph.usdu_elastic import run_worker_dynamic as jax_run_worker_dynamic
from comfyui_distributed_tpu_torch.graph import ExecutionContext
from comfyui_distributed_tpu_torch.graph import usdu_elastic as tel
from comfyui_distributed_tpu_torch.graph.nodes_upscale import UltimateSDUpscaleDistributed
from comfyui_distributed_tpu_torch.jobs import JobStore
from comfyui_distributed_tpu_torch.ops import upscale as tup
from comfyui_distributed_tpu_torch.utils import image as timg
from comfyui_distributed_tpu_torch.utils.async_helpers import run_async_in_server_loop
from comfyui_distributed_tpu_torch.utils.network import request_json
from test_torch_elastic import tiny_pair  # noqa: F401  (fixture)
from test_torch_parity import one_torch_thread, port_loop, upscaler_pair  # noqa: F401
from test_torch_server import _wait_done, cluster  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 3
GEOMETRY = dict(upscale_by=2.0, tile=64, padding=16, steps=1, sampler="euler",
                scheduler="karras", cfg=3.0, denoise=0.3, seed=SEED)


def _frames(seed, n=3, side=64):
    return np.random.default_rng(seed).random((n, side, side, 3), dtype=np.float32)


class ScriptedDynamicClient:
    """Replays a fixed frame sequence; records the submitted frames."""

    def __init__(self, image_ids):
        self.image_ids = list(image_ids)
        self.frames = {}
        self.heartbeats = 0

    def poll_ready(self):
        return True

    def request_tile(self):
        if not self.image_ids:
            return None
        idx = self.image_ids.pop(0)
        return {"image_idx": idx, "estimated_remaining": len(self.image_ids)}

    def submit_image(self, image_idx, data_url, is_last):
        self.frames[image_idx] = (data_url, is_last)

    def heartbeat(self):
        self.heartbeats += 1


def _jax_frame_noise(seed):
    """The JAX dynamic worker's tile noise of frame f, tile g:
    split(fold_in(fold_in(key(seed), f), g))[0]."""
    key = jax.random.key(seed)

    def for_frame(frame_index):
        frame_key = jax.random.fold_in(key, frame_index)

        def noise(tile_index, shape):
            noise_key, _ = jax.random.split(jax.random.fold_in(frame_key, tile_index))
            return torch.from_numpy(np.array(jax.random.normal(noise_key, shape)))

        return noise

    return for_frame


def _u8(data_url):
    return timg.decode_image_data_url(data_url)


def test_worker_dynamic_processes_whole_frames_as_the_jax_worker(tiny_pair):
    jb, tb, (pos, neg) = tiny_pair
    img = _frames(0)
    jclient, tclient = ScriptedDynamicClient([1, 2]), ScriptedDynamicClient([1, 2])
    jax_run_worker_dynamic(jb, jnp.asarray(img), jnp.asarray(pos), jnp.asarray(neg), job_id="dj",
                           worker_id="w1", master_url="", client=jclient, **GEOMETRY)
    tel.run_worker_dynamic(tb, torch.from_numpy(img), torch.from_numpy(pos),
                           torch.from_numpy(neg), job_id="dj", worker_id="w1", master_url="",
                           client=tclient, noise=_jax_frame_noise(SEED), **GEOMETRY)
    assert set(tclient.frames) == set(jclient.frames) == {1, 2}
    assert tclient.frames[2][1] is True and tclient.frames[1][1] is False
    assert tclient.heartbeats == 2
    for idx in (1, 2):
        got, ref = _u8(tclient.frames[idx][0]), _u8(jclient.frames[idx][0])
        assert got.shape == (128, 128, 3)
        assert np.abs(got - ref).max() <= 1.0 / 255 + 1e-6


def _context(store, config=None):
    return ExecutionContext(device="cpu", server=types.SimpleNamespace(job_store=store),
                            config=config or {"workers": []})


def _local_frames(tb, img, pos, neg):
    """Each frame through _process_whole_image on this thread, default
    noise: the dynamic mode's reference."""
    upscaled, grid, _ = tup.prepare_upscaled_tiles(torch.from_numpy(img), 2.0, 64, 16)
    process = tel._tile_processor(tb, grid, 1, "euler", "karras", 3.0, 0.3)
    cond = (tup.prep_cond_for_tiles(pos, grid), tup.prep_cond_for_tiles(neg, grid))
    with torch.inference_mode():
        return [tel._process_whole_image(upscaled[f:f + 1], *cond, grid, process,
                                         tup.FrameTileNoise(SEED, f, "cpu"))[0].numpy()
                for f in range(img.shape[0])]


def test_master_dynamic_assembles_the_ordered_batch(tiny_pair, port_loop):
    _, tb, conds = tiny_pair
    pos, neg = (torch.from_numpy(c) for c in conds)
    img = _frames(1)
    store = JobStore()
    out = tel.run_master_dynamic(tb, img, pos, neg, job_id="dj2", enabled_worker_ids=[],
                                 context=_context(store), **GEOMETRY)
    assert out.shape == (3, 128, 128, 3) and bool(torch.isfinite(out).all())
    assert out[0].numpy().tobytes() != out[1].numpy().tobytes()
    for f, frame in enumerate(_local_frames(tb, img, pos, neg)):
        np.testing.assert_array_equal(out[f].numpy(), frame)
    record = store.finished["dj2"]
    assert record["completions"] == [(0, "master"), (1, "master"), (2, "master")]
    assert store.tile_jobs == {}


def test_node_mode_selection(tiny_pair, monkeypatch):
    """Dynamic where the batch is > 1 and >= dynamic_threshold, on the
    worker and on a master with workers and a server alike; static
    otherwise; no workers: the local path."""
    _, tb, conds = tiny_pair
    pos, neg = (torch.from_numpy(c) for c in conds)
    taken = []
    for name in ("run_worker_dynamic", "run_worker_loop", "run_master_dynamic",
                 "run_master_elastic"):
        monkeypatch.setattr(tel, name, lambda _name=name, **kw: taken.append(_name)
                            or kw["image"])
    node = UltimateSDUpscaleDistributed()
    args = dict(model=tb, positive=pos, negative=neg, vae=tb, seed=1, steps=1, cfg=1.0,
                denoise=0.3, tile_width=64, tile_height=64, tile_padding=16)
    server_context = ExecutionContext(device="cpu", server=types.SimpleNamespace())
    for batch, threshold, kw, expected in (
        (8, 8, dict(is_worker=True), "run_worker_dynamic"),
        (3, 8, dict(is_worker=True), "run_worker_loop"),
        (4, 4, dict(enabled_worker_ids=["w1"], context=server_context), "run_master_dynamic"),
        (4, 5, dict(enabled_worker_ids=["w1"], context=server_context), "run_master_elastic"),
        (1, 1, dict(enabled_worker_ids=["w1"], context=server_context), "run_master_elastic"),
    ):
        taken.clear()
        node.run(image=torch.from_numpy(_frames(2, batch, 32)), dynamic_threshold=threshold,
                 **args, **kw)
        assert taken == [expected], (batch, threshold, kw)
    (out,) = node.run(image=torch.from_numpy(_frames(2, 1, 64)), dynamic_threshold=1,
                      context=ExecutionContext(device="cpu"), **args)
    assert taken == [expected] and out.shape == (1, 128, 128, 3)


def test_node_with_an_upscale_model_in_dynamic_mode(tiny_pair, port_loop):
    """The upscale model runs before the frames are queued: each frame of
    the output equals the pre-upscaled frame processed whole at 1x."""
    _, tb, conds = tiny_pair
    pos, neg = (torch.from_numpy(c) for c in conds)
    _, upscaler = upscaler_pair("2x-test")
    img = torch.from_numpy(_frames(3, 2, 32))
    store = JobStore()
    (out,) = UltimateSDUpscaleDistributed().run(
        image=img, model=tb, positive=pos, negative=neg, vae=tb, seed=SEED, steps=1, cfg=3.0,
        denoise=0.3, upscale_by=2.0, tile_width=64, tile_height=64, tile_padding=16,
        upscale_model=upscaler, dynamic_threshold=2, enabled_worker_ids=["w1"], job_id="up",
        context=_context(store),
    )
    assert out.shape == (2, 64, 64, 3) and bool(torch.isfinite(out).all())
    assert [w for _, w in store.finished["up"]["completions"]] == ["master", "master"]


def test_a_dead_workers_frame_is_recovered_bit_equal(tiny_pair, port_loop, monkeypatch):
    """w1 pulls frame 0 and is never heard from again. With the heartbeat
    timeout at 0.3 s the master requeues it and runs it itself; the batch
    is bit-equal to the fault-free run."""
    _, tb, conds = tiny_pair
    pos, neg = (torch.from_numpy(c) for c in conds)
    img = _frames(4)
    store = JobStore()
    context = _context(store, {"workers": [], "settings": {"worker_timeout_seconds": 0.3}})
    clean = tel.run_master_dynamic(tb, img, pos, neg, job_id="clean", enabled_worker_ids=[],
                                   context=context, **GEOMETRY)
    init = store.init_tile_job
    stolen = []

    async def init_then_a_worker_pulls_and_dies(*args, **kwargs):
        job = await init(*args, **kwargs)
        stolen.append(await store.pull_task("faulty", "w1", timeout=0.5))
        return job

    monkeypatch.setattr(store, "init_tile_job", init_then_a_worker_pulls_and_dies)
    recovered = tel.run_master_dynamic(tb, img, pos, neg, job_id="faulty",
                                       enabled_worker_ids=["w1"], context=context, **GEOMETRY)
    record = store.finished["faulty"]
    assert stolen == [0]
    assert sorted(record["completions"]) == [(0, "master"), (1, "master"), (2, "master")]
    assert record["completions"][-1] == (0, "master")  # run after the requeue
    np.testing.assert_array_equal(recovered.numpy(), clean.numpy())


class StoreClient:
    """A worker's client that talks to the master's store directly."""

    def __init__(self, store, job_id, worker_id, first_pull):
        self.store, self.job_id, self.worker_id = store, job_id, worker_id
        self.first_pull = first_pull
        self.pulled = []

    def poll_ready(self):
        return run_async_in_server_loop(self.store.wait_for_tile_job(self.job_id, 10), 30) \
            is not None

    def request_tile(self):
        idx = run_async_in_server_loop(
            self.store.pull_task(self.job_id, self.worker_id, timeout=0.2), 30)
        self.first_pull.set()
        if idx is None:
            return None
        self.pulled.append(idx)
        remaining = run_async_in_server_loop(self.store.remaining(self.job_id), 30)
        return {"image_idx": idx, "estimated_remaining": remaining}

    def submit_image(self, image_idx, data_url, is_last):
        payload = [{"batch_idx": 0, "image": data_url, "whole_image": True}]
        run_async_in_server_loop(
            self.store.submit_flush(self.job_id, self.worker_id, {image_idx: payload}), 30)

    def heartbeat(self):
        run_async_in_server_loop(self.store.heartbeat(self.job_id, self.worker_id), 30)


def test_a_frame_does_not_depend_on_who_claims_it(tiny_pair, port_loop, monkeypatch):
    """A worker thread (the real run_worker_dynamic) pulls first; the
    master runs the rest. Every frame equals the frame run locally: the
    master's bit for bit, the worker's within one PNG rounding."""
    _, tb, conds = tiny_pair
    pos, neg = (torch.from_numpy(c) for c in conds)
    img = _frames(5, 4)
    store = JobStore()
    first_pull = threading.Event()
    client = StoreClient(store, "shared", "w1", first_pull)
    thread = threading.Thread(target=lambda: tel.run_worker_dynamic(
        tb, torch.from_numpy(img), pos, neg, job_id="shared", worker_id="w1", master_url="",
        client=client, **GEOMETRY), daemon=True)
    init = store.init_tile_job

    async def init_then_let_the_worker_pull_first(*args, **kwargs):
        job = await init(*args, **kwargs)
        thread.start()
        await asyncio.to_thread(first_pull.wait, 10)
        return job

    monkeypatch.setattr(store, "init_tile_job", init_then_let_the_worker_pull_first)
    out = tel.run_master_dynamic(tb, img, pos, neg, job_id="shared", enabled_worker_ids=["w1"],
                                 context=_context(store), **GEOMETRY)
    thread.join(timeout=60)
    assert not thread.is_alive() and client.pulled and client.pulled[0] == 0
    record = store.finished["shared"]
    by = dict(record["completions"])
    assert sorted(by) == [0, 1, 2, 3] and {by[f] for f in client.pulled} == {"w1"}
    assert "master" in by.values()
    for f, frame in enumerate(_local_frames(tb, img, pos, neg)):
        if by[f] == "master":
            np.testing.assert_array_equal(out[f].numpy(), frame)
        else:
            np.testing.assert_allclose(out[f].numpy(), frame, atol=0.5 / 255 + 1e-6, rtol=0)


def _video_prompt(frames):
    """The bundled video workflow on tiny-unet, its LoadImage replaced by
    `frames` LoadImage nodes joined by ImageBatch nodes."""
    with open(os.path.join(REPO, "workflows", "distributed-upscale-video.json"),
              encoding="utf-8") as fh:
        prompt = json.load(fh)
    prompt = copy.deepcopy(prompt)
    prompt["1"]["inputs"]["ckpt_name"] = "tiny-unet"
    prompt["5"]["inputs"].update(steps=1, tile_width=64, tile_height=64, tile_padding=16)
    prompt["4"] = {"class_type": "LoadImage", "inputs": {"image": "frame_0.png"}}
    last = "4"
    for i in range(1, frames):
        prompt[f"10{i}"] = {"class_type": "LoadImage", "inputs": {"image": f"frame_{i}.png"}}
        prompt[f"20{i}"] = {"class_type": "ImageBatch",
                            "inputs": {"image1": [last, 0], "image2": [f"10{i}", 0]}}
        last = f"20{i}"
    prompt["5"]["inputs"]["image"] = [last, 0]
    return prompt


def test_the_video_workflow_runs_dynamic_over_http(cluster):
    """8 frames at the workflow's own dynamic_threshold of 8, master + w1
    over HTTP: every frame once, w1's through /distributed/submit_image,
    the tile job and the announced collector job cleaned up."""
    master, worker, tmp_path = cluster
    rng = np.random.default_rng(6)
    for i in range(8):
        (tmp_path / "in" / f"frame_{i}.png").write_bytes(
            timg.encode_png(rng.random((32, 32, 3), dtype=np.float32)))
    base = f"http://127.0.0.1:{master.port}"
    status, queued = request_json("POST", f"{base}/distributed/queue", {
        "prompt": _video_prompt(8), "client_id": "test", "workers": ["w1"],
    }, timeout=30)
    assert status == 200, queued
    history = _wait_done(f"{base}/history/{queued['prompt_id']}", timeout=120)
    worker_history = _wait_done(
        f"http://127.0.0.1:{worker.port}/history/{queued['trace_id']}_w0", timeout=120)
    assert history["error"] is None and worker_history["error"] is None
    record = master.job_store.finished[queued["job_ids"]["5"]]
    assert sorted(f for f, _ in record["completions"]) == list(range(8))
    assert record["duplicates"] == 0
    by_w1 = sum(1 for _, who in record["completions"] if who == "w1")
    assert record["received_bytes"] > 0 if by_w1 else record["received_bytes"] == 0
    out = master.get_job(queued["prompt_id"]).outputs["6"][0]["images"]
    assert out.shape == (8, 64, 64, 3) and bool(torch.isfinite(out).all())
    # the master removes the collector job the orchestration announced for
    # the USDU node; a worker asking after the job now reads it ready
    # (and drained), not unknown
    assert master.job_store.tile_jobs == {} and master.job_store.collectors == {}
    assert request_json("POST", f"{base}/distributed/job_status",
                        {"job_id": queued["job_ids"]["5"]}, timeout=10) == (200, {"ready": True})


def test_the_jax_usdu_master_keeps_the_announced_collector_job(tiny_pair, port_loop,
                                                               server_loop):
    """The divergence the video-workflow test above shows on the port,
    held against the reference: the orchestration announces a collector
    job for the USDU node (ensure_collector) before the master runs. The
    JAX dynamic master never removes it, so the job outlives the prompt in
    its store; the port's master removes it with the tile job."""
    from comfyui_distributed_tpu.graph import ExecutionContext as JaxExecutionContext
    from comfyui_distributed_tpu.graph.usdu_elastic import run_master_dynamic as jax_master
    from comfyui_distributed_tpu.jobs import JobStore as JaxJobStore
    from comfyui_distributed_tpu.utils.async_helpers import (
        run_async_in_server_loop as jax_run_async,
    )

    jb, tb, conds = tiny_pair
    img = _frames(4, n=2)
    jax_store, port_store = JaxJobStore(), JobStore()
    jax_run_async(jax_store.ensure_collector("dj_kept"), timeout=30)
    run_async_in_server_loop(port_store.ensure_collector("dj_kept"), timeout=30)
    jax_out = jax_master(
        jb, jnp.asarray(img), jnp.asarray(conds[0]), jnp.asarray(conds[1]), job_id="dj_kept",
        enabled_worker_ids=[], context=JaxExecutionContext(
            server=types.SimpleNamespace(job_store=jax_store), config={"workers": []}),
        **GEOMETRY)
    pos, neg = (torch.from_numpy(c) for c in conds)
    port_out = tel.run_master_dynamic(tb, img, pos, neg, job_id="dj_kept",
                                      enabled_worker_ids=[], context=_context(port_store),
                                      **GEOMETRY)
    assert np.asarray(jax_out).shape == tuple(port_out.shape) == (2, 128, 128, 3)
    assert "dj_kept" in jax_store.collectors and jax_store.tile_jobs == {}
    assert "dj_kept" not in port_store.collectors and port_store.tile_jobs == {}
