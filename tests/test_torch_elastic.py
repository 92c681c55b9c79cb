"""The port's elastic USDU tier against the JAX package's, on the CPU in
f32: the host canvases (bit-equal), the prompt rewrite (equal), the
worker loop (the same tiles, within one 8-bit level), and the master's
loop with a worker thread on a real JobStore, including a worker that
pulls a tile and goes silent.

The worker parity runs both packages on the same tiny-unet weights
(numpy-seeded in the flax layout, carried into the port) and the same
noise (the JAX package's folded-key normals, through the port's `noise`
seam).
"""

import asyncio
import base64
import copy
import json
import os
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_distributed_tpu.graph import prompt as jprompt
from comfyui_distributed_tpu.graph.usdu_elastic import run_worker_loop as jax_run_worker_loop
from comfyui_distributed_tpu.models import pipeline as jpl
from comfyui_distributed_tpu.models import registry as jreg
from comfyui_distributed_tpu.models import text_encoder as jte
from comfyui_distributed_tpu.models.io import flatten_params
from comfyui_distributed_tpu.ops import tiles as jtiles
from comfyui_distributed_tpu_torch.graph import ExecutionContext
from comfyui_distributed_tpu_torch.graph import prompt as tprompt
from comfyui_distributed_tpu_torch.graph.tile_pipeline import TilePipeline, stage_span
from comfyui_distributed_tpu_torch.graph.usdu_elastic import (
    _tile_processor,
    run_master_elastic,
    run_worker_loop,
)
from comfyui_distributed_tpu_torch.jobs import JobStore
from comfyui_distributed_tpu_torch.models import pipeline as tpl
from comfyui_distributed_tpu_torch.models import registry as treg
from comfyui_distributed_tpu_torch.models.io import from_jax_params
from comfyui_distributed_tpu_torch.ops import tiles as ttiles
from comfyui_distributed_tpu_torch.ops import upscale as tup
from comfyui_distributed_tpu_torch.telemetry import instruments as tinstruments
from comfyui_distributed_tpu_torch.telemetry import reset_metrics_registry
from comfyui_distributed_tpu_torch.utils import image as timg
from comfyui_distributed_tpu_torch.utils.async_helpers import run_async_in_server_loop
from test_torch_parity import f32, seeded_flax_params
from test_torch_parity import one_torch_thread, port_loop  # noqa: F401  (fixtures)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = ("tiny-unet", "tiny-vae", "tiny-te")
SEED = 4
GEOMETRY = dict(upscale_by=2.0, tile=64, padding=16, steps=1, sampler="euler",
                scheduler="karras", cfg=3.0, denoise=0.3, seed=SEED, mask_blur=8)



def _image(seed, shape):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)



# --- canvases -----------------------------------------------------------------

GRIDS = [
    dict(image_h=128, image_w=128, tile_h=64, tile_w=64, padding=16, mask_blur=8),
    dict(image_h=100, image_w=136, tile_h=48, tile_w=64, padding=8),
    dict(image_h=100, image_w=136, tile_h=48, tile_w=64, padding=8, uniform=False),
]


@pytest.mark.parametrize("kw", GRIDS)
def test_host_canvases_are_bit_equal_to_the_jax_packages(kw):
    jgrid, tgrid = jtiles.calculate_tiles(**kw), ttiles.calculate_tiles(**kw)
    base = _image(0, (2, kw["image_h"], kw["image_w"], 3))
    tiles = _image(1, (tgrid.num_tiles, 2, tgrid.padded_h, tgrid.padded_w, 3))
    order = list(np.random.default_rng(2).permutation(tgrid.num_tiles))  # arrival order
    canvases = [
        (jtiles.HostIncrementalCanvas(jnp.asarray(base), jgrid),
         ttiles.HostIncrementalCanvas(torch.from_numpy(base), tgrid)),
        (jtiles.DeterministicHostCanvas(jnp.asarray(base), jgrid),
         ttiles.DeterministicHostCanvas(torch.from_numpy(base), tgrid)),
    ]
    device = ttiles.IncrementalCanvas(torch.from_numpy(base), tgrid)
    for g in order:
        y, x = tgrid.positions[g]
        for jc, tc in canvases:
            jc.blend(tiles[g], y, x)
            tc.blend(torch.from_numpy(tiles[g]), y, x)
        device.blend(torch.from_numpy(tiles[g]), y, x)
    outs = [(np.asarray(jc.result()), tc.result().numpy()) for jc, tc in canvases]
    for ref, out in outs:
        np.testing.assert_array_equal(out, ref)
    # the in-arrival-order canvas and the eager device twin agree bit for bit
    np.testing.assert_array_equal(device.result().numpy(), outs[0][1])
    # overlapping lerps are order-dependent; the deterministic canvas is not
    resorted = ttiles.DeterministicHostCanvas(torch.from_numpy(base), tgrid)
    for g in reversed(order):
        resorted.blend(tiles[g], *tgrid.positions[g])
    np.testing.assert_array_equal(resorted.result().numpy(), outs[1][1])


# --- prompt rewrite -----------------------------------------------------------

def _workflows():
    with open(os.path.join(REPO, "workflows", "distributed-upscale.json"), encoding="utf-8") as fh:
        upscale = json.load(fh)
    seeded = copy.deepcopy(upscale)
    seeded["7"] = {"class_type": "DistributedSeed", "inputs": {"seed": 3}}
    seeded["8"] = {"class_type": "DistributedValue",
                   "inputs": {"value": 20, "overrides": {"_type": "INT", "1": "8", "2": "x"}}}
    seeded["5"]["inputs"]["seed"] = ["7", 0]
    seeded["5"]["inputs"]["steps"] = ["8", 0]
    return [upscale, seeded]


@pytest.mark.parametrize("workflow", _workflows(), ids=["upscale", "seed+value"])
def test_prompt_rewrite_equals_the_jax_packages(workflow):
    assert tprompt.prune_prompt_for_worker(workflow) == jprompt.prune_prompt_for_worker(workflow)
    jindex, tindex = jprompt.PromptIndex(workflow), tprompt.PromptIndex(workflow)
    assert sorted(tprompt.generate_job_id_map(workflow, tindex)) == sorted(
        jprompt.generate_job_id_map(workflow, jindex))
    assert tindex.upstream_closure("5") == jindex.upstream_closure("5")
    job_ids = {"5": "exec_1_abcdef_5"}
    for position in (0, 1):
        args = dict(is_worker=True, worker_index=position, worker_id=f"w{position + 1}",
                    master_url="http://127.0.0.1:8188", job_ids=job_ids,
                    enabled_worker_ids=["w1", "w2"])
        pruned = tprompt.prune_prompt_for_worker(workflow)
        assert tprompt.apply_participant_overrides(pruned, tprompt.ParticipantInfo(**args)) == \
            jprompt.apply_participant_overrides(pruned, jprompt.ParticipantInfo(**args))
    master = dict(is_worker=False, job_ids=job_ids, enabled_worker_ids=["w1"])
    out = tprompt.apply_participant_overrides(workflow, tprompt.ParticipantInfo(**master))
    assert out == jprompt.apply_participant_overrides(workflow, jprompt.ParticipantInfo(**master))
    assert out["5"]["inputs"]["job_id"] == "exec_1_abcdef_5"
    assert out["5"]["inputs"]["is_worker"] is False
    assert workflow["5"]["inputs"].get("job_id") is None  # the input is not mutated


# --- the loops ----------------------------------------------------------------

class ScriptedClient:
    """Replays a fixed tile sequence; records submissions and beats (the
    pattern of tests/graph/test_usdu_elastic.py)."""

    def __init__(self, tile_ids):
        self.tile_ids = list(tile_ids)
        self.submitted = []
        self.flushes = []
        self.heartbeats = 0

    def poll_ready(self):
        return True

    def request_tile(self, batch_max=1):
        if not self.tile_ids:
            return None
        return {"tile_idx": self.tile_ids.pop(0), "estimated_remaining": len(self.tile_ids)}

    def submit_tiles(self, entries, is_final):
        self.submitted.extend(entries)
        self.flushes.append((len(entries), is_final))

    def heartbeat(self):
        self.heartbeats += 1


def _jax_noise(seed):
    """The JAX worker's tile noise: split(fold_in(key(seed), g))[0]."""
    key = jax.random.key(seed)

    def noise(tile_index, shape):
        noise_key, _ = jax.random.split(jax.random.fold_in(key, tile_index))
        return torch.from_numpy(np.array(jax.random.normal(noise_key, shape)))

    return noise


@pytest.fixture(scope="module")
def tiny_pair():
    """(JAX tiny-unet bundle, port bundle on the CPU with the same
    weights, text context), at f32."""
    mp = pytest.MonkeyPatch()
    try:
        for registry in (jreg.MODEL_REGISTRY, treg.MODEL_REGISTRY):
            for name in MODELS:
                entry = dict(registry[name])
                entry["config"] = f32(entry["config"])
                mp.setitem(registry, name, entry)
        unet, vae = jreg.create_model("tiny-unet"), jreg.create_model("tiny-vae")
        te_cfg, vae_cfg = jreg.get_config("tiny-te"), jreg.get_config("tiny-vae")
        params = {
            "unet": seeded_flax_params(unet, 1, jnp.zeros((1, 16, 16, 4)), jnp.zeros((1,)),
                                       jnp.zeros((1, te_cfg.max_length, 64))),
            "vae": seeded_flax_params(vae, 2, jnp.zeros((1, 32, 32, 3))),
        }
        jb = jpl.PipelineBundle(
            model_name="tiny-unet", unet=unet, vae=vae, text_encoder=None, params=params,
            tokenizer=jte.Tokenizer(max_length=te_cfg.max_length, pad_id=te_cfg.pad_token_id),
            latent_channels=vae_cfg.latent_channels, latent_scale=vae_cfg.downscale,
        )
        tb = tpl.load_pipeline("tiny-unet", seed=0, device="cpu")
        for part, module in (("unet", tb.unet), ("vae", tb.vae)):
            module.load_state_dict(from_jax_params(flatten_params(params[part]), module))
        rng = np.random.default_rng(5)
        conds = tuple(rng.standard_normal((1, te_cfg.max_length, 64), dtype=np.float32)
                      for _ in range(2))
        yield jb, tb, conds
    finally:
        mp.undo()


def test_worker_loop_submits_the_jax_loops_tiles(tiny_pair):
    """Same tiles, same order, same entry fields; the decoded pixels differ
    by at most one 8-bit level (f32 summation order on either side)."""
    jb, tb, (pos, neg) = tiny_pair
    img = _image(6, (1, 64, 64, 3))
    args = {k: v for k, v in GEOMETRY.items() if k != "mask_blur"}
    jclient, tclient = ScriptedClient([0, 2, 3]), ScriptedClient([0, 2, 3])
    jax_run_worker_loop(jb, jnp.asarray(img), jnp.asarray(pos), jnp.asarray(neg), job_id="j",
                        worker_id="w1", master_url="", client=jclient, **args)
    run_worker_loop(tb, torch.from_numpy(img), torch.from_numpy(pos), torch.from_numpy(neg),
                    job_id="j", worker_id="w1", master_url="", client=tclient,
                    noise=_jax_noise(SEED), **args)
    assert tclient.heartbeats >= 3 and tclient.flushes[-1][1] is True
    assert len(tclient.submitted) == len(jclient.submitted) == 3
    max_levels = 0
    for jentry, tentry in zip(jclient.submitted, tclient.submitted):
        assert {k: v for k, v in tentry.items() if k != "image"} == \
            {k: v for k, v in jentry.items() if k != "image"}
        levels = np.abs(_levels(tentry) - _levels(jentry))
        max_levels = max(max_levels, int(levels.max()))
    assert max_levels <= 1


def _levels(entry):
    return timg.decode_png_u8(base64.b64decode(entry["image"].partition(",")[2])).astype(int)


def _master_setup(tb, conds, config=None):
    pos, neg = (torch.from_numpy(c) for c in conds)
    store = JobStore()
    server = types.SimpleNamespace(job_store=store)
    context = ExecutionContext(device="cpu", server=server, config=config or {"workers": []})
    return pos, neg, store, context


def _local_tiles(tb, img, pos, neg):
    """Every tile through the port's local processor and default noise."""
    upscaled, grid, extracted = tup.prepare_upscaled_tiles(
        torch.from_numpy(img), GEOMETRY["upscale_by"], GEOMETRY["tile"], GEOMETRY["padding"],
        mask_blur=GEOMETRY["mask_blur"],
    )
    process = _tile_processor(tb, grid, GEOMETRY["steps"], GEOMETRY["sampler"],
                              GEOMETRY["scheduler"], GEOMETRY["cfg"], GEOMETRY["denoise"])
    cond = (tup.prep_cond_for_tiles(pos, grid), tup.prep_cond_for_tiles(neg, grid))
    noise = tup.default_noise(SEED, "cpu")
    tiles = [process(extracted[g], g, noise, *cond, grid.positions[g])
             for g in range(grid.num_tiles)]
    return upscaled, grid, extracted, process, cond, noise, tiles


def test_master_with_a_worker_thread_matches_the_local_tiles(tiny_pair, port_loop, monkeypatch):
    """A thread plays worker w1 on the same store: it pulls first, encodes
    PNG data URLs and submits; the master runs the rest. Under
    CDT_DETERMINISTIC_BLEND=1 the output is within 1/255 of the local
    tiles composited the same way (the worker's tiles pass through 8-bit
    PNG); the local tiles' weighted average is run_upscale's output."""
    monkeypatch.setenv("CDT_DETERMINISTIC_BLEND", "1")
    reset_metrics_registry()
    _, tb, conds = tiny_pair
    img = _image(7, (1, 64, 64, 3))
    pos, neg, store, context = _master_setup(tb, conds)
    upscaled, grid, extracted, process, cond, noise, tiles = _local_tiles(tb, img, pos, neg)
    np.testing.assert_array_equal(
        ttiles.blend_tiles(torch.stack(tiles), grid).numpy(),
        tup.run_upscale(tb, img, pos, neg, **GEOMETRY).numpy(),
    )
    first_pull = threading.Event()
    submitted = []

    def worker():
        while True:
            tile_idx = run_async_in_server_loop(store.pull_task("job1", "w1", timeout=0.5), 30)
            first_pull.set()
            if tile_idx is None:
                return
            arr = process(extracted[tile_idx], tile_idx, noise, *cond, grid.positions[tile_idx])
            payload = [{"batch_idx": i, "image": timg.encode_image_data_url(arr[i])}
                       for i in range(arr.shape[0])]
            run_async_in_server_loop(store.submit_result("job1", "w1", tile_idx, payload), 30)
            submitted.append(tile_idx)

    thread = threading.Thread(target=worker, daemon=True)
    init = store.init_tile_job

    async def init_then_let_the_worker_pull_first(*args, **kwargs):
        job = await init(*args, **kwargs)
        thread.start()
        await asyncio.to_thread(first_pull.wait, 10)
        return job

    monkeypatch.setattr(store, "init_tile_job", init_then_let_the_worker_pull_first)
    out = run_master_elastic(tb, img, pos, neg, job_id="job1", enabled_worker_ids=["w1"],
                             context=context, **GEOMETRY)
    thread.join(timeout=30)
    assert not thread.is_alive()
    record = store.finished["job1"]
    assert sorted(t for t, _ in record["completions"]) == [0, 1, 2, 3]
    assert record["duplicates"] == 0 and submitted and submitted[0] == 0
    assert {who for _, who in record["completions"]} == {"w1", "master"}
    reference = ttiles.DeterministicHostCanvas(upscaled, grid)
    for g, tile in enumerate(tiles):
        reference.blend(tile, *grid.positions[g])
    assert out.shape == (1, 128, 128, 3)
    np.testing.assert_allclose(out.numpy(), reference.result().numpy(), atol=1.0 / 255, rtol=0)
    stages = _stage_seconds("master")
    assert {"pull", "sample", "dispatch", "readback", "decode", "blend"} <= set(stages)
    master_tiles = sum(1 for _, who in record["completions"] if who == "master")
    assert stages["sample"][0] == stages["dispatch"][0] == master_tiles


def test_a_silent_worker_is_requeued_and_the_output_is_bit_equal(tiny_pair, port_loop,
                                                                monkeypatch):
    """w1 pulls tile 0 and is never heard from again. With the heartbeat
    timeout at 0.3 s the master requeues the tile and runs it itself;
    under CDT_DETERMINISTIC_BLEND=1 the image is bit-equal to the
    fault-free run."""
    monkeypatch.setenv("CDT_DETERMINISTIC_BLEND", "1")
    _, tb, conds = tiny_pair
    img = _image(8, (1, 64, 64, 3))
    config = {"workers": [], "settings": {"worker_timeout_seconds": 0.3}}
    pos, neg, store, context = _master_setup(tb, conds, config)
    fault_free = run_master_elastic(tb, img, pos, neg, job_id="clean", enabled_worker_ids=[],
                                    context=context, **GEOMETRY)
    assert [w for _, w in store.finished["clean"]["completions"]] == ["master"] * 4
    init = store.init_tile_job
    stolen = []

    async def init_then_a_worker_pulls_and_dies(*args, **kwargs):
        job = await init(*args, **kwargs)
        stolen.append(await store.pull_task("faulty", "w1", timeout=0.5))
        return job

    monkeypatch.setattr(store, "init_tile_job", init_then_a_worker_pulls_and_dies)
    recovered = run_master_elastic(tb, img, pos, neg, job_id="faulty",
                                   enabled_worker_ids=["w1"], context=context, **GEOMETRY)
    record = store.finished["faulty"]
    assert stolen == [0]
    assert sorted(record["completions"]) == [(0, "master"), (1, "master"), (2, "master"),
                                             (3, "master")]
    assert record["completions"][-1] == (0, "master")  # run after the requeue
    np.testing.assert_array_equal(recovered.numpy(), fault_free.numpy())


@pytest.mark.parametrize("metering", [True, False], ids=["CDT_USAGE=1", "CDT_USAGE=0"])
def test_the_usage_meter_follows_cdt_usage(tiny_pair, port_loop, monkeypatch, metering):
    """A cold and a warm master run (the warm one settles every tile from
    the tile cache) on a fresh meter: with metering on, the meter holds
    the cold run's four dispatches, the warm run's four cached tiles and
    both jobs; with CDT_USAGE=0 it stays untouched."""
    from comfyui_distributed_tpu_torch.cache import store as cstore
    from comfyui_distributed_tpu_torch.telemetry import usage as tusage
    from comfyui_distributed_tpu_torch.utils import constants as tconstants

    monkeypatch.setenv("CDT_DETERMINISTIC_BLEND", "1")
    monkeypatch.setattr(tconstants, "USAGE_ENABLED", metering)
    monkeypatch.setattr(tusage, "_METER", None)
    _, tb, conds = tiny_pair
    img = _image(9, (1, 64, 64, 3))
    pos, neg, store, context = _master_setup(tb, conds)
    previous = cstore.set_tile_cache(cstore.TileResultCache(ram_mb=64, disk_dir=None))
    try:
        for job_id in ("cold", "warm"):
            run_master_elastic(tb, img, pos, neg, job_id=job_id, enabled_worker_ids=[],
                               context=context, **GEOMETRY)
    finally:
        cstore.set_tile_cache(previous)
    assert store.finished["warm"]["cached"] == [0, 1, 2, 3]
    totals, jobs = tusage.get_usage_meter().totals(), tusage.get_usage_meter().rollup()["jobs"]
    assert totals["conserved"]
    if metering:
        assert totals["dispatches"] == 4 and totals["dispatch_chip_ns"] > 0
        assert totals["cached_tiles"] == 4 and set(jobs) == {"cold", "warm"}
    else:
        assert totals["dispatches"] == totals["dispatch_chip_ns"] == 0
        assert totals["cached_tiles"] == 0 and jobs == {}


@pytest.mark.parametrize("threaded", [True, False])
def test_pipeline_releases_unsubmitted_tiles_on_interrupt(threaded):
    """An interrupt between tiles flushes what was encoded and hands the
    rest of the claimed grants back; stage times land in
    cdt_tile_stage_seconds."""
    grants = [[0], [1], [2]]
    released, emitted, flushes = [], [], []

    def sample(idxs):
        return torch.zeros((len(idxs), 1, 2, 2, 3))

    def interrupted():
        if len(emitted) >= 1:
            raise InterruptedError("stop")

    reset_metrics_registry()
    pipeline = TilePipeline(
        pull=lambda: grants.pop(0) if grants else None, sample=sample,
        emit=lambda t, arr: emitted.append(t), flush=flushes.append,
        check_interrupted=interrupted, release=released.extend, threaded=threaded,
        prefetch=False,
    )
    with pytest.raises(InterruptedError):
        pipeline.run()
    assert emitted[0] == 0 and flushes[-1] is True
    assert sorted(set(emitted) | set(released)) == list(range(3 - len(grants)))
    assert not set(emitted) & set(released)
    assert {"pull", "sample", "readback", "encode"} <= set(_stage_seconds("worker"))
    pulled = _stage_seconds("worker")["pull"]
    with stage_span("pull", "worker") as span:
        span.attrs["outcome"] = "empty"  # empty polls are not counted
        time.sleep(0.01)
    with stage_span("submit", "worker", 3) as span:
        assert span.attrs["tile_idx"] == 3
    stages = _stage_seconds("worker")
    assert stages["pull"] == pulled and stages["submit"][0] == 1 and stages["submit"][1] > 0


def _stage_seconds(role: str) -> dict[str, tuple[int, float]]:
    """{stage: (samples, seconds)} of cdt_tile_stage_seconds for `role`."""
    return {stage: (series["count"], series["sum"])
            for (stage, who), series in tinstruments.tile_stage_seconds().series_snapshot().items()
            if who == role}
