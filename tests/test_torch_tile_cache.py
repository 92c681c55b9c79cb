"""The port's content-addressed tile cache (cache/).

- keys: the directions of the JAX package's tests/test_cache_keys.py,
  in the port's namespace: every output-affecting field flips the key,
  nothing else does (job id, tenant, placement are no fields); the RNG
  field is the port's noise identity (the seed of TileNoise);
- the weights fingerprint remembered per parameter is byte-equal to the
  one computed afresh, is computed afresh after a write in place or a
  parameter swapped, and hashes only the tensors a view or patch does
  not share; the port's patches (LoRA, adapters, merges) write no
  bundle in place;
- the store: RAM LRU by bytes, the disk tier's CRC (a corrupt, truncated
  or alien file is deleted and reads as a miss), a RAM-evicted entry
  served from disk;
- the elastic master: a warm run settles every tile at the job's
  creation, calls no sampler, patches no backbone and returns the cold
  run's canvas bit for bit; another job id with the same inputs hits
  too; another adapter strength, or the base model, misses.
"""

import dataclasses
import os
import types

import numpy as np
import pytest
import torch

from comfyui_distributed_tpu_torch.adapters import registry as areg
from comfyui_distributed_tpu_torch.cache import keys as ck
from comfyui_distributed_tpu_torch.cache import store as cstore
from comfyui_distributed_tpu_torch.cache.keys import (
    JobKeyContext,
    adapter_fingerprint,
    bundle_fingerprint,
    cond_fingerprint,
    noise_identity,
    params_fingerprint,
    tile_key,
)
from comfyui_distributed_tpu_torch.graph import ExecutionContext
from comfyui_distributed_tpu_torch.graph import usdu_elastic
from comfyui_distributed_tpu_torch.jobs import JobStore
from comfyui_distributed_tpu_torch.models import pipeline as tpl
from comfyui_distributed_tpu_torch.models.lora import lora_target_map
from comfyui_distributed_tpu_torch.models.registry import get_config
from comfyui_distributed_tpu_torch.ops import upscale as tup

from test_torch_lora import seeded_lora
from test_torch_parity import one_torch_thread, port_loop  # noqa: F401  (fixtures)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _tile(shape=(8, 8, 3), dtype=np.float32):
    return np.linspace(0.0, 1.0, int(np.prod(shape)), dtype=np.float64).reshape(shape) \
        .astype(dtype)


class _Tiny(torch.nn.Module):
    def __init__(self, scale=1.0, name="w"):
        super().__init__()
        self.register_parameter(name, torch.nn.Parameter(torch.full((4, 4), scale)))


def _ctx(**overrides) -> JobKeyContext:
    base = dict(
        weights_fp=params_fingerprint(_Tiny()),
        cond_fp=cond_fingerprint(torch.ones(4), torch.zeros(4)),
        base_key=noise_identity(tup.TileNoise(7, "cpu")), steps=4, sampler="euler",
        scheduler="normal", cfg=7.0, denoise=0.5, adapter_fp="", upscale_by=2.0,
        upscale_method="lanczos", mask_blur=8, uniform=False, tiled_decode=False,
        tile_w=512, tile_h=512, padding=32, grid_w=1024, grid_h=1024, num_tiles=4,
    )
    base.update(overrides)
    return JobKeyContext(**base)


BASE_TILE = _tile()


def _key(ctx=None, tile=None, tile_idx=0, y=0, x=0):
    return tile_key(ctx or _ctx(), tile_idx, BASE_TILE if tile is None else tile, y, x)


def test_same_inputs_same_key_and_seeds_shared_across_jobs():
    assert _key() == _key() == _key(_ctx())
    # the noise of a seed is the same whichever job asks: no job id field
    assert noise_identity(tup.TileNoise(7, "cpu")) == noise_identity(tup.TileNoise(7, "cuda"))
    assert _key(_ctx(cfg=7)) == _key(_ctx(cfg=7.0))
    assert _key(tile=torch.from_numpy(BASE_TILE)) == _key()


PERTURBATIONS = [
    ("weights_fp", params_fingerprint(_Tiny(scale=1.0000001))),
    ("cond_fp", cond_fingerprint(torch.ones(4) * 2, torch.zeros(4))),
    ("base_key", noise_identity(tup.TileNoise(8, "cpu"))),
    ("steps", 5), ("sampler", "euler_a"), ("scheduler", "karras"), ("cfg", 7.5),
    ("denoise", 0.51), ("adapter_fp", adapter_fingerprint((("aa" * 16, 1.0),))),
    ("upscale_by", 2.5), ("upscale_method", "bicubic"), ("mask_blur", 9), ("uniform", True),
    ("tiled_decode", True), ("tile_w", 256), ("tile_h", 256), ("padding", 16),
    ("grid_w", 2048), ("grid_h", 2048), ("num_tiles", 8),
]


@pytest.mark.parametrize("field, value", PERTURBATIONS, ids=[f for f, _ in PERTURBATIONS])
def test_each_context_field_changes_the_key(field, value):
    base = _ctx()
    assert getattr(base, field) != value
    assert _key(base) != _key(_ctx(**{field: value}))


def test_every_context_field_is_covered():
    assert {f for f, _ in PERTURBATIONS} == {f.name for f in dataclasses.fields(JobKeyContext)}


def test_per_tile_fields_dtype_shape_and_version_change_the_key(monkeypatch):
    bumped = BASE_TILE.copy()
    bumped[0, 0, 0] += np.float32(1.0 / 255.0)
    assert _key(tile=bumped) != _key()
    assert _key(tile=BASE_TILE.astype(np.float64)) != _key()
    z32, zi32 = np.zeros(16, np.float32), np.zeros(16, np.int32)
    assert _key(tile=z32) != _key(tile=zi32)
    assert _key(tile=BASE_TILE.reshape(-1)) != _key()
    assert _key(tile=torch.from_numpy(BASE_TILE).bfloat16()) != _key()
    assert _key(tile_idx=1) != _key() and _key(y=512) != _key() and _key(x=512) != _key()
    assert _key(_ctx(sampler="eu", scheduler="ler")) != _key(_ctx(sampler="eule",
                                                                  scheduler="r"))
    before = _key()
    monkeypatch.setattr(ck, "KEY_VERSION", ck.KEY_VERSION + "x")
    assert _key() != before


def test_fingerprints_see_drift_renames_dtypes_sides_and_plans():
    drifted = _Tiny()
    with torch.no_grad():
        drifted.w[0, 0] += 1e-7
    assert params_fingerprint(drifted) != params_fingerprint(_Tiny())
    assert params_fingerprint(_Tiny(name="w2")) != params_fingerprint(_Tiny())
    assert params_fingerprint(_Tiny().to(torch.float64)) != params_fingerprint(_Tiny())
    a, b = torch.ones(4), torch.zeros(4)
    assert cond_fingerprint(a, b) != cond_fingerprint(b, a)
    assert adapter_fingerprint(None) == adapter_fingerprint(()) == ""
    plan = (("aa" * 16, 1.0), ("bb" * 16, 1.0))
    assert adapter_fingerprint(plan) == adapter_fingerprint(tuple(plan))
    assert adapter_fingerprint(plan) != adapter_fingerprint(plan[::-1])
    assert adapter_fingerprint(plan) != adapter_fingerprint((("aa" * 16, 1.25), plan[1]))
    # noise the key cannot name takes no part in the cache
    assert noise_identity(lambda index, shape: torch.zeros(shape)) is None
    assert noise_identity(tup.FrameTileNoise(7, 1, "cpu")) != noise_identity(
        tup.FrameTileNoise(7, 2, "cpu"))


@pytest.fixture(scope="module")
def sd15():
    bundle = tpl.load_pipeline("tiny-unet", seed=0, device="cpu")
    with torch.no_grad():  # a non-zero out_conv, so the UNet's output counts
        weight = bundle.unet.out_conv.weight
        weight.copy_(torch.randn(weight.shape, generator=torch.Generator().manual_seed(0)) * 0.1)
    return bundle


def test_the_bundle_fingerprint_covers_weights_and_sampling_patches(sd15):
    base = bundle_fingerprint(sd15)
    assert bundle_fingerprint(sd15) == base
    for patched in (dataclasses.replace(sd15, unet=sd15.unet.with_freeu((1.1, 1.2, 0.9, 0.2,
                                                                           False))),
                    dataclasses.replace(sd15, pag=tpl.PAGSpec(scale=3.0)),
                    dataclasses.replace(sd15, cfg_rescale=0.7),
                    dataclasses.replace(sd15, parameterization_override="v"),
                    dataclasses.replace(sd15, model_name="tiny-unet-v")):
        assert bundle_fingerprint(patched) != base
    # the text towers take no part: the conditioning is keyed instead
    assert bundle_fingerprint(dataclasses.replace(sd15, text_encoder=None)) == base


def test_the_remembered_fingerprint_is_the_fresh_one_and_follows_writes(sd15, monkeypatch):
    """Memo on and off give the same bytes; a write in place, or a
    parameter swapped for another tensor, makes it compute afresh; under
    inference mode (no write counter) it is remembered by object and
    address; a view or copy sharing parameters (FreeU's view, a LoRA
    patch's untouched weights) hashes only the tensors it does not share;
    the port's patches leave the bundle as it was."""
    module = tpl.load_pipeline("tiny-unet", seed=3, device="cpu").unet
    fresh = params_fingerprint(module, memo=False)
    assert params_fingerprint(module) == fresh == params_fingerprint(module)
    hashed = []
    digest = ck._param_digest
    monkeypatch.setattr(ck, "_param_digest", lambda p: hashed.append(p) or digest(p))
    view = module.with_freeu((1.1, 1.2, 0.9, 0.2, False))
    assert view is not module and params_fingerprint(view) == fresh and not hashed
    monkeypatch.setattr(ck, "_param_digest", digest)
    with torch.no_grad():
        module.out_conv.bias.add_(1.0)
    assert params_fingerprint(module) == params_fingerprint(module, memo=False) != fresh
    module.out_conv.bias = torch.nn.Parameter(torch.zeros_like(module.out_conv.bias))
    assert params_fingerprint(module) == params_fingerprint(module, memo=False)
    with torch.inference_mode():
        made = torch.nn.Linear(4, 4)
        assert params_fingerprint(made) == params_fingerprint(made, memo=False)
    from comfyui_distributed_tpu_torch.adapters import segmented
    from comfyui_distributed_tpu_torch.graph.nodes_loaders import ModelMergeSimple

    before = bundle_fingerprint(sd15, memo=False)
    targets = segmented.bundle_target_map(sd15)
    shapes = {n: (shape[1], shape[0]) for n, (_, shape) in targets.items()}
    ops = segmented.build_operands(seeded_lora(shapes, shapes, seed=1), targets)
    bundle_fingerprint(sd15)
    patched = segmented.patch_params(sd15, ops, scale=0.8)
    hashed = []
    monkeypatch.setattr(ck, "_param_digest", lambda p: hashed.append(p) or digest(p))
    bundle_fingerprint(patched)
    new = {id(p) for p in patched.unet.parameters()} - {id(p) for p in sd15.unet.parameters()}
    assert 0 < len(hashed) == len(new) == len(ops.paths)
    monkeypatch.setattr(ck, "_param_digest", digest)
    (merged,) = ModelMergeSimple().merge(sd15, patched, 0.5)
    assert bundle_fingerprint(patched) != before and bundle_fingerprint(merged) != before
    assert bundle_fingerprint(sd15) == bundle_fingerprint(sd15, memo=False) == before


# --- the store ------------------------------------------------------------------


def test_the_ram_tier_is_an_lru_by_bytes():
    arr = np.zeros((16, 16), np.float32)  # 1 KiB
    cache = cstore.TileResultCache(ram_mb=2.5 / 1024, disk_dir=None)
    for key in "abc":
        cache.put(key, arr + ord(key))
    assert cache.get("a") is None  # evicted: two fit
    assert cache.get("b") is not None
    cache.put("d", arr)  # evicts c, the least recently used
    assert cache.get("c") is None and cache.get("b") is not None
    hit = cache.get("d")
    assert not hit.flags.writeable
    stats = cache.stats()
    assert stats["evictions"] == 2 and stats["misses"] == 2 and stats["hits"] == 3


@pytest.mark.parametrize("damage", ["flip a pixel byte", "truncate", "alien magic"])
def test_a_corrupt_disk_entry_is_deleted_and_reads_as_a_miss(tmp_path, damage):
    arr = np.arange(48, dtype=np.float32).reshape(4, 4, 3)
    cache = cstore.TileResultCache(ram_mb=0, disk_dir=str(tmp_path))
    cache.put("k" * 64, arr)
    path = cache._disk_path("k" * 64)
    np.testing.assert_array_equal(cache.get("k" * 64), arr)  # disk hit (no RAM tier)
    blob = bytearray(open(path, "rb").read())
    if damage == "flip a pixel byte":
        blob[-1] ^= 0x01
    elif damage == "truncate":
        blob = blob[:-7]
    else:
        blob[:4] = b"XXXX"
    open(path, "wb").write(bytes(blob))
    assert cache.get("k" * 64) is None
    assert not os.path.exists(path)
    stats = cache.stats()
    assert stats["corrupt"] == 1 and stats["hits_disk"] == 1 and stats["misses"] == 1


def test_a_ram_evicted_entry_is_served_from_disk_and_promoted(tmp_path):
    arr = np.ones((16, 16), np.float32)
    cache = cstore.TileResultCache(ram_mb=1.5 / 1024, disk_dir=str(tmp_path))
    cache.put("a" * 64, arr)
    cache.put("b" * 64, arr * 2)  # evicts a from RAM
    np.testing.assert_array_equal(cache.get("a" * 64), arr)
    assert cache.stats()["hits_disk"] == 1
    np.testing.assert_array_equal(cache.get("a" * 64), arr)
    assert cache.stats()["hits_ram"] == 1
    reopened = cstore.TileResultCache(ram_mb=1, disk_dir=str(tmp_path))
    assert reopened.stats()["disk_bytes"] > 0
    np.testing.assert_array_equal(reopened.get("b" * 64), arr * 2)


def test_the_global_cache_follows_the_knob(monkeypatch, tmp_path):
    previous = cstore.set_tile_cache(None)
    try:
        monkeypatch.setenv("CDT_CACHE", "0")
        assert cstore.get_tile_cache() is None
        monkeypatch.setenv("CDT_CACHE", "1")
        monkeypatch.setenv("CDT_CACHE_DIR", str(tmp_path / "tiles"))
        made = cstore.get_tile_cache()
        assert made is cstore.get_tile_cache() and made.stats()["disk_tier"]
    finally:
        cstore.set_tile_cache(previous)


# --- the elastic master ------------------------------------------------------------

GEOMETRY = dict(upscale_by=2.0, tile=64, padding=16, steps=1, sampler="euler",
                scheduler="karras", cfg=3.0, denoise=0.3, seed=4, mask_blur=8)


def test_a_warm_elastic_run_settles_every_tile_without_sampling(sd15, port_loop, monkeypatch,
                                                                tmp_path):
    monkeypatch.setenv("CDT_DETERMINISTIC_BLEND", "1")
    previous = cstore.set_tile_cache(cstore.TileResultCache(ram_mb=64, disk_dir=str(tmp_path)))
    catalog = areg.AdapterCatalog()
    previous_catalog = areg.set_adapter_catalog(catalog)
    calls = []
    real = usdu_elastic._tile_processor

    def counting(*args, **kwargs):
        process = real(*args, **kwargs)

        def fn(*a):
            calls.append(a[1])
            return process(*a)

        return fn

    monkeypatch.setattr(usdu_elastic, "_tile_processor", counting)
    try:
        rng = np.random.default_rng(2)
        img = rng.random((1, 64, 64, 3), dtype=np.float32)
        pos, neg = (torch.from_numpy(rng.standard_normal((1, 16, 64), dtype=np.float32))
                    for _ in range(2))
        store = JobStore()
        context = ExecutionContext(device="cpu", server=types.SimpleNamespace(job_store=store),
                                   config={"workers": []})
        targets = lora_target_map(get_config("tiny-unet"))
        params = dict(sd15.unet.named_parameters())
        shapes = {n: tuple(params[p].shape) for n, (part, p) in targets.items()
                  if part == "unet"}
        catalog.register_memory("style", seeded_lora(shapes, shapes, seed=5))

        def run(job_id, adapters=None):
            if adapters:
                store.note_job_adapters(job_id, areg.specs_to_wire(catalog.resolve(
                    areg.parse_adapter_specs(adapters))))
            calls.clear()
            context.extras.pop("adapters", None)
            out = usdu_elastic.run_master_elastic(sd15, img, pos, neg, job_id=job_id,
                                                  enabled_worker_ids=[], context=context,
                                                  **GEOMETRY)
            patched.append("adapters" in context.extras)
            return out, list(calls), store.finished[job_id]["cached"]

        patched = []

        style = [{"name": "style", "strength": 0.8}]
        cold, cold_calls, cold_cached = run("cold", style)
        assert sorted(cold_calls) == [0, 1, 2, 3] and cold_cached == []
        warm, warm_calls, warm_cached = run("warm", style)
        assert warm_calls == [] and warm_cached == [0, 1, 2, 3]
        assert torch.equal(warm, cold)
        assert store.finished["warm"]["completions"] == []
        _, other_calls, other_cached = run("other", [{"name": "style", "strength": 0.7}])
        assert sorted(other_calls) == [0, 1, 2, 3] and other_cached == []
        base, base_calls, base_cached = run("base")
        assert sorted(base_calls) == [0, 1, 2, 3] and base_cached == []
        assert float((base - cold).abs().max()) > 1.0 / 255
        # the backbone is patched only where a tile is sampled
        assert patched == [True, False, True, False]
        stats = cstore.get_tile_cache().stats()
        assert stats["settled"] == 4 and stats["puts"] == 12
        assert set(context.extras["tile_cache"]) == {"weights_fingerprint_s", "keys_s"}
    finally:
        cstore.set_tile_cache(previous)
        areg.set_adapter_catalog(previous_catalog)


def test_a_job_that_exists_settles_only_what_no_worker_completed(port_loop):
    """settle_cached on a job a worker already took a tile of: that tile
    stays the worker's, the rest settle and leave the pull set."""
    import asyncio

    async def run():
        store = JobStore()
        await store.init_tile_job("j", [0, 1, 2, 3])
        tid = await store.pull_task("j", "w1", timeout=0.1)
        await store.submit_result("j", "w1", tid, [])
        settled = await store.settle_cached("j", [0, 1, 2])
        pending = await store.remaining("j")
        return tid, settled, pending, await store.cached_tiles("j"), \
            await store.is_complete("j")

    tid, settled, pending, cached, complete = asyncio.run(run())
    assert tid == 0 and settled == [1, 2] and cached == [1, 2] and pending == 1
    assert not complete
