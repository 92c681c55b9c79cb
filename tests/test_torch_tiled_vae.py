"""Tiled VAE in the port against the JAX package, on the CPU in f32:
`decode_tiled` and `encode_tiled` on tiny-vae, the USDU path's
`tiled_decode` locally (port `run_upscale` against JAX's), and as a master
with a w1 worker loop in one process on one job store.

The USDU tiles are 96 px (48 latents on tiny-vae's factor 2); both
packages' `decode_tiled` run there at an 8-latent tile with 2 of
overlap, so every tile decodes in pieces (the path's own 64 and 8 would
decode a tiny tile whole).
"""

import asyncio
import functools
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_distributed_tpu.models import pipeline as jpl
from comfyui_distributed_tpu.ops import tiled_vae as jtvae
from comfyui_distributed_tpu.ops import upscale as jup
from comfyui_distributed_tpu_torch.graph import ExecutionContext
from comfyui_distributed_tpu_torch.graph import nodes_core as tcore
from comfyui_distributed_tpu_torch.graph.usdu_elastic import run_master_elastic, run_worker_loop
from comfyui_distributed_tpu_torch.jobs.store import JobStore
from comfyui_distributed_tpu_torch.ops import tiled_vae as ttvae
from comfyui_distributed_tpu_torch.ops import tiles as ttiles
from comfyui_distributed_tpu_torch.ops import upscale as tup
from comfyui_distributed_tpu_torch.utils.async_helpers import run_async_in_server_loop
from test_torch_parity import (  # noqa: F401  (fixtures)
    JaxTileNoise,
    jax_and_port_bundles,
    one_torch_thread,
    port_loop,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def pair():
    return jax_and_port_bundles("tiny-unet")


def _image(seed, shape):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


@pytest.mark.parametrize("hw, tile, overlap", [((20, 24), 8, 2), ((9, 30), 8, 2),
                                               ((12, 12), 16, 4)])
def test_decode_tiled_matches_jax(pair, hw, tile, overlap):
    """Several tiles (and a plane that fits one, decoded whole). Measured
    1.2e-6 on a CPU."""
    jb, tb = pair
    latents = np.random.default_rng(1).standard_normal((1, *hw, 4), dtype=np.float32)
    ref = np.asarray(jtvae.decode_tiled(jpl._Static(jb), jb.params["vae"], jnp.asarray(latents),
                                        tile=tile, overlap=overlap))
    got = ttvae.decode_tiled(tb.vae, torch.from_numpy(latents), tile=tile, overlap=overlap)
    assert got.shape == ref.shape == (1, hw[0] * 2, hw[1] * 2, 3)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=0)
    with torch.no_grad():
        whole = tb.vae.decode(torch.from_numpy(latents))
    if max(hw) <= tile:
        torch.testing.assert_close(got, whole, rtol=0, atol=0)
    else:  # per-tile GroupNorm statistics: close to the whole decode, not equal
        assert 0 < float((got - whole).abs().max()) < 1.0


@pytest.mark.parametrize("hw, tile, overlap", [((40, 48), 16, 4), ((24, 24), 32, 8)])
def test_encode_tiled_matches_jax(pair, hw, tile, overlap):
    jb, tb = pair
    pixels = _image(2, (1, *hw, 3))
    ref = np.asarray(jtvae.encode_tiled(jpl._Static(jb), jb.params["vae"], jnp.asarray(pixels),
                                        tile=tile, overlap=overlap))
    got = ttvae.encode_tiled(tb.vae, torch.from_numpy(pixels), tile=tile, overlap=overlap)
    assert got.shape == ref.shape == (1, hw[0] // 2, hw[1] // 2, 4)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=0)


def test_the_tiled_vae_nodes_match_the_functions(pair):
    _, tb = pair
    latents = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 40, 24, 4),
                                                                       dtype=np.float32))
    (decoded,) = tcore.VAEDecodeTiled().decode_tiled({"samples": latents}, tb, tile_size=64)
    # 64 px / factor 2 → 32-latent tiles, 4 of overlap
    torch.testing.assert_close(decoded, ttvae.decode_tiled(tb.vae, latents, tile=32, overlap=4),
                               rtol=0, atol=0)
    pixels = torch.from_numpy(_image(4, (1, 160, 96, 3)))
    (encoded,) = tcore.VAEEncodeTiled().encode_tiled(pixels, tb, tile_size=64)
    torch.testing.assert_close(encoded["samples"],
                               ttvae.encode_tiled(tb.vae, pixels, tile=64, overlap=16),
                               rtol=0, atol=0)
    (plain,) = tcore.VAEEncode().encode(pixels, tb)
    with torch.no_grad():
        torch.testing.assert_close(plain["samples"], tb.vae.encode(pixels), rtol=0, atol=0)


# --- the USDU path's tiled_decode ------------------------------------------------------------

GEOMETRY = dict(upscale_by=2.0, tile=64, padding=16, steps=2, sampler="euler",
                scheduler="karras", cfg=7.0, denoise=0.35, seed=19, mask_blur=8)


@pytest.fixture
def small_decode_tiles(monkeypatch):
    monkeypatch.setattr(jtvae, "decode_tiled",
                        functools.partial(jtvae.decode_tiled, tile=8, overlap=2))
    monkeypatch.setattr(tup, "decode_tiled",
                        functools.partial(tup.decode_tiled, tile=8, overlap=2))


def _contexts(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, 16, 64), dtype=np.float32) for _ in range(2)]


def test_run_upscale_tiled_decode_matches_jax(pair, small_decode_tiles):
    """64 → 128 px in four tiles, each tile's latents decoded in pieces.
    Tolerance 5e-5 on [0, 1] pixels, as the upscale slice's."""
    jb, tb = pair
    pos, neg = _contexts(5)
    image = _image(6, (1, 64, 64, 3))
    ref = np.asarray(jup.run_upscale(jb, jnp.asarray(image), jnp.asarray(pos), jnp.asarray(neg),
                                     tiled_decode=True, tile_batch=1, **GEOMETRY))
    got = tup.run_upscale(tb, image, torch.from_numpy(pos), torch.from_numpy(neg),
                          tiled_decode=True, noise=JaxTileNoise(GEOMETRY["seed"]), **GEOMETRY)
    whole = tup.run_upscale(tb, image, torch.from_numpy(pos), torch.from_numpy(neg),
                            noise=JaxTileNoise(GEOMETRY["seed"]), **GEOMETRY)
    assert got.shape == ref.shape == (1, 128, 128, 3)
    assert float((got - whole).abs().max()) > 0  # the pieces were decoded apart
    np.testing.assert_allclose(got.numpy(), ref, atol=5e-5, rtol=0)


class StoreClient:
    """The worker loop's client on the master's job store, in process."""

    def __init__(self, store, job_id, worker_id):
        self.store, self.job_id, self.worker_id = store, job_id, worker_id
        self.job_cancelled = False

    def _run(self, coro):
        return run_async_in_server_loop(coro, timeout=30)

    def poll_ready(self):
        return self._run(self.store.wait_for_tile_job(self.job_id, 10.0)) is not None

    def request_tile(self):
        tile = self._run(self.store.pull_task(self.job_id, self.worker_id, timeout=0.5))
        return None if tile is None else {"tile_idx": tile}

    def submit_tiles(self, entries, is_final):
        grouped = {}
        for entry in entries:
            grouped.setdefault(entry["tile_idx"], []).append(
                {"batch_idx": entry["batch_idx"], "image": entry["image"]})
        if grouped:
            self._run(self.store.submit_flush(self.job_id, self.worker_id, grouped))
        if is_final:
            self._run(self.store.mark_worker_done(self.job_id, self.worker_id))

    def heartbeat(self):
        self._run(self.store.heartbeat(self.job_id, self.worker_id))


def test_master_and_w1_with_tiled_decode_match_the_local_tiles(pair, port_loop,
                                                               small_decode_tiles, monkeypatch):
    """A master and w1's worker loop share one store in one process, both
    with tiled_decode: every tile completes once, w1 takes at least one,
    and the output is within 1/255 of the local tiles composited the same
    way (w1's pass through 8-bit PNG)."""
    monkeypatch.setenv("CDT_DETERMINISTIC_BLEND", "1")
    _, tb = pair
    pos, neg = (torch.from_numpy(c) for c in _contexts(7))
    image = _image(8, (1, 64, 64, 3))
    store = JobStore()
    context = ExecutionContext(device="cpu", server=type("S", (), {"job_store": store})(),
                               config={"workers": []})
    geometry = {k: v for k, v in GEOMETRY.items() if k != "mask_blur"}
    errors = []

    def worker():
        try:
            run_worker_loop(tb, image, pos, neg, job_id="tvae", worker_id="w1", master_url="",
                            client=StoreClient(store, "tvae", "w1"), tiled_decode=True,
                            mask_blur=8, **geometry)
        except Exception as exc:  # reported below; the thread must not die silently
            errors.append(exc)

    thread = threading.Thread(target=worker, daemon=True)
    init = store.init_tile_job

    async def init_then_start_w1(*args, **kwargs):
        job = await init(*args, **kwargs)
        thread.start()
        await asyncio.sleep(0.5)  # w1 pulls before the master's first pull
        return job

    monkeypatch.setattr(store, "init_tile_job", init_then_start_w1)
    out = run_master_elastic(tb, image, pos, neg, job_id="tvae", enabled_worker_ids=["w1"],
                             context=context, tiled_decode=True, **GEOMETRY)
    thread.join(timeout=60)
    assert not thread.is_alive() and not errors, errors
    record = store.finished["tvae"]
    assert sorted(t for t, _ in record["completions"]) == [0, 1, 2, 3]
    assert "w1" in {who for _, who in record["completions"]}
    upscaled, grid, extracted = tup.prepare_upscaled_tiles(torch.from_numpy(image), 2.0, 64, 16,
                                                           mask_blur=8)
    process = tup._process_tile_fn(tb, grid, 2, "euler", "karras", 7.0, 0.35, tiled_decode=True)
    noise = tup.default_noise(GEOMETRY["seed"], "cpu")
    conds = (tup.prep_cond_for_tiles(pos, grid), tup.prep_cond_for_tiles(neg, grid))
    reference = ttiles.DeterministicHostCanvas(upscaled, grid)
    with torch.no_grad():
        for g, (y, x) in enumerate(grid.positions):
            reference.blend(process(extracted[g], g, noise, *conds, (y, x)), y, x)
    np.testing.assert_allclose(out.numpy(), reference.result().numpy(), atol=1.0 / 255, rtol=0)
