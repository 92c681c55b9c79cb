"""Inpainting in the port against the JAX package, on the CPU in f32.

- `_mask_to_latent`: the mask brought to latent resolution with
  jax.image.resize's antialiased linear weights, at 512 → 64, at odd
  sizes both ways and in each MASK layout.
- VAEEncodeForInpaint's gray fill (the un-grown hard mask) and its
  dilation at grow_mask_by 0, 1, 5 and 6 (even g reaches one pixel
  further toward -y/-x), with an identity "VAE" so the pixel-resolution
  masks are compared exactly.
- `masked_inpaint_model`: the pin of the unmasked region.
- `workflows/distributed-inpaint.json`, unmodified but for the
  checkpoint (tiny-unet) and a 32-px input.png with a transparent
  square, through both packages' GraphExecutors; and in the port, the
  sampled latent equals the encoded one exactly where the mask is 0.

Tolerances: the masks are exact up to the resize's f32 products (1e-6);
the workflow's images as in tests/test_torch_txt2img.py, a margin of
about ten over the difference measured on a CPU.
"""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_distributed_tpu.graph import nodes_core as jnodes
from comfyui_distributed_tpu.ops import samplers as jsmp
from comfyui_distributed_tpu_torch.graph import ExecutionContext, GraphExecutor
from comfyui_distributed_tpu_torch.graph import nodes_core as tnodes
from comfyui_distributed_tpu_torch.models import pipeline as tpl
from comfyui_distributed_tpu_torch.ops import samplers as tsmp
from comfyui_distributed_tpu_torch.utils import image as timg
from test_torch_parity import (  # noqa: F401  (one_torch_thread: fixture)
    jax_and_port_bundles,
    one_torch_thread,
    run_workflow_in_both,
)

# one intra-op thread: the tiny models gain nothing from more, and the
# xdist run's processes would oversubscribe the cores
pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _square_mask(h, w, seed):
    rng = np.random.default_rng(seed)
    mask = (rng.random((h, w)) > 0.97).astype(np.float32)  # scattered pixels
    mask[h // 4: h // 2 + 3, w // 3: w // 2 + 5] = 1.0  # and a block
    return mask


@pytest.mark.parametrize("src, dst", [((512, 512), (64, 64)), ((37, 53), (5, 7)),
                                      ((24, 40), (3, 5)), ((4, 6), (9, 13)), ((8, 8), (8, 8))])
@pytest.mark.parametrize("layout", ["hw", "bhw", "bhw1"])
def test_mask_to_latent_matches_jax(src, dst, layout):
    mask = np.stack([_square_mask(*src, 1), _square_mask(*src, 2) * 0.7])
    mask = {"hw": mask[0], "bhw": mask, "bhw1": mask[..., None]}[layout]
    ref = np.asarray(jnodes._mask_to_latent(jnp.asarray(mask), *dst))
    got = tnodes._mask_to_latent(torch.from_numpy(mask), *dst).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_the_latent_mask_is_jax_image_resize_at_the_border():
    """512 → 64 antialiases with a triangle 8 pixels wide: a mask that
    is 1 only on the border rows shows the edge weights."""
    mask = np.zeros((1, 512, 512), np.float32)
    mask[:, :3] = 1.0
    mask[:, :, -5:] = 1.0
    ref = np.asarray(jax.image.resize(jnp.asarray(mask), (1, 64, 64), "linear"))
    got = tnodes._mask_to_latent(torch.from_numpy(mask), 64, 64)[..., 0].numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    assert 0.0 < got[0, 0, 10] < 1.0 and 0.0 < got[0, 10, -1] < 1.0


def _identity_vae(package):
    """A VAE stand-in whose encode is the identity: the node's output
    latent is then its gray-filled pixels, its noise mask the grown mask
    at pixel resolution."""
    if package == "jax":
        return types.SimpleNamespace(vae=types.SimpleNamespace(
            apply=lambda params, x, method: x), params={"vae": None})
    return types.SimpleNamespace(vae=types.SimpleNamespace(encode=lambda x: x),
                                 device=torch.device("cpu"))


@pytest.mark.parametrize("grow", [0, 1, 5, 6])
def test_gray_fill_and_dilation_match_jax(grow):
    rng = np.random.default_rng(grow)
    pixels = rng.random((1, 24, 40, 3), dtype=np.float32)
    mask = _square_mask(24, 40, 3)
    mask[0, 0] = mask[-1, -1] = mask[5, -1] = 1.0  # the borders clip the window
    mask[10, 2] = 0.6  # above 0.5: hard
    (ref,) = jnodes.VAEEncodeForInpaint().encode(jnp.asarray(pixels), _identity_vae("jax"),
                                                  jnp.asarray(mask), grow_mask_by=grow)
    (got,) = tnodes.VAEEncodeForInpaint().encode(torch.from_numpy(pixels),
                                                  _identity_vae("torch"),
                                                  torch.from_numpy(mask), grow_mask_by=grow)
    np.testing.assert_array_equal(got["noise_mask"].numpy(), np.asarray(ref["noise_mask"]))
    np.testing.assert_array_equal(got["samples"].numpy(), np.asarray(ref["samples"]))
    assert (got["width"], got["height"]) == (ref["width"], ref["height"]) == (40, 24)
    hard = mask > 0.5
    grown = got["noise_mask"].numpy()[0, ..., 0]
    assert grown.sum() >= hard.sum() + (grow > 1)
    # gray where the un-grown mask is, the pixels elsewhere
    np.testing.assert_array_equal(got["samples"].numpy()[0][hard], 0.5)
    np.testing.assert_array_equal(got["samples"].numpy()[0][~hard], pixels[0][~hard])


def test_even_growth_reaches_further_toward_the_origin():
    hard = torch.zeros((1, 9, 9))
    hard[0, 4, 4] = 1.0
    grown = tnodes.grow_mask(hard, 6)[0]
    rows = torch.nonzero(grown.any(dim=1)).flatten().tolist()
    assert rows == [2, 3, 4, 5, 6, 7]  # i - 2 .. i + 3 around row 4


def test_masked_inpaint_model_matches_jax():
    rng = np.random.default_rng(5)
    x, latents, noise = (rng.standard_normal((2, 4, 4, 3), dtype=np.float32)
                         for _ in range(3))
    mask = (rng.random((2, 4, 4, 1)) > 0.5).astype(np.float32)
    sigma = np.asarray([3.0, 0.5], np.float32)

    def model(x, sigma, cond):
        return x * 0.3 + cond

    ref = jsmp.masked_inpaint_model(model, "eps", jnp.asarray(latents), jnp.asarray(noise),
                                    jnp.asarray(mask))(jnp.asarray(x), jnp.asarray(sigma), 1.0)
    got = tsmp.masked_inpaint_model(model, "eps", torch.from_numpy(latents),
                                    torch.from_numpy(noise), torch.from_numpy(mask))(
        torch.from_numpy(x), torch.from_numpy(sigma), 1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def pair():
    return jax_and_port_bundles("tiny-unet")


def _inpaint_workflow(tmp_path, monkeypatch):
    rgba = np.random.default_rng(0).random((32, 32, 4)).astype(np.float32)
    rgba[..., 3] = 1.0
    rgba[8:24, 10:26, 3] = 0.0  # transparent: regenerate
    (tmp_path / "input.png").write_bytes(timg.encode_png(rgba))
    monkeypatch.setenv("CDT_INPUT_DIR", str(tmp_path))
    with open(os.path.join(REPO, "workflows", "distributed-inpaint.json"),
              encoding="utf-8") as fh:
        workflow = json.load(fh)
    workflow["1"]["inputs"]["ckpt_name"] = "tiny-unet"
    return workflow


def test_inpaint_workflow_matches_the_jax_executor(pair, tmp_path, monkeypatch):
    jb, tb = pair
    ref, got = run_workflow_in_both(_inpaint_workflow(tmp_path, monkeypatch), jb, tb,
                                    monkeypatch)
    assert got.shape == ref.shape == (1, 32, 32, 3)
    assert got.std() > 0.01
    np.testing.assert_allclose(got, ref, atol=4e-5, rtol=0)  # measured 4.1e-6


def test_sampling_keeps_the_encoded_latent_outside_the_mask(pair, tmp_path, monkeypatch):
    _, tb = pair
    workflow = _inpaint_workflow(tmp_path, monkeypatch)
    del workflow["10"]
    executor = GraphExecutor(ExecutionContext(device="cpu", pipelines={"tiny-unet": tb}))
    executor.execute(workflow)
    encoded, sampled = executor.last_results["5"][0], executor.last_results["7"][0]
    keep = encoded["noise_mask"][..., 0] == 0.0
    assert 0 < int(keep.sum()) < keep.numel()
    assert torch.equal(sampled["samples"][keep], encoded["samples"][keep])
    assert not torch.allclose(sampled["samples"][~keep], encoded["samples"][~keep], atol=0.1)
    assert sampled["noise_mask"] is encoded["noise_mask"]  # carried forward


def test_a_changed_input_png_keeps_the_cached_encode_in_both_packages(pair, tmp_path,
                                                                     monkeypatch):
    """A reference-side defect the port mirrors (ROADMAP Queue 3): LoadImage
    re-runs on every execution (NEVER_CACHE), but its content key is its
    literal file name, so the VAEEncodeForInpaint below it keeps its
    cached latent after input.png has changed, in both executors."""
    from comfyui_distributed_tpu.graph import executor as jexec

    jb, tb = pair
    monkeypatch.setenv("CDT_INPUT_DIR", str(tmp_path))
    prompt = {
        "1": {"class_type": "CheckpointLoaderSimple", "inputs": {"ckpt_name": "tiny-unet"}},
        "2": {"class_type": "LoadImage", "inputs": {"image": "input.png"}},
        "5": {"class_type": "VAEEncodeForInpaint", "inputs": {
            "pixels": ["2", 0], "vae": ["1", 2], "mask": ["2", 1], "grow_mask_by": 6}},
    }
    jctx = jexec.ExecutionContext(pipelines={"tiny-unet": jb})
    tctx = ExecutionContext(device="cpu", pipelines={"tiny-unet": tb})
    encoded = []
    for seed in (0, 1):
        rgba = np.random.default_rng(seed).random((32, 32, 4)).astype(np.float32)
        rgba[8:24, 8:24, 3] = 0.0
        (tmp_path / "input.png").write_bytes(timg.encode_png(rgba))
        jexec.GraphExecutor(jctx).execute(prompt)
        GraphExecutor(tctx).execute(prompt)
        encoded.append((jctx.extras["node_cache"]["5"][1][0]["samples"],
                        tctx.extras["node_cache"]["5"][1][0]["samples"]))
    assert encoded[1][0] is encoded[0][0] and encoded[1][1] is encoded[0][1]
