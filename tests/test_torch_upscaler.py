"""The upscale model in the port against the JAX package, on the CPU in f32:
`SuperResolver`, ImageUpscaleWithModel, the USDU node's `upscale_model`
branch with its antialiased cubic downsampling, and the whole USDU graph
as people build it (upscale model, ControlNet tile on both sides,
CLIPTextEncodeSDXL, tiled decode) through both packages' GraphExecutors.

The models carry the same numpy-seeded weights (`from_jax_params`), the
output convs (the upscaler's `tail`, the ControlNet's `conv_out`, the
UNet's `out_conv`) non-zero: a fresh upscaler is exactly a linear resize
and a fresh ControlNet adds zero, so the comparisons would hold for
models that ignore their input.
"""

import copy
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_distributed_tpu.graph import executor as jexec
from comfyui_distributed_tpu.graph import nodes_core as jcore
from comfyui_distributed_tpu.ops import tiled_vae as jtvae
from comfyui_distributed_tpu_torch.graph import ExecutionContext, GraphExecutor
from comfyui_distributed_tpu_torch.graph import nodes_core as tcore
from comfyui_distributed_tpu_torch.graph import nodes_upscale as tnodes
from comfyui_distributed_tpu_torch.models import upscaler as tupm
from comfyui_distributed_tpu_torch.ops import upscale as tup
from comfyui_distributed_tpu_torch.ops.resize import resize_image
from test_torch_parity import (  # noqa: F401  (one_torch_thread: fixture)
    JaxTileNoise,
    controlnet_pair,
    jax_and_port_bundles,
    one_torch_thread,
    upscaler_pair,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def models():
    return upscaler_pair()


def _image(seed, shape):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


@pytest.mark.parametrize("name, shape", [("4x-generic", (1, 12, 10, 3)),
                                         ("2x-detail", (2, 9, 16, 3))])
def test_super_resolver_matches_flax(name, shape):
    """Its pixel shuffle's row/column order is the JAX package's
    (b, h, w, sy, sx, c), not F.pixel_shuffle's."""
    jm, tm = upscaler_pair(name)
    image = _image(1, shape)
    ref = np.asarray(jax.jit(jm.upscale)(jnp.asarray(image)))
    with torch.no_grad():
        got = tm.upscale(torch.from_numpy(image)).numpy()
    s = tm.scale
    assert got.shape == ref.shape == (shape[0], shape[1] * s, shape[2] * s, 3)
    linear = resize_image(torch.from_numpy(image), shape[1] * s, shape[2] * s, "bilinear")
    assert np.abs(got - linear.clamp(0, 1).numpy()).max() > 0.05  # the residual counts
    # measured 4.8e-7 on a CPU
    np.testing.assert_allclose(got, ref, atol=5e-6, rtol=0)


def test_a_fresh_upscaler_is_the_linear_resize_and_is_seeded_by_name():
    a = tupm.load_upscale_model("4x-generic", device="cpu")
    b = tupm.load_upscale_model("4x-generic", device="cpu")
    c = tupm.load_upscale_model("2x-other", device="cpu")
    assert (a.scale, c.scale, tupm.scale_of("esrgan")) == (4, 2, 4)
    assert torch.equal(a.module.head.weight, b.module.head.weight)
    assert not torch.equal(a.module.head.weight, c.module.head.weight)
    image = torch.from_numpy(_image(2, (1, 8, 8, 3)))
    with torch.no_grad():
        out = a.upscale(image)
    torch.testing.assert_close(out, resize_image(image, 32, 32, "bilinear").clamp(0, 1),
                               rtol=0, atol=0)


def test_image_upscale_with_model_node_matches_jax(models):
    jm, tm = models
    image = _image(3, (1, 8, 12, 3))
    (ref,) = jcore.ImageUpscaleWithModel().upscale(jm, jnp.asarray(image))
    (got,) = tcore.ImageUpscaleWithModel().upscale(tm, torch.from_numpy(image))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-6, rtol=0)


def test_the_loader_caches_under_the_jax_key():
    context = ExecutionContext(device="cpu")
    (model,) = tcore.UpscaleModelLoader().load("2x-small", context=context)
    assert context.pipelines["upscaler:2x-small"] is model and model.scale == 2
    assert tcore.UpscaleModelLoader().load("2x-small", context=context)[0] is model


@pytest.mark.parametrize("src, dst", [((2048, 24), (1024, 12)), ((300, 200), (128, 96)),
                                      ((96, 80), (40, 56))])
def test_the_cubic_downsampling_is_jax_image_resizes(src, dst):
    """jax.image.resize antialiases when it shrinks (Keys a = -0.5 widened
    by the factor, renormalised at the edges): 2048 → 1024 on the path,
    and non-integer ratios. Weights in f64 here and f32 in JAX: measured
    6e-7."""
    image = _image(4, (1, *src, 3))
    ref = np.asarray(jax.image.resize(jnp.asarray(image), (1, *dst, 3), method="cubic"))
    got = resize_image(torch.from_numpy(image), *dst, "bicubic").numpy()
    np.testing.assert_allclose(got, ref, atol=5e-6, rtol=0)


@pytest.mark.parametrize("image_hw, upscale_by", [((16, 24), 2.0), ((20, 12), 1.5)])
def test_the_nodes_pre_upscale_matches_the_jax_nodes_branch(models, image_hw, upscale_by):
    """The model's 4x output, then cubic to round(side * upscale_by / 8) * 8,
    the tiles at 1x: the JAX node's branch, step for step."""
    jm, tm = models
    image = _image(5, (1, *image_hw, 3))
    target = tuple(int(round(s * upscale_by / 8)) * 8 for s in image_hw)
    ref = np.asarray(jax.image.resize(jm.upscale(jnp.asarray(image)), (1, *target, 3),
                                      method="cubic"))
    with torch.no_grad():
        got, tile_scale = tnodes.pre_upscale(torch.from_numpy(image), tm, upscale_by)
    assert tile_scale == 1.0 and got.shape == (1, *target, 3)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


# --- the whole graph ------------------------------------------------------------------

def full_usdu_workflow(ckpt, image, text="masterpiece, highly detailed", **usdu):
    """workflows/distributed-upscale.json with an upscale model into the
    USDU node, ControlNet tile (LoadImage's image as the hint) on both
    conditionings, node 2 as CLIPTextEncodeSDXL (2048 px, target 1024)
    and tiled decode; `image` inline in place of LoadImage, a
    PreviewImage sink."""
    with open(os.path.join(REPO, "workflows", "distributed-upscale.json"), encoding="utf-8") as fh:
        prompt = json.load(fh)
    del prompt["4"]
    prompt["1"]["inputs"]["ckpt_name"] = ckpt
    prompt["2"] = {"class_type": "CLIPTextEncodeSDXL", "inputs": {
        "clip": ["1", 1], "width": 2048, "height": 2048, "crop_w": 0, "crop_h": 0,
        "target_width": 1024, "target_height": 1024, "text_g": text, "text_l": text}}
    prompt["6"] = {"class_type": "PreviewImage", "inputs": {"images": ["5", 0]}}
    prompt["7"] = {"class_type": "UpscaleModelLoader", "inputs": {"model_name": "4x-generic"}}
    prompt["8"] = {"class_type": "ControlNetLoader",
                   "inputs": {"control_net_name": "tile", "model": ["1", 0]}}
    prompt["9"] = {"class_type": "ControlNetApplyAdvanced", "inputs": {
        "positive": ["2", 0], "negative": ["3", 0], "control_net": ["8", 0], "image": image,
        "strength": 1.0, "start_percent": 0.0, "end_percent": 1.0}}
    prompt["5"]["inputs"].update(image=image, positive=["9", 0], negative=["9", 1],
                                 upscale_model=["7", 0], tiled_decode=True, **usdu)
    return prompt


def test_the_full_usdu_graph_matches_jax(monkeypatch):
    """tiny-unet-adm, 32 → 64 px through the 4x model and the cubic
    downsampling, four 32-px tiles with 8-px padding, 2 euler steps,
    ControlNet tile on both sides, CLIPTextEncodeSDXL's size override,
    tiled decode (both packages' decode_tiled at an 8-latent tile with
    2 of overlap, so a tile's 24 latents decode in four pieces). The
    port draws the JAX package's tile noise. Tolerance 5e-5 on [0, 1]
    pixels (measured 3.8e-6 on a CPU)."""
    jb, tb = jax_and_port_bundles("tiny-unet-adm", te_name="tiny-te-l", te2_name="tiny-te-g")
    jnet, tnet = controlnet_pair(model_channels=32, downscale=tb.latent_scale)
    jup_model, tup_model = upscaler_pair()
    image = _image(6, (1, 32, 32, 3))
    usdu = dict(steps=2, tile_width=32, tile_height=32, tile_padding=8, seed=17)
    monkeypatch.setattr(jtvae, "decode_tiled",
                        functools.partial(jtvae.decode_tiled, tile=8, overlap=2))
    monkeypatch.setattr(tup, "decode_tiled", functools.partial(tup.decode_tiled, tile=8,
                                                                overlap=2))
    monkeypatch.setattr(tup, "default_noise", lambda seed, device: JaxTileNoise(seed))
    net_key = f"controlnet:tile:32:{tb.latent_scale}"
    jctx = jexec.ExecutionContext(pipelines={"tiny-unet-adm": jb, net_key: jnet,
                                             "upscaler:4x-generic": jup_model})
    ref = np.asarray(jexec.GraphExecutor(jctx).execute(
        full_usdu_workflow("tiny-unet-adm", jnp.asarray(image), **usdu))["6"][0]["images"])
    tctx = ExecutionContext(device="cpu", pipelines={"tiny-unet-adm": tb, net_key: tnet,
                                                     "upscaler:4x-generic": tup_model})
    executor = GraphExecutor(tctx)
    prompt = full_usdu_workflow("tiny-unet-adm", torch.from_numpy(image), **usdu)
    got = executor.execute(prompt)["6"][0]["images"].numpy()
    assert got.shape == ref.shape == (1, 64, 64, 3)
    assert executor.last_results["2"][0].size_cond == (2048, 2048, 0, 0, 1024, 1024)
    # strength 0 returns the conditionings untouched: the ControlNet counted
    plain = copy.deepcopy({k: v for k, v in prompt.items() if k != "6"})
    plain["9"]["inputs"]["strength"] = 0.0
    plain["6"] = prompt["6"]
    plain_out = GraphExecutor(tctx).execute(plain)["6"][0]["images"].numpy()
    assert np.abs(got - plain_out).max() > 1.0 / 255
    np.testing.assert_allclose(got, ref, atol=5e-5, rtol=0)
