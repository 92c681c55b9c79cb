"""The port's upscale path against the JAX package's, on the CPU in f32:
resize, tile geometry, extraction and blending, the sigma schedule, and
the whole slice (`run_upscale` on tiny-unet-adm), plus the workflow
through the port's GraphExecutor.

The whole slice runs both packages on the same weights (numpy-seeded in
the flax layout, carried into the port; biases, norm scales and the
UNet's out_conv non-zero) and the same noise (the JAX package's
folded-key normals, handed to the port through its `noise` callable).
The JAX run is computed once per module: its compile takes about a
minute on one core.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_distributed_tpu.models import pipeline as jpl
from comfyui_distributed_tpu.models import registry as jreg
from comfyui_distributed_tpu.models import text_encoder as jte
from comfyui_distributed_tpu.models.io import flatten_params
from comfyui_distributed_tpu.ops import samplers as jsmp
from comfyui_distributed_tpu.ops import tiles as jtiles
from comfyui_distributed_tpu.ops import upscale as jup
from comfyui_distributed_tpu_torch.graph import ExecutionContext, GraphExecutor
from comfyui_distributed_tpu_torch.graph import nodes_upscale as tnodes
from comfyui_distributed_tpu_torch.models import pipeline as tpl
from comfyui_distributed_tpu_torch.models import registry as treg
from comfyui_distributed_tpu_torch.models.io import from_jax_params
from comfyui_distributed_tpu_torch.ops import samplers as tsmp
from comfyui_distributed_tpu_torch.ops import tiles as ttiles
from comfyui_distributed_tpu_torch.ops import upscale as tup
from comfyui_distributed_tpu_torch.utils.exceptions import PromptValidationError
from test_torch_parity import f32, seeded_flax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 11
SLICE = dict(upscale_by=2.0, tile=64, padding=16, steps=2, sampler="euler",
             scheduler="karras", cfg=7.0, denoise=0.35, seed=SEED)
SLICE_MODELS = ("tiny-unet-adm", "tiny-vae", "tiny-te-l", "tiny-te-g")


def _image(seed, shape):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


# --- resize ---------------------------------------------------------------

@pytest.mark.parametrize("method", ["bicubic", "bilinear", "lanczos", "nearest",
                                    "nearest-exact", "area"])
@pytest.mark.parametrize("src, dst", [((16, 20), (40, 32)), ((40, 32), (16, 20))])
def test_resize_image_matches_jax(method, src, dst):
    """Upscales, and downscales where jax.image.resize antialiases;
    F.interpolate's bicubic (a=-0.75) would miss by ~1e-2."""
    img = _image(0, (2, *src, 3))
    ref = np.asarray(jup.resize_image(jnp.asarray(img), *dst, method))
    out = tup.resize_image(torch.from_numpy(img), *dst, method).numpy()
    # weights built in f64 here and in f32 by jax: ~1e-7 per weight
    np.testing.assert_allclose(out, ref, atol=2e-6, rtol=0)


def test_resize_image_rejects_unknown_method_and_keeps_identity():
    img = torch.zeros((1, 8, 8, 3))
    with pytest.raises(ValueError, match="unknown upscale_method"):
        tup.resize_image(img, 16, 16, "bicubc")
    assert tup.resize_image(img, 8, 8, "bicubic") is img


# --- tiles ----------------------------------------------------------------

GRIDS = [
    dict(image_h=128, image_w=128, tile_h=64, tile_w=64, padding=16),
    dict(image_h=100, image_w=136, tile_h=48, tile_w=64, padding=8, mask_blur=4),
    dict(image_h=100, image_w=136, tile_h=48, tile_w=64, padding=8, uniform=False),
    dict(image_h=40, image_w=56, tile_h=64, tile_w=64, padding=8),
]


@pytest.mark.parametrize("kw", GRIDS)
def test_tile_extract_and_blend_match_jax(kw):
    jgrid = jtiles.calculate_tiles(**kw)
    tgrid = ttiles.calculate_tiles(**kw)
    assert dataclasses.asdict(tgrid) == dataclasses.asdict(jgrid)
    img = _image(1, (2, kw["image_h"], kw["image_w"], 3))
    np.testing.assert_array_equal(
        ttiles.pad_image_for_grid(torch.from_numpy(img), tgrid).numpy(),
        np.asarray(jtiles.pad_image_for_grid(jnp.asarray(img), jgrid)),
    )
    tiles_ref = np.asarray(jtiles.extract_tiles(jnp.asarray(img), jgrid))
    tiles = ttiles.extract_tiles(torch.from_numpy(img), tgrid)
    np.testing.assert_array_equal(tiles.numpy(), tiles_ref)
    np.testing.assert_array_equal(
        ttiles.feather_mask(tgrid).numpy(), np.asarray(jtiles.feather_mask(jgrid))
    )
    processed = _image(2, tiles_ref.shape)
    ref = np.asarray(jtiles.blend_tiles(jnp.asarray(processed), jgrid))
    out = ttiles.blend_tiles(torch.from_numpy(processed), tgrid).numpy()
    # f32 weighted sums in the same order; division may round 1 ulp apart
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("args", [(512, 512, 2.0, 512, 32, 512), (64, 64, 2.0, 64, 16, None),
                                  (100, 75, 1.5, 100, 20, 60)])
def test_plan_grid_matches_jax(args):
    jout = jup.plan_grid(*args)
    tout = tup.plan_grid(*args)
    assert tout[:2] == jout[:2]
    assert dataclasses.asdict(tout[2]) == dataclasses.asdict(jout[2])


# --- schedules --------------------------------------------------------------

@pytest.mark.parametrize("steps, denoise", [(20, 0.35), (2, 0.35), (10, 1.0), (57, 0.5)])
def test_karras_sigmas_equal_to_the_last_bit(steps, denoise):
    ref = np.asarray(jsmp.get_sigmas("karras", steps, denoise=denoise))
    out = tsmp.get_model_sigmas("eps", "karras", steps, denoise=denoise).numpy()
    assert out.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(out, ref)


def test_sigma_to_timestep_matches_jax():
    sig = np.concatenate([np.asarray(jsmp.get_sigmas("karras", 57)), [1e-12, 30.0]]).astype(np.float32)
    np.testing.assert_array_equal(
        tsmp.sigma_to_timestep(torch.from_numpy(sig)).numpy(),
        np.asarray(jsmp.sigma_to_timestep(jnp.asarray(sig))),
    )


def test_unported_samplers_and_schedulers_raise():
    with pytest.raises(NotImplementedError, match="normal"):
        tsmp.get_sigmas("normal", 10)
    with pytest.raises(NotImplementedError, match="heun"):
        tsmp.sample(lambda x, s, c: x, torch.zeros(1), torch.zeros(2), None, "heun")
    with pytest.raises(ValueError, match="unknown sampler"):
        tsmp.sample(lambda x, s, c: x, torch.zeros(1), torch.zeros(2), None, "eulr")


def test_default_noise_depends_on_seed_and_global_tile_index_only():
    a = tup.default_noise(3, "cpu")
    b = tup.default_noise(3, "cpu")
    assert torch.equal(a(2, (1, 4, 4, 4)), b(2, (1, 4, 4, 4)))
    assert not torch.equal(a(2, (1, 4, 4, 4)), a(3, (1, 4, 4, 4)))
    assert not torch.equal(a(2, (1, 4, 4, 4)), tup.default_noise(4, "cpu")(2, (1, 4, 4, 4)))


# --- the whole slice ----------------------------------------------------------

def _jax_noise(seed):
    """The JAX package's tile noise: split(fold_in(key(seed), g))[0]."""
    key = jax.random.key(seed)

    def noise(tile_index, shape):
        noise_key, _ = jax.random.split(jax.random.fold_in(key, tile_index))
        return torch.from_numpy(np.array(jax.random.normal(noise_key, shape)))

    return noise


def _jax_bundle():
    """The JAX package's tiny-unet-adm bundle as its load_pipeline
    assembles it, with numpy-seeded parameters in place of flax's init
    (a minute of init on one core, see tests/test_torch_parity.py)."""
    unet, vae, te, te2 = (jreg.create_model(n) for n in SLICE_MODELS)
    te_cfg, te2_cfg = jreg.get_config("tiny-te-l"), jreg.get_config("tiny-te-g")
    tokens = jnp.zeros((1, te_cfg.max_length), jnp.int32)
    params = {
        "unet": seeded_flax_params(unet, 1, jnp.zeros((1, 16, 16, 4)), jnp.zeros((1,)),
                                   jnp.zeros((1, te_cfg.max_length, 160))),
        "vae": seeded_flax_params(vae, 2, jnp.zeros((1, 32, 32, 3))),
        "te": seeded_flax_params(te, 3, tokens),
        "te2": seeded_flax_params(te2, 4, tokens),
    }
    vae_cfg = jreg.get_config("tiny-vae")
    return jpl.PipelineBundle(
        model_name="tiny-unet-adm", unet=unet, vae=vae, text_encoder=te, params=params,
        tokenizer=jte.Tokenizer(max_length=te_cfg.max_length, pad_id=te_cfg.pad_token_id),
        latent_channels=vae_cfg.latent_channels, latent_scale=vae_cfg.downscale,
        text_encoder_2=te2,
        tokenizer_2=jte.Tokenizer(max_length=te2_cfg.max_length, pad_id=te2_cfg.pad_token_id),
        te_name="tiny-te-l", te2_name="tiny-te-g",
    )


@pytest.fixture(scope="module")
def slice_pair():
    """(JAX bundle, port bundle on the CPU with the same weights, JAX
    output of run_upscale, prompts, image), all at f32."""
    mp = pytest.MonkeyPatch()
    try:
        for registry in (jreg.MODEL_REGISTRY, treg.MODEL_REGISTRY):
            for name in SLICE_MODELS:
                entry = dict(registry[name])
                entry["config"] = f32(entry["config"])
                mp.setitem(registry, name, entry)
        jb = _jax_bundle()
        tb = tpl.load_pipeline("tiny-unet-adm", seed=0, device="cpu")
        for part, module in (("unet", tb.unet), ("vae", tb.vae), ("te", tb.text_encoder),
                             ("te2", tb.text_encoder_2)):
            module.load_state_dict(from_jax_params(flatten_params(jb.params[part]), module))
        texts = ("masterpiece, highly detailed", "blurry")
        image = _image(3, (1, 64, 64, 3))
        jpos, jneg = (jpl.encode_text_pooled(jb, [t]) for t in texts)
        ref = np.asarray(jup.run_upscale(jb, jnp.asarray(image), jpos, jneg, tile_batch=1, **SLICE))
        yield jb, tb, ref, texts, image, (jpos, jneg)
    finally:
        mp.undo()


def test_text_conditioning_matches_jax(slice_pair):
    _, tb, _, texts, _, jconds = slice_pair
    for text, jc in zip(texts, jconds):
        tc = tpl.encode_text_pooled(tb, [text])
        # f32 ordering noise through two towers; measured 1.4e-6
        np.testing.assert_allclose(tc.context.numpy(), np.asarray(jc.context), atol=2e-5, rtol=0)
        np.testing.assert_allclose(tc.pooled.numpy(), np.asarray(jc.pooled), atol=2e-5, rtol=0)


def test_run_upscale_matches_jax_on_tiny_unet_adm(slice_pair):
    """64→128 px, 64-px tiles with 16-px padding (4 tiles), 2 euler steps
    on karras, CFG 7, denoise 0.35. Tolerance 5e-5 absolute on [0, 1]
    pixels: f32 on both sides through encode, four UNet evaluations and
    decode, differing in summation order only (measured 6.3e-6 on a
    CPU)."""
    _, tb, ref, texts, image, _ = slice_pair
    pos, neg = (tpl.encode_text_pooled(tb, [t]) for t in texts)
    out = tup.run_upscale(tb, image, pos, neg, noise=_jax_noise(SEED), **SLICE)
    assert out.shape == ref.shape == (1, 128, 128, 3)
    # the diffusion moved the pixels: not just the resized input
    resized = tup.resize_image(torch.from_numpy(image), 128, 128, "bicubic").clamp(0, 1)
    assert float((out - resized).abs().max()) > 0.05
    np.testing.assert_allclose(out.numpy(), ref, atol=5e-5, rtol=0)


def _workflow(image, **usdu):
    with open(os.path.join(REPO, "workflows", "distributed-upscale.json"), encoding="utf-8") as fh:
        prompt = json.load(fh)
    del prompt["4"], prompt["6"]
    prompt["1"]["inputs"]["ckpt_name"] = "tiny-unet-adm"
    prompt["5"]["inputs"].update(image=image, **usdu)
    return prompt


def test_workflow_through_graph_executor_equals_run_upscale(slice_pair):
    _, tb, _, texts, image, _ = slice_pair
    context = ExecutionContext(device="cpu")
    context.pipelines["tiny-unet-adm"] = tb
    executor = GraphExecutor(context)
    prompt = _workflow(torch.from_numpy(image), steps=2, tile_width=64, tile_height=64,
                       tile_padding=16, seed=SEED)
    assert executor.execute(prompt) == {}
    out = executor.last_results["5"][0]
    pos, neg = (tpl.encode_text_pooled(tb, [t]) for t in texts)
    direct = tup.run_upscale(tb, image, pos, neg, tile=64, padding=16, steps=2, seed=SEED,
                             mask_blur=8)  # the node's default mask_blur
    torch.testing.assert_close(out, direct, rtol=0, atol=0)


def test_load_and_save_image_nodes_through_the_executor(slice_pair, tmp_path, monkeypatch):
    from PIL import Image

    _, tb, _, _, image, _ = slice_pair
    monkeypatch.setenv("CDT_INPUT_DIR", str(tmp_path / "in"))
    monkeypatch.setenv("CDT_OUTPUT_DIR", str(tmp_path / "out"))
    (tmp_path / "in").mkdir()
    u8 = (image[0] * 255.0 + 0.5).astype(np.uint8)
    Image.fromarray(u8).save(tmp_path / "in" / "input.png")
    with open(os.path.join(REPO, "workflows", "distributed-upscale.json"), encoding="utf-8") as fh:
        prompt = json.load(fh)
    prompt["1"]["inputs"]["ckpt_name"] = "tiny-unet-adm"
    prompt["5"]["inputs"].update(steps=1, tile_width=64, tile_height=64, tile_padding=16)
    context = ExecutionContext(device="cpu")
    context.pipelines["tiny-unet-adm"] = tb
    outputs = GraphExecutor(context).execute(prompt)
    assert outputs["6"][0]["ui"]["images"] == ["upscaled_00000.png"]
    with Image.open(tmp_path / "out" / "upscaled_00000.png") as saved:
        assert saved.size == (128, 128)
        saved_arr = np.asarray(saved, dtype=np.float32) / 255.0
    np.testing.assert_allclose(saved_arr, outputs["6"][0]["images"][0].numpy(), atol=0.5 / 255 + 1e-6)


def test_usdu_node_raises_on_unported_branches(slice_pair):
    _, tb, _, _, image, _ = slice_pair
    node = tnodes.UltimateSDUpscaleDistributed()
    args = dict(image=torch.from_numpy(image), model=tb, positive=None, negative=None, vae=tb)
    with pytest.raises(NotImplementedError, match="elastic USDU tier"):
        node.run(**args, is_worker=True)
    with pytest.raises(NotImplementedError, match="multi-device tile tier"):
        node.run(**args, context=ExecutionContext(device="cpu", mesh=object()))
    with pytest.raises(ValueError, match="unknown sampler"):
        node.run(**args, sampler_name="eulr")


def test_validate_prompt_reports_node_errors():
    prompt = _workflow(None)
    prompt["7"] = {"class_type": "NoSuchNode", "inputs": {}}
    prompt["5"]["inputs"]["negative"] = ["42", 0]
    with pytest.raises(PromptValidationError) as err:
        GraphExecutor(ExecutionContext(device="cpu")).execute(prompt)
    assert set(err.value.node_errors) == {"5", "7"}
