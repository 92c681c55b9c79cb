"""SD1.5's txt2img path in the port against the JAX package, on the CPU.

- The UNet at a narrow SD1.5-shaped config whose transformers run head
  dims 40 and 80 (8 heads of 40 would need 320 channels; 2 heads of
  80 / 2 do it at 80), weights numpy-seeded in the flax layout and
  carried into the port, in f32.
- `img2img_latents` from an empty latent on tiny-unet (32 px, 2 euler
  steps, CFG 3, denoise 1), with the JAX package's own initial noise
  handed in, then the VAE decode.
- The txt2img workflow through the port's GraphExecutor against the
  port's own `img2img_latents` + decode and `txt2img`.
- sd15 and clip-l at full width: parameter shapes on the meta device
  against `jax.eval_shape` of the flax init, which allocates nothing.

Tolerances: both sides are f32 and differ in summation order and in the
last bit of exp/erf: a few 1e-6 of the values' scale (outputs of order 1
for the UNet and the decoded pixels, up to ~40 for the sampled
latents); each tolerance leaves a margin of about ten.
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
from comfyui_distributed_tpu.models import unet as junet
from comfyui_distributed_tpu.models.io import flatten_params
from comfyui_distributed_tpu_torch.graph import ExecutionContext, GraphExecutor
from comfyui_distributed_tpu_torch.graph.nodes_core import KSampler, SeedSpec
from comfyui_distributed_tpu_torch.models import layers as tlayers
from comfyui_distributed_tpu_torch.models import pipeline as tpl
from comfyui_distributed_tpu_torch.models import registry as treg
from comfyui_distributed_tpu_torch.models import unet as tunet
from comfyui_distributed_tpu_torch.models.io import _torch_name_and_value, from_jax_params
from test_torch_parity import f32, seeded_flax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = dict(model_channels=80, channel_mult=(1, 2), num_heads=2, transformer_depth=(1, 1),
              num_res_blocks=1, context_dim=64, dtype="float32")
SEED = 11


def test_unet_matches_flax_at_head_dims_40_and_80(monkeypatch):
    jm = junet.UNet(junet.UNetConfig(**NARROW))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 8, 8, 4), dtype=np.float32)
    t = np.asarray([17.0, 981.0], np.float32)
    ctx = rng.standard_normal((2, 77, 64), dtype=np.float32)
    params = seeded_flax_params(jm, 0, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    ref = np.asarray(jm.apply(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx)))
    assert np.abs(ref).max() > 0.1  # the UNet's output is not the zero init
    tm = tunet.UNet(tunet.UNetConfig(**NARROW))
    tm.load_state_dict(from_jax_params(flatten_params(params), tm))
    tm.eval().requires_grad_(False)
    head_dims = set()
    attention = tlayers.dot_product_attention

    def record(q, k, v):
        head_dims.add(q.shape[-1])
        return attention(q, k, v)

    monkeypatch.setattr(tlayers, "dot_product_attention", record)
    out = tm(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx)).numpy()
    assert head_dims == {40, 80}
    np.testing.assert_allclose(out, ref, atol=3e-5, rtol=0)


@pytest.fixture(scope="module")
def tiny_pair():
    """(JAX tiny-unet bundle, port bundle on the CPU with the same UNet
    and VAE weights, a (positive, negative) text context), at f32."""
    mp = pytest.MonkeyPatch()
    try:
        for registry in (jreg.MODEL_REGISTRY, treg.MODEL_REGISTRY):
            for name in ("tiny-unet", "tiny-vae"):
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


def _jax_noise(seed, shape):
    """The initial noise of the JAX package's _img2img_jit:
    normal(split(key(seed))[0])."""
    noise_key, _ = jax.random.split(jax.random.key(seed))
    return np.array(jax.random.normal(noise_key, shape))


def test_img2img_latents_from_an_empty_latent_matches_jax(tiny_pair):
    jb, tb, (pos, neg) = tiny_pair
    side = 32 // tb.latent_scale
    zeros = np.zeros((1, side, side, 4), np.float32)
    kw = dict(steps=2, sampler="euler", scheduler="karras", cfg_scale=3.0, denoise=1.0)
    jz = jpl.img2img_latents(jb, jnp.asarray(zeros), jnp.asarray(pos), jnp.asarray(neg),
                             seed=SEED, **kw)
    ref = np.asarray(jb.vae.apply(jb.params["vae"], jz, method="decode"))
    tz = tpl.img2img_latents(tb, torch.from_numpy(zeros), torch.from_numpy(pos),
                             torch.from_numpy(neg), seed=SEED,
                             noise=torch.from_numpy(_jax_noise(SEED, zeros.shape)), **kw)
    # the latents start at sigma_max = 14.6 times unit noise and end up to
    # ~40 in size: f32 ordering noise of a few 1e-6 of that scale
    assert np.abs(np.asarray(jz)).max() > 10
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), atol=2e-4, rtol=0)
    out = tb.vae.decode(tz).numpy()
    assert out.shape == ref.shape == (1, 32, 32, 3)
    assert out.std() > 0.01  # an image, not a constant
    np.testing.assert_allclose(out, ref, atol=5e-5, rtol=0)


def test_img2img_latents_default_noise_is_seeded_on_the_bundle_device(tiny_pair):
    _, tb, (pos, neg) = tiny_pair
    zeros = torch.zeros((1, 4, 4, 4))
    kw = dict(steps=1, cfg_scale=3.0, denoise=1.0)
    pos, neg = torch.from_numpy(pos), torch.from_numpy(neg)
    a = tpl.img2img_latents(tb, zeros, pos, neg, seed=5, **kw)
    b = tpl.img2img_latents(tb, zeros, pos, neg, seed=5,
                            noise=tpl.default_noise(5, (1, 4, 4, 4), "cpu"), **kw)
    c = tpl.img2img_latents(tb, zeros, pos, neg, seed=6, **kw)
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="does not match"):
        tpl.img2img_latents(tb, zeros, pos, neg, noise=torch.zeros((1, 4, 4, 3)), **kw)


def _tiny_txt2img_prompt(seed=SEED):
    with open(os.path.join(REPO, "workflows", "distributed-txt2img.json"), encoding="utf-8") as fh:
        prompt = json.load(fh)
    prompt["1"]["inputs"]["ckpt_name"] = "tiny-unet"
    prompt["4"]["inputs"].update(width=32, height=32)
    prompt["5"]["inputs"]["seed"] = seed
    prompt["6"]["inputs"].update(steps=2, cfg=3.0)
    del prompt["9"]  # no SaveImage: nothing written
    return prompt


@pytest.fixture(scope="module")
def tiny_bundle():
    """tiny-unet with seeded random weights and a non-zero out_conv."""
    bundle = tpl.load_pipeline("tiny-unet", seed=0, device="cpu")
    with torch.no_grad():
        weight = bundle.unet.out_conv.weight
        weight.copy_(torch.randn(weight.shape, generator=torch.Generator().manual_seed(0)) * 0.1)
    return bundle


def test_workflow_through_the_executor_equals_img2img_latents_and_decode(tiny_bundle):
    prompt = _tiny_txt2img_prompt()
    context = ExecutionContext(device="cpu")
    context.pipelines["tiny-unet"] = tiny_bundle
    executor = GraphExecutor(context)
    executor.execute(prompt)
    image = executor.last_results["8"][0]  # the collector, with no workers
    assert torch.equal(image, executor.last_results["7"][0])
    texts = [prompt[n]["inputs"]["text"] for n in ("2", "3")]
    pos, neg = (tpl.encode_text_pooled(tiny_bundle, [t]) for t in texts)
    side = 32 // tiny_bundle.latent_scale
    z = tpl.img2img_latents(tiny_bundle, torch.zeros((1, side, side, 4)), pos, neg, steps=2,
                            cfg_scale=3.0, denoise=1.0, seed=SEED)
    direct = tiny_bundle.vae.decode(z)
    assert image.shape == (1, 32, 32, 3)
    torch.testing.assert_close(image, direct, atol=0, rtol=0)
    whole = tpl.txt2img(tiny_bundle, texts[0], texts[1], height=32, width=32, steps=2,
                        cfg_scale=3.0, seed=SEED)
    torch.testing.assert_close(whole, direct, atol=0, rtol=0)


def test_a_worker_seed_is_offset_by_its_index(tiny_bundle):
    """DistributedSeed on worker 0 samples with seed + 1: the image a
    local run at seed + 1 makes."""
    context = ExecutionContext(device="cpu")
    context.pipelines["tiny-unet"] = tiny_bundle
    worker = _tiny_txt2img_prompt()
    worker["5"]["inputs"].update(is_worker=True, worker_index=0)
    executor = GraphExecutor(context)
    executor.execute(worker)
    local = GraphExecutor(ExecutionContext(device="cpu", pipelines=context.pipelines))
    local.execute(_tiny_txt2img_prompt(SEED + 1))
    assert torch.equal(executor.last_results["7"][0], local.last_results["7"][0])
    assert SeedSpec(SEED, worker_index=2).effective_seed() == SEED + 3


def test_unported_sampler_inputs_raise(tiny_bundle):
    latent = {"samples": torch.zeros((1, 4, 4, 4))}
    args = dict(model=tiny_bundle, steps=1, cfg=1.0, sampler_name="euler", scheduler="karras",
                positive=None, negative=None)
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        KSampler().sample(seed=SeedSpec(1, per_participant=True), latent_image=latent, **args)
    with pytest.raises(NotImplementedError, match="LatentBatchSeedBehavior"):
        KSampler().sample(seed=1, latent_image={**latent, "batch_index_fixed": True}, **args)


def _expected_torch_shapes(flax_shapes) -> dict[str, tuple]:
    """The port's parameter name → shape that `from_jax_params` would map
    each flax leaf to (zero-stride views: nothing is allocated)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(flax_shapes)[0]:
        flat = "/".join(str(getattr(p, "key", p)) for p in path)
        name, value = _torch_name_and_value(flat, np.broadcast_to(np.float32(0), leaf.shape))
        out[name] = tuple(value.shape)
    return out


@pytest.mark.parametrize("name", ["sd15", "clip-l"])
def test_full_width_parameter_shapes_equal_the_jax_packages(name):
    jm = jreg.create_model(name)
    if name == "sd15":
        args = (jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)), jnp.zeros((1, 77, 768)))
    else:
        args = (jnp.zeros((1, 77), jnp.int32),)
    expected = _expected_torch_shapes(jax.eval_shape(jm.init, jax.random.key(0), *args))
    with torch.device("meta"):
        tm = treg.create_model(name)
    shapes = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert shapes == expected
    if name == "sd15":
        assert sum(np.prod(s) for s in shapes.values()) > 8.5e8  # SD1.5's 860M


def test_registry_entries_equal_the_jax_packages_but_remat():
    jcfg, tcfg = jreg.get_config("sd15"), treg.get_config("sd15")
    fields = {f.name for f in dataclasses.fields(tcfg)}
    assert {k: v for k, v in dataclasses.asdict(jcfg).items() if k in fields} \
        == dataclasses.asdict(tcfg)
    assert jcfg.remat is True and "remat" not in fields
    jte_cfg = dataclasses.asdict(jreg.get_config("clip-l"))
    tte_cfg = dataclasses.asdict(treg.get_config("clip-l"))
    assert {k: jte_cfg[k] for k in tte_cfg} == tte_cfg


def test_sd15_loads_single_tower_with_clip_l(monkeypatch):
    """load_pipeline names clip-l for every single-tower UNet that is not
    tiny; on the meta device nothing is allocated."""
    built = []

    def on_meta(name, device, generator):
        built.append(name)
        with torch.device("meta"):
            return treg.create_model(name).requires_grad_(False)

    monkeypatch.setattr(tpl, "_build", on_meta)
    bundle = tpl.load_pipeline("sd15", device="cpu")
    assert built == ["sd15", "vae-sd", "clip-l"]
    assert bundle.text_encoder_2 is None and bundle.te_name == "clip-l"
    assert bundle.tokenizer.max_length == 77
