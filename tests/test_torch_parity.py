"""Shared helpers of the PyTorch port's parity tests (tests/test_torch_*.py),
and tests of the helpers themselves."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_distributed_tpu.models import registry as jreg
from comfyui_distributed_tpu.models.io import flatten_params
from comfyui_distributed_tpu_torch.utils.async_helpers import ServerLoopThread


@pytest.fixture
def one_torch_thread():
    """One intra-op thread per torch call, for tests that run several
    Python threads calling torch at once (master, worker, pipeline
    stages): each call's default team of one thread per core would
    oversubscribe the cores of every test process beside them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def port_loop():
    """The port's own control-plane loop (tests/conftest.py's server_loop
    drives the JAX package's)."""
    loop = ServerLoopThread(name="port-test-loop")
    loop.start()
    yield loop
    loop.stop()


def f32(config):
    """A registry config computing in float32, for f32 parity."""
    return dataclasses.replace(config, dtype="float32")


def seeded_flax_params(module, seed, *args, **kwargs):
    """The parameter tree `module.init(key, *args)` would build, filled
    from numpy with a fixed seed instead of running init: the shapes come
    from a trace (a second), where flax's init of a tiny UNet takes a
    minute on one core. Kernels N(0, 1/fan_in), biases N(0, 0.1^2), norm
    scales 1 + N(0, 0.1^2), embedding tables N(0, 1/width), the position
    table N(0, 0.01^2) (the SD3 MMDiT's N(0, 1/width)), the video DiT's
    modulation tables N(0, 1/width), the CLIP-vision class embedding
    N(0, 0.02^2). Non-zero biases
    and scales make a mis-mapped parameter show; the UNet's out_conv, zero
    after flax's init, comes out non-zero like every other kernel, so the
    UNet's output counts."""
    shapes = jax.eval_shape(module.init, jax.random.key(0), *args, **kwargs)
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        draw = rng.standard_normal(leaf.shape, dtype=np.float32)
        if name == "kernel":
            return jnp.asarray(draw / math.sqrt(math.prod(leaf.shape[:-1])))
        if name == "bias":
            return jnp.asarray(draw * 0.1)
        if name == "scale":
            return jnp.asarray(1.0 + draw * 0.1)
        if name == "embedding":
            return jnp.asarray(draw / math.sqrt(leaf.shape[-1]))
        if name == "position_embedding":
            return jnp.asarray(draw * 0.01)
        if name == "pos_embed":  # the SD3 MMDiT's learned table, [1, max^2, width]
            return jnp.asarray(draw / math.sqrt(leaf.shape[-1]))
        if name == "text_projection":
            return jnp.asarray(draw / math.sqrt(leaf.shape[0]))
        if name in ("modulation", "head_modulation"):  # the video DiT's [1, k, width]
            return jnp.asarray(draw / math.sqrt(leaf.shape[-1]))
        if name == "class_embedding":  # the CLIP-vision tower's
            return jnp.asarray(draw * 0.02)
        raise KeyError(f"no fill rule for parameter {name!r}")

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.mark.parametrize("name", ["tiny-unet-adm", "tiny-vae", "tiny-te-g"])
def test_seeded_params_fill_every_leaf_of_flax_init(name):
    """Same tree, same shapes as flax's init; seeded; out_conv non-zero."""
    module = jreg.create_model(name)
    if name.startswith("tiny-unet"):
        args = (jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)), jnp.zeros((1, 16, 160)))
    elif name == "tiny-vae":
        args = (jnp.zeros((1, 16, 16, 3)),)
    else:
        args = (jnp.zeros((1, 16), jnp.int32),)
    def shapes(tree):
        return jax.tree_util.tree_map(lambda leaf: tuple(leaf.shape), tree)

    filled = seeded_flax_params(module, 7, *args)
    assert shapes(filled) == shapes(jax.eval_shape(module.init, jax.random.key(0), *args))
    a = flatten_params(filled)
    b = flatten_params(seeded_flax_params(module, 7, *args))
    assert all(np.array_equal(a[k], b[k]) for k in a)
    if "params/out_conv/kernel" in a:
        assert np.abs(a["params/out_conv/kernel"]).max() > 0


def jax_and_port_bundles(model_name, te_name="tiny-te", vae_name="tiny-vae", seed=0,
                         te2_name=None):
    """(JAX bundle, port bundle on the CPU) of a tiny UNet checkpoint in
    f32, with the same numpy-seeded weights in both: UNet (its out_conv
    non-zero), VAE and text encoder(s); `te2_name` adds the second tower
    of the SDXL layout. The registries hold float32 configs only while
    the modules are built."""
    from comfyui_distributed_tpu.models import pipeline as jpl
    from comfyui_distributed_tpu.models import text_encoder as jte
    from comfyui_distributed_tpu_torch.models import pipeline as tpl
    from comfyui_distributed_tpu_torch.models import registry as treg
    from comfyui_distributed_tpu_torch.models.io import from_jax_params

    names = [n for n in (model_name, te_name, vae_name, te2_name) if n]
    with pytest.MonkeyPatch.context() as mp:
        for registry in (jreg.MODEL_REGISTRY, treg.MODEL_REGISTRY):
            for name in names:
                mp.setitem(registry, name, {**registry[name], "config": f32(registry[name]["config"])})
        unet, vae, te = (jreg.create_model(n) for n in (model_name, vae_name, te_name))
        te_cfg, vae_cfg = jreg.get_config(te_name), jreg.get_config(vae_name)
        ctx_dim = jreg.get_config(model_name).context_dim
        in_channels = jreg.get_config(model_name).in_channels  # 9: an inpainting UNet
        tokens = jnp.zeros((1, te_cfg.max_length), jnp.int32)
        params = {
            "unet": seeded_flax_params(unet, seed + 1, jnp.zeros((1, 16, 16, in_channels)),
                                       jnp.zeros((1,)),
                                       jnp.zeros((1, te_cfg.max_length, ctx_dim))),
            "vae": seeded_flax_params(vae, seed + 2, jnp.zeros((1, 32, 32, 3))),
            "te": seeded_flax_params(te, seed + 3, tokens),
        }
        te2 = tok2 = None
        if te2_name:
            te2 = jreg.create_model(te2_name)
            te2_cfg = jreg.get_config(te2_name)
            params["te2"] = seeded_flax_params(te2, seed + 4, tokens)
            tok2 = jte.Tokenizer(max_length=te2_cfg.max_length, pad_id=te2_cfg.pad_token_id)
        jb = jpl.PipelineBundle(
            model_name=model_name, unet=unet, vae=vae, text_encoder=te, params=params,
            tokenizer=jte.Tokenizer(max_length=te_cfg.max_length, pad_id=te_cfg.pad_token_id),
            latent_channels=vae_cfg.latent_channels, latent_scale=vae_cfg.downscale,
            te_name=te_name, text_encoder_2=te2, tokenizer_2=tok2, te2_name=te2_name,
        )
        tb = tpl.load_pipeline(model_name, seed=0, device="cpu")
    parts = [("unet", tb.unet), ("vae", tb.vae), ("te", tb.text_encoder)]
    if te2_name:
        parts.append(("te2", tb.text_encoder_2))
    for part, module in parts:
        module.load_state_dict(from_jax_params(flatten_params(params[part]), module))
    return jb, tb


def jax_noise(seed, shape):
    """The initial noise the JAX package's samplers draw for `seed`:
    normal(split(key(seed))[0], shape), as numpy."""
    noise_key, _ = jax.random.split(jax.random.key(seed))
    return np.array(jax.random.normal(noise_key, shape))


def run_workflow_in_both(workflow, jb, tb, monkeypatch, config=None):
    """`workflow` through the JAX package's GraphExecutor on `jb` and the
    port's on `tb`, its SaveImage turned into a PreviewImage (nothing
    written) and the port drawing the JAX package's initial noise →
    (JAX images, port images) as numpy."""
    from comfyui_distributed_tpu.graph import executor as jexec
    from comfyui_distributed_tpu_torch.graph import ExecutionContext, GraphExecutor
    from comfyui_distributed_tpu_torch.models import pipeline as tpl

    workflow = {k: dict(v) for k, v in workflow.items()}
    (sink,) = [k for k, v in workflow.items() if v["class_type"] == "SaveImage"]
    workflow[sink] = {"class_type": "PreviewImage",
                      "inputs": {"images": workflow[sink]["inputs"]["images"]}}
    ckpt = workflow["1"]["inputs"]["ckpt_name"]
    monkeypatch.setattr(tpl, "default_noise",
                        lambda seed, shape, device: torch.from_numpy(jax_noise(seed, shape)))
    jout = jexec.GraphExecutor(jexec.ExecutionContext(config=config, pipelines={ckpt: jb}))
    tout = GraphExecutor(ExecutionContext(device="cpu", config=config, pipelines={ckpt: tb}))
    return (np.asarray(jout.execute(workflow)[sink][0]["images"]),
            tout.execute(workflow)[sink][0]["images"].numpy())


def jax_step_noise(key, sampler):
    """The step noise the JAX package's stochastic `sampler` draws from
    `key` (its anc_key), as the port's StepNoise callable: each step
    splits the chain's key two ways (three for dpmpp_sde), keeps the
    first as the chain's and draws slot s from normal(subkey s + 1)."""
    arity = 3 if sampler == "dpmpp_sde" else 2
    subs = []
    chain = [key]

    def draw(step, slot, like):
        while len(subs) <= step:
            parts = jax.random.split(chain[0], arity)
            chain[0] = parts[0]
            subs.append(parts[1:])
        return torch.from_numpy(np.array(
            jax.random.normal(subs[step][slot], tuple(like.shape), jnp.float32))).to(like.device)

    return draw


class JaxTileNoise:
    """The JAX package's tile noise as the port's tile-noise seam: tile
    g's key is fold_in(key(seed), g), split into its initial noise key
    and its samplers' step-noise key."""

    def __init__(self, seed, sampler="euler"):
        self.key = jax.random.key(seed)
        self.sampler = sampler

    def _keys(self, tile_index):
        return jax.random.split(jax.random.fold_in(self.key, tile_index))

    def __call__(self, tile_index, shape):
        return torch.from_numpy(np.array(jax.random.normal(self._keys(tile_index)[0], shape)))

    def step_noise(self, tile_index):
        return jax_step_noise(self._keys(tile_index)[1], self.sampler)


def controlnet_pair(model_channels=32, downscale=8, seed=5):
    """(JAX ControlNetBundle, port ControlNetBundle on the CPU) at f32 with
    the same numpy-seeded weights, the output conv non-zero (a fresh
    ControlNet adds zero)."""
    from comfyui_distributed_tpu.models import controlnet as jcn
    from comfyui_distributed_tpu_torch.models import controlnet as tcn
    from comfyui_distributed_tpu_torch.models.io import from_jax_params

    module = jcn.ControlNetEncoder(jcn.ControlNetConfig(
        model_channels=model_channels, downscale=downscale, dtype="float32"))
    params = seeded_flax_params(module, seed, jnp.zeros((1, 64, 64, 3)))
    assert np.abs(np.asarray(params["params"]["conv_out"]["kernel"])).max() > 0
    port = tcn.ControlNetEncoder(tcn.ControlNetConfig(model_channels=model_channels,
                                                      downscale=downscale, dtype="float32"))
    port.load_state_dict(from_jax_params(flatten_params(params), port))
    return (jcn.ControlNetBundle(name="tile", module=module, params=params),
            tcn.ControlNetBundle("tile", port.eval().requires_grad_(False), torch.device("cpu")))


def upscaler_pair(name="4x-generic", seed=21):
    """(JAX UpscaleModelBundle, port UpscaleModelBundle on the CPU) at f32
    with the same numpy-seeded weights, the tail non-zero (a fresh
    upscaler is exactly a linear resize)."""
    from comfyui_distributed_tpu.models import upscaler as jupm
    from comfyui_distributed_tpu_torch.models import upscaler as tupm
    from comfyui_distributed_tpu_torch.models.io import from_jax_params

    scale = tupm.scale_of(name)
    module = jupm.SuperResolver(jupm.UpscalerConfig(scale=scale, dtype="float32"))
    params = seeded_flax_params(module, seed, jnp.zeros((1, 16, 16, 3)))
    assert np.abs(np.asarray(params["params"]["tail"]["kernel"])).max() > 0
    port = tupm.SuperResolver(tupm.UpscalerConfig(scale=scale, dtype="float32"))
    port.load_state_dict(from_jax_params(flatten_params(params), port))
    return (jupm.UpscaleModelBundle(name=name, module=module, params=params, scale=scale),
            tupm.UpscaleModelBundle(name, port.eval().requires_grad_(False), scale,
                                    torch.device("cpu")))
