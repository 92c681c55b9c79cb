"""SD2.1-768-v in the port against the JAX package, on the CPU in f32.

- The registry entries (`sd21`, `sd21-base`, `clip-h`, `tiny-unet-v`)
  and the default-encoder map equal the JAX package's; sd21 and clip-h
  at full width have the parameter shapes `from_jax_params` maps flax's
  onto (meta device against `jax.eval_shape`: nothing allocated), and
  narrow towers of their kinds carry the same numpy weights across.
- v-prediction: the VP sigma table and noising for "v", and the model
  function's v → eps conversion on tiny-unet-v.
- `workflows/distributed-txt2img-sd21.json`, unmodified but for the
  checkpoint (tiny-unet-v) and the size (32 px), through both packages'
  GraphExecutors.

Tolerances: f32 on both sides, a margin of about ten over the
difference measured on a CPU.
"""

import dataclasses
import functools
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
from comfyui_distributed_tpu.ops import samplers as jsmp
from comfyui_distributed_tpu_torch.models import pipeline as tpl
from comfyui_distributed_tpu_torch.models import registry as treg
from comfyui_distributed_tpu_torch.models import text_encoder as tte
from comfyui_distributed_tpu_torch.models import unet as tunet
from comfyui_distributed_tpu_torch.models.io import from_jax_params
from comfyui_distributed_tpu_torch.ops import samplers as tsmp
from comfyui_distributed_tpu_torch.ops.conditioning import Conditioning
from test_torch_parity import (  # noqa: F401  (one_torch_thread: fixture)
    jax_and_port_bundles,
    one_torch_thread,
    run_workflow_in_both,
    seeded_flax_params,
)
from test_torch_txt2img import _expected_torch_shapes

# one intra-op thread: the tiny models gain nothing from more, and the
# xdist run's processes would oversubscribe the cores
pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", ["sd21", "sd21-base", "clip-h", "tiny-unet-v"])
def test_registry_entries_equal_the_jax_packages_but_remat(name):
    jcfg = dataclasses.asdict(jreg.get_config(name))
    tcfg = dataclasses.asdict(treg.get_config(name))
    assert {k: jcfg[k] for k in tcfg} == tcfg
    assert set(jcfg) - set(tcfg) <= {"remat"}
    assert treg.model_family(name) == jreg.model_family(name)


def test_default_text_encoders_equal_the_jax_packages(monkeypatch):
    assert treg.DEFAULT_TEXT_ENCODERS == {k: v for k, v in jreg.DEFAULT_TEXT_ENCODERS.items()
                                         if k in treg.MODEL_REGISTRY}
    assert set(treg.DEFAULT_TEXT_ENCODERS) == {"sd21", "sd21-base"}
    built = []

    def on_meta(name, device, generator):
        built.append(name)
        with torch.device("meta"):
            return treg.create_model(name).requires_grad_(False)

    monkeypatch.setattr(tpl, "_build", on_meta)
    bundle = tpl.load_pipeline("sd21", device="cpu")
    assert built == ["sd21", "vae-sd", "clip-h"]
    assert bundle.te_name == "clip-h" and bundle.text_encoder_2 is None
    assert bundle.tokenizer.pad_id == 0 and tpl.model_schedule_info(bundle) == "v"


@pytest.mark.parametrize("name", ["sd21", "clip-h"])
def test_full_width_parameter_shapes_equal_the_jax_packages(name):
    jm = jreg.create_model(name)
    if name == "sd21":
        args = (jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)), jnp.zeros((1, 77, 1024)))
    else:
        args = (jnp.zeros((1, 77), jnp.int32),)
    expected = _expected_torch_shapes(jax.eval_shape(jm.init, jax.random.key(0), *args))
    with torch.device("meta"):
        tm = treg.create_model(name)
    shapes = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert shapes == expected
    n = sum(np.prod(s) for s in shapes.values())
    assert n > (8.6e8 if name == "sd21" else 3.5e8)  # SD2.1's UNet, OpenCLIP-H's text tower


def test_a_narrow_clip_h_tower_carries_and_matches():
    kw = {**dataclasses.asdict(jreg.get_config("clip-h")), "width": 64, "layers": 3,
          "heads": 2, "proj_dim": 48, "max_length": 16, "dtype": "float32"}
    jm = jte.TextEncoder(jte.TextEncoderConfig(**kw))
    tokens = np.array([[49406, 320, 1125, 49407] + [0] * 12], np.int32)
    params = seeded_flax_params(jm, 2, jnp.asarray(tokens))
    tm = tte.TextEncoder(tte.TextEncoderConfig(**kw))
    tm.load_state_dict(from_jax_params(flatten_params(params), tm))
    ref = jax.jit(functools.partial(jm.apply, eos_id=49407))(params, jnp.asarray(tokens))
    with torch.no_grad():
        got = tm(torch.from_numpy(tokens).long(), eos_id=49407)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5, rtol=0)


def test_a_narrow_sd21_unet_carries_and_matches():
    kw = {**dataclasses.asdict(jreg.get_config("sd21")), "model_channels": 32,
          "channel_mult": (1, 2), "num_res_blocks": 1, "transformer_depth": (1, 1),
          "context_dim": 48, "head_dim": 16, "dtype": "float32", "remat": False}
    jm = junet.UNet(junet.UNetConfig(**kw))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 4, 4, 4), dtype=np.float32)
    t = np.asarray([17.0, 981.0], np.float32)
    ctx = rng.standard_normal((2, 77, 48), dtype=np.float32)
    params = seeded_flax_params(jm, 5, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    ref = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx)))
    del kw["remat"]
    tm = tunet.UNet(tunet.UNetConfig(**kw))
    tm.load_state_dict(from_jax_params(flatten_params(params), tm))
    with torch.no_grad():
        out = tm.eval()(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx))
    np.testing.assert_allclose(out.numpy(), ref, atol=3e-5, rtol=0)


@pytest.mark.parametrize("denoise", [1.0, 0.35])
def test_v_models_use_the_vp_table_and_noising(denoise):
    ref = np.asarray(jsmp.get_model_sigmas("v", "karras", 20, denoise=denoise))
    got = tsmp.get_model_sigmas("v", "karras", 20, denoise=denoise)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), tsmp.get_model_sigmas("eps", "karras", 20,
                                                                     denoise=denoise).numpy())
    z, n = np.ones((1, 2, 2, 4), np.float32), np.full((1, 2, 2, 4), 0.5, np.float32)
    np.testing.assert_array_equal(
        tsmp.noise_latents("v", torch.from_numpy(z), torch.from_numpy(n), got[0]).numpy(),
        np.asarray(jsmp.noise_latents("v", jnp.asarray(z), jnp.asarray(n), ref[0])))
    # the flow table is another one (ported since Flux), within [0, 1]
    flow = tsmp.get_model_sigmas("flow", "karras", 20, denoise=denoise)
    np.testing.assert_array_equal(flow.numpy(), np.asarray(
        jsmp.get_model_sigmas("flow", "karras", 20, denoise=denoise)))
    assert float(flow[0]) <= 1.0 and not torch.equal(flow, got)


@pytest.fixture(scope="module")
def pair():
    return jax_and_port_bundles("tiny-unet-v")


def test_v_to_eps_matches_jax(pair):
    jb, tb = pair
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 4, 4, 4), dtype=np.float32) * 5.0
    sigma = np.asarray([14.6, 0.03], np.float32)
    ctx = rng.standard_normal((1, 16, 64), dtype=np.float32)
    model_fn = jpl._make_model_fn(jb, jb.params)
    ref = np.asarray(jax.jit(model_fn)(jnp.asarray(x), jnp.asarray(sigma), jnp.asarray(ctx)))
    got = tpl._make_model_fn(tb)(torch.from_numpy(x), torch.from_numpy(sigma),
                                 Conditioning(torch.from_numpy(ctx)))
    np.testing.assert_allclose(got.numpy(), ref, atol=3e-5, rtol=0)
    # eps = x s/(s^2+1) + v/sqrt(s^2+1), v the UNet's output
    s = torch.from_numpy(sigma).reshape(-1, 1, 1, 1)
    with torch.no_grad():
        v = tb.unet(torch.from_numpy(x) / torch.sqrt(s**2 + 1), tsmp.sigma_to_timestep(
            torch.from_numpy(sigma)), torch.from_numpy(ctx).expand(2, -1, -1))
    torch.testing.assert_close(got, torch.from_numpy(x) * s / (s**2 + 1) + v / torch.sqrt(s**2 + 1),
                               atol=1e-5, rtol=0)


def test_sd21_workflow_matches_the_jax_executor(pair, monkeypatch):
    with open(os.path.join(REPO, "workflows", "distributed-txt2img-sd21.json"),
              encoding="utf-8") as fh:
        workflow = json.load(fh)
    workflow["1"]["inputs"]["ckpt_name"] = "tiny-unet-v"
    workflow["4"]["inputs"].update(width=32, height=32)
    jb, tb = pair
    ref, got = run_workflow_in_both(workflow, jb, tb, monkeypatch)
    assert got.shape == ref.shape == (1, 32, 32, 3)
    assert got.std() > 0.01
    np.testing.assert_allclose(got, ref, atol=3e-5, rtol=0)  # measured 3.0e-6
