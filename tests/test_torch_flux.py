"""The port's Flux path against the JAX package's on the CPU, at f32.

Both packages get the same numpy-seeded weights (the JAX trees carried by
`from_jax_params`) and the same inputs:

- the tiny-flux MMDiT forward, with and without the distilled guidance
  and Kontext's reference latents (an odd reference grid included), and
  `rope_freqs_image`;
- every flow schedule and scheduler, the flow noising, euler_ancestral's
  RF rule on a toy model (the JAX key splits replayed) and the refusal of
  the other stochastic samplers; `percent_to_sigma` on the flow table;
- ModelSamplingFlux, BasicScheduler and BetaSamplingScheduler on its
  bundle;
- `flux_schedule` and `t5_encoder_schedule`: the published key names of
  the JAX schedules at full width, and a synthesized Flux file loaded by
  both packages;
- the plain attention at D=128 against the JAX package's Pallas kernel
  in interpret mode;
- the four bundled Flux workflows, repointed to the tiny models at 32
  px, through both executors; and USDU's tile path on tiny-flux with
  reference latents.

Tolerances are stated per test; f32 sums in another order put the two
packages ~1e-6 apart per operation.
"""

import copy
import dataclasses
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_distributed_tpu.graph import nodes_loaders as jnl
from comfyui_distributed_tpu.models import pipeline as jpl
from comfyui_distributed_tpu.models import registry as jreg
from comfyui_distributed_tpu.models import sd_checkpoint as jsdc
from comfyui_distributed_tpu.models import t5_encoder as jt5
from comfyui_distributed_tpu.models import text_encoder as jte
from comfyui_distributed_tpu.models.io import flatten_params
from comfyui_distributed_tpu.models.mmdit import rope_freqs_image as jrope
from comfyui_distributed_tpu.ops import attention as jattn
from comfyui_distributed_tpu.ops import samplers as jsmp
from comfyui_distributed_tpu.ops import upscale as jup
from comfyui_distributed_tpu.ops.conditioning import Conditioning as JCond
from comfyui_distributed_tpu_torch.graph import nodes_custom_sampling as tcs
from comfyui_distributed_tpu_torch.graph import nodes_loaders as tnl
from comfyui_distributed_tpu_torch.models import pipeline as tpl
from comfyui_distributed_tpu_torch.models import registry as treg
from comfyui_distributed_tpu_torch.models import sd_checkpoint as tsdc
from comfyui_distributed_tpu_torch.models.io import from_jax_params
from comfyui_distributed_tpu_torch.models.mmdit import rope_freqs_image as trope
from comfyui_distributed_tpu_torch.ops import attention as tattn
from comfyui_distributed_tpu_torch.ops import samplers as tsmp
from comfyui_distributed_tpu_torch.ops import upscale as tup
from comfyui_distributed_tpu_torch.ops.conditioning import Conditioning as TCond

from test_torch_parity import (  # noqa: F401  (one_torch_thread: fixture)
    JaxTileNoise,
    f32,
    jax_noise,
    jax_step_noise,
    one_torch_thread,
    seeded_flax_params,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLUX_NAMES = ("tiny-flux", "tiny-vae-flux", "tiny-t5-shared", "tiny-te")
STOCHASTIC = ("euler_ancestral", "dpm_2_ancestral", "dpmpp_2s_ancestral", "dpmpp_sde",
              "dpmpp_2m_sde", "lcm")


@pytest.fixture(autouse=True)
def no_spm(monkeypatch):
    monkeypatch.delenv("CDT_T5_SPM", raising=False)


def flux_pair(seed=0):
    """(JAX bundle, port bundle on the CPU) of tiny-flux in f32 with the
    same numpy-seeded weights: MMDiT (every bias and norm scale non-zero
    or off 1), the 16-channel VAE, the T5 and the CLIP tower."""
    with pytest.MonkeyPatch.context() as mp:
        for registry in (jreg.MODEL_REGISTRY, treg.MODEL_REGISTRY):
            for name in FLUX_NAMES:
                mp.setitem(registry, name, {**registry[name],
                                            "config": f32(registry[name]["config"])})
        unet, vae, te, te2 = (jreg.create_model(n) for n in FLUX_NAMES)
        cfg, t5_cfg, te2_cfg = (jreg.get_config(n) for n in ("tiny-flux", "tiny-t5-shared",
                                                             "tiny-te"))
        tokens = jnp.zeros((1, 16), jnp.int32)
        params = {
            "unet": seeded_flax_params(unet, seed + 1, jnp.zeros((1, 8, 8, 16)), jnp.zeros((1,)),
                                       jnp.zeros((1, 16, cfg.context_dim)),
                                       y=jnp.zeros((1, cfg.vec_dim))),
            "vae": seeded_flax_params(vae, seed + 2, jnp.zeros((1, 32, 32, 3))),
            "te": seeded_flax_params(te, seed + 3, tokens),
            "te2": seeded_flax_params(te2, seed + 4, tokens),
        }
        jb = jpl.PipelineBundle(
            model_name="tiny-flux", unet=unet, vae=vae, text_encoder=te, params=params,
            tokenizer=jt5.T5Tokenizer(max_length=t5_cfg.max_length,
                                      vocab_size=t5_cfg.vocab_size),
            latent_channels=16, latent_scale=jreg.get_config("tiny-vae-flux").downscale,
            text_encoder_2=te2,
            tokenizer_2=jte.Tokenizer(max_length=te2_cfg.max_length, pad_id=te2_cfg.pad_token_id),
            te_name="tiny-t5-shared", te2_name="tiny-te",
        )
        tb = tpl.load_pipeline("tiny-flux", device="cpu")
    for part, module in tb.parts().items():
        module.load_state_dict(from_jax_params(flatten_params(params[part]), module))
    return jb, tb


@pytest.fixture(scope="module")
def pair():
    return flux_pair()


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# --- the MMDiT ---------------------------------------------------------------------

def _forward_inputs(seed=3, b=2, hw=(4, 6)):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, *hw, 16), dtype=np.float32)
    t = np.array([0.7, 0.25][:b], np.float32)
    ctx = rng.standard_normal((b, 16, 64), dtype=np.float32)
    y = rng.standard_normal((b, 64), dtype=np.float32)
    return x, t, ctx, y


REF_CASES = {
    "plain": dict(),
    "guidance": dict(guidance=True),
    "one_reference": dict(refs=[(4, 6)]),
    "guidance_and_an_odd_reference": dict(guidance=True, refs=[(4, 4), (5, 3)]),
}


@pytest.mark.parametrize("case", sorted(REF_CASES))
def test_mmdit_forward_matches_jax(pair, case):
    """The velocity of a [2, 4, 6, 16] latent over 16 text tokens; the
    guidance a per-sample [2] vector, the references [2, h, w, 16] (a 5x3
    grid edge-padded to 6x4). 1e-4 absolute on outputs of |x| ~ 3.9: f32
    summation order over the 2-block net [measured 1.6e-5 - 2.2e-5]."""
    jb, tb = pair
    spec = REF_CASES[case]
    x, t, ctx, y = _forward_inputs()
    rng = np.random.default_rng(17)
    g = np.array([1.5, 4.0], np.float32) if spec.get("guidance") else None
    refs = [rng.standard_normal((2, h, w, 16), dtype=np.float32) for h, w in spec.get("refs", [])]
    jkw, tkw = {}, {}
    if g is not None:
        jkw["guidance"], tkw["guidance"] = jnp.asarray(g), torch.from_numpy(g)
    if refs:
        jkw["ref_latents"] = [jnp.asarray(r) for r in refs]
        tkw["ref_latents"] = [torch.from_numpy(r) for r in refs]
    ref = np.asarray(jax.jit(jb.unet.apply)(jb.params["unet"], jnp.asarray(x), jnp.asarray(t),
                                            jnp.asarray(ctx), y=jnp.asarray(y), **jkw))
    with torch.no_grad():
        got = tb.unet(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
                      y=torch.from_numpy(y), **tkw).numpy()
    assert got.shape == ref.shape == x.shape
    assert np.abs(ref).max() > 0.5
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_guidance_and_references_change_the_velocity(pair):
    """Each input the cases above feed reaches the output (else their
    parity would hold vacuously)."""
    _, tb = pair
    x, t, ctx, y = (torch.from_numpy(a) for a in _forward_inputs())
    with torch.no_grad():
        base = tb.unet(x, t, ctx, y=y)
        guided = tb.unet(x, t, ctx, y=y, guidance=torch.tensor([1.5, 4.0]))
        ref = torch.linspace(0, 1, 2 * 4 * 6 * 16).reshape(2, 4, 6, 16)
        with_ref = tb.unet(x, t, ctx, y=y, ref_latents=[ref])
        with_two = tb.unet(x, t, ctx, y=y, ref_latents=[ref, ref.flip(1)])
    for a, b in ((base, guided), (base, with_ref), (with_ref, with_two)):
        assert float((a - b).abs().max()) > 1e-3


def test_mmdit_rejects_a_controlnet_residual(pair):
    _, tb = pair
    x, t, ctx, y = (torch.from_numpy(a) for a in _forward_inputs())
    with pytest.raises(ValueError, match="ControlNet"):
        tb.unet(x, t, ctx, y=y, control=torch.zeros_like(x))


@pytest.mark.parametrize("txt_len, gh, gw, refs", [
    (16, 2, 3, ()), (512, 64, 64, ()), (512, 64, 64, ((64, 64),)), (7, 5, 2, ((3, 2), (1, 4))),
])
def test_rope_freqs_image_equal_jax(txt_len, gh, gw, refs):
    """The same numpy on both sides: equal to the last bit, text at the
    identity, references at axis-0 index 1 + i."""
    for axes in ((16, 56, 56), (4, 6, 6)):
        a = trope(axes, txt_len, gh, gw, ref_grids=refs)
        np.testing.assert_array_equal(a, jrope(axes, txt_len, gh, gw, ref_grids=refs))
        assert a.shape == (txt_len + gh * gw + sum(h * w for h, w in refs), sum(axes) // 2, 2)
        np.testing.assert_array_equal(a[:txt_len, :, 0], 1.0)


def test_plain_attention_at_d128_matches_the_pallas_kernel():
    """N = M = 256, D = 128: the TPU kernel's own width (no padding), in
    interpret mode, as the JAX package's own tests run it on the CPU.
    2e-5 absolute: f32 summation order."""
    rng = np.random.default_rng(128)
    q, k, v = (rng.standard_normal((1, 256, 2, 128), dtype=np.float32) for _ in range(3))
    ref = np.asarray(jattn.flash_attention(*(jnp.asarray(a) for a in (q, k, v)), interpret=True))
    got = tattn.dot_product_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=0)
    assert tattn.flash_attention.launches == 0


# --- flow schedules and samplers -------------------------------------------------------

@pytest.mark.parametrize("scheduler", jsmp.SCHEDULER_NAMES)
def test_flow_sigmas_equal_jax_for_every_scheduler(scheduler):
    """Bit for bit at each shift the path uses (1 = schnell, 3 = dev,
    ModelSamplingFlux's exp(1.15) at 1024 px), steps and denoise."""
    for shift in (1.0, 3.0, math.exp(1.15), 2.5):
        for steps, denoise in ((1, 1.0), (4, 1.0), (20, 1.0), (8, 0.5), (20, 0.35)):
            ref = np.asarray(jsmp.get_model_sigmas("flow", scheduler, steps, denoise=denoise,
                                                   flow_shift=shift))
            got = tsmp.get_model_sigmas("flow", scheduler, steps, denoise=denoise,
                                        flow_shift=shift)
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), ref, err_msg=f"{shift} {steps} {denoise}")
    np.testing.assert_array_equal(tsmp._flow_sigma_table(3.0), jsmp._flow_sigma_table(3.0))


def test_flow_percent_to_sigma_and_noising_match_jax():
    for p in (0.0, 0.1, 0.5, 0.93, 1.0):
        for shift in (1.0, 3.0):
            assert tsmp.percent_to_sigma(p, "flow", shift) == jsmp.percent_to_sigma(p, "flow",
                                                                                    shift)
    rng = np.random.default_rng(2)
    z, n = (rng.standard_normal((1, 4, 4, 16), dtype=np.float32) for _ in range(2))
    s = np.float32(0.37)
    np.testing.assert_array_equal(
        tsmp.noise_latents("flow", torch.from_numpy(z), torch.from_numpy(n), torch.tensor(s)),
        np.asarray(jsmp.noise_latents("flow", jnp.asarray(z), jnp.asarray(n), s)))
    with pytest.raises(NotImplementedError, match="not supported"):
        tsmp.get_model_sigmas("edm", "karras", 4)


def _toy_jax(x, sigma_batch, cond):
    sig = sigma_batch.reshape((-1, 1, 1, 1))
    return jnp.tanh(0.7 * x - 0.2 * sig) * 0.6 + 0.3 * cond


def _toy_torch(x, sigma_batch, cond):
    sig = sigma_batch.reshape((-1, 1, 1, 1))
    return torch.tanh(0.7 * x - 0.2 * sig) * 0.6 + 0.3 * cond


@pytest.mark.parametrize("sampler", ["euler", "euler_ancestral", "heun", "dpmpp_2m", "ddim",
                                     "lms"])
def test_flow_trajectories_follow_jax_on_a_toy_model(sampler):
    """From pure noise at sigma 1 down the dev schedule, euler_ancestral
    through the RF rule with the JAX key splits replayed; 1e-5 absolute
    (f32 transcendentals)."""
    rng = np.random.default_rng(5)
    sigmas = np.array(jsmp.get_model_sigmas("flow", "simple", 6, flow_shift=3.0))
    x = rng.standard_normal((2, 4, 4, 3)).astype(np.float32)
    cond = rng.standard_normal((2, 4, 4, 3)).astype(np.float32)
    key = jax.random.key(9)
    stochastic = sampler in STOCHASTIC
    ref = np.asarray(jsmp.sample(_toy_jax, jnp.asarray(x), jnp.asarray(sigmas),
                                 jnp.asarray(cond), sampler,
                                 noise_key=key if stochastic else None, flow=True))
    got = tsmp.sample(_toy_torch, torch.from_numpy(x), torch.from_numpy(sigmas),
                      torch.from_numpy(cond), sampler,
                      noise=jax_step_noise(key, sampler) if stochastic else None, flow=True)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)
    if stochastic:
        vp = tsmp.sample(_toy_torch, torch.from_numpy(x), torch.from_numpy(sigmas),
                         torch.from_numpy(cond), sampler, noise=jax_step_noise(key, sampler))
        assert float((vp - got).abs().max()) > 1e-2  # the RF rule is not the VE one


@pytest.mark.parametrize("sampler", [s for s in STOCHASTIC if s != "euler_ancestral"])
def test_the_other_stochastic_samplers_are_refused_for_flow(sampler):
    x, sig = torch.zeros((1, 2, 2, 3)), torch.tensor([1.0, 0.5, 0.0])
    with pytest.raises(ValueError, match="rectified-flow"):
        tsmp.sample(_toy_torch, x, sig, x, sampler, noise=lambda i, s, like: like, flow=True)
    with pytest.raises(ValueError, match="rectified-flow"):
        jsmp.sample(_toy_jax, jnp.zeros((1, 2, 2, 3)), jnp.asarray(sig.numpy()),
                    jnp.zeros((1, 2, 2, 3)), sampler, noise_key=jax.random.key(0), flow=True)


@pytest.mark.parametrize("width, height, max_shift, base_shift", [
    (1024, 1024, 1.15, 0.5), (1008, 1008, 1.15, 0.5), (512, 768, 1.15, 0.5), (256, 256, 2.0, 0.3),
])
def test_model_sampling_flux_matches_jax(pair, width, height, max_shift, base_shift):
    """The shift to the last bit, and the schedules it shapes."""
    jb, tb = pair
    (jm,) = jnl.ModelSamplingFlux().patch(jb, max_shift, base_shift, width, height)
    (tm,) = tnl.ModelSamplingFlux().patch(tb, max_shift, base_shift, width, height)
    assert tm.flow_shift_override == jm.flow_shift_override
    assert tb.flow_shift_override is None  # the cached bundle keeps no patch
    from comfyui_distributed_tpu.graph import nodes_custom_sampling as jcs

    for scheduler in ("simple", "beta", "karras"):
        np.testing.assert_array_equal(
            tcs.BasicScheduler().get_sigmas(tm, scheduler, 20, 1.0)[0].numpy(),
            np.asarray(jcs.BasicScheduler().get_sigmas(jm, scheduler, 20, 1.0)[0]))
    np.testing.assert_array_equal(
        tcs.BetaSamplingScheduler().get_sigmas(tm, 20, 0.6, 0.6)[0].numpy(),
        np.asarray(jcs.BetaSamplingScheduler().get_sigmas(jm, 20, 0.6, 0.6)[0]))


def test_flux_patches_and_schedulers_refuse_what_they_do_not_take(pair):
    _, tb = pair
    vp = tpl.load_unet("tiny-unet", device="cpu")
    with pytest.raises(ValueError, match="flow-matching"):
        tnl.ModelSamplingFlux().patch(vp)
    with pytest.raises(ValueError, match="BasicScheduler"):
        tcs.SDTurboScheduler().get_sigmas(tb, 1, 1.0)
    # DualCLIPLoader's sd3 type now loads: the two CLIPs without a T5, the
    # CLIP sequence alone at the SD3 backbone's context width
    from comfyui_distributed_tpu_torch.graph import ExecutionContext

    (sd3,) = tnl.DualCLIPLoader().load_clip("tiny-te-g", "tiny-te-l", type="sd3",
                                            context=ExecutionContext(device="cpu"))
    assert (sd3.model_name, sd3.te_name, sd3.te2_name, sd3.text_encoder_3) == (
        "tiny-sd3", "tiny-te-l", "tiny-te-g", None)
    cond = tpl.encode_text_pooled(sd3, ["a prompt"])
    assert tuple(cond.context.shape) == (1, 16, 160) and tuple(cond.pooled.shape) == (1, 160)


# --- checkpoint schedules ------------------------------------------------------------

@pytest.mark.parametrize("name, schedule", [
    ("flux-dev", "flux_schedule"), ("flux-schnell", "flux_schedule"),
    ("t5-xxl", "t5_encoder_schedule"),
])
def test_schedules_name_the_jax_packages_keys_at_full_width(name, schedule):
    """Every published key of the full-width schedule, and each one's
    parameter under the port's naming rule (flax path → torch name)."""
    jcfg, tcfg = jreg.get_config(name), treg.get_config(name)
    for prefix in ("", "model.diffusion_model.") if schedule == "flux_schedule" else ("",):
        jexp = jsdc._expand(getattr(jsdc, schedule)(jcfg, prefix=prefix))
        texp = tsdc._expand(getattr(tsdc, schedule)(tcfg, prefix=prefix))
        assert [k for k, _, _ in texp] == [k for k, _, _ in jexp]
        for (_, tname, _), (_, jpath, _) in zip(texp, jexp):
            parts = jpath.split("/")
            leaf = {"kernel": "weight", "scale": "weight", "embedding": "weight"}.get(parts[-1],
                                                                                     parts[-1])
            assert tname == ".".join(parts[:-1] + [leaf])
    with torch.device("meta"):
        module = treg.create_model(name)
    names = {n for _, n, _ in tsdc._expand(getattr(tsdc, schedule)(tcfg))}
    assert names == set(module.state_dict())


def test_a_flux_file_set_loads_in_both_packages(pair, tmp_path, monkeypatch):
    """The JAX package synthesizes a flux1-style transformer file (bare
    keys), a T5 file and an AE file from its tiny-flux weights; the port's
    load_pipeline reads them from CDT_CHECKPOINT_DIR into the modules
    from_jax_params fills, exactly."""
    jb, tb = pair
    files = {
        "tiny-flux": jsdc.synthesize_state_dict(flatten_params(jb.params["unet"]),
                                                jsdc.flux_schedule(jreg.get_config("tiny-flux"))),
        "tiny-t5-shared": jsdc.synthesize_state_dict(
            flatten_params(jb.params["te"]),
            jsdc.t5_encoder_schedule(jreg.get_config("tiny-t5-shared"))),
    }
    for stem, state in files.items():
        tsdc.save_safetensors({k: torch.from_numpy(np.array(v)) for k, v in state.items()},
                              str(tmp_path / f"{stem}.safetensors"))
    monkeypatch.setenv("CDT_CHECKPOINT_DIR", str(tmp_path))
    with pytest.MonkeyPatch.context() as mp:
        for name in FLUX_NAMES:
            entry = treg.MODEL_REGISTRY[name]
            mp.setitem(treg.MODEL_REGISTRY, name, {**entry, "config": f32(entry["config"])})
        loaded = tpl.load_pipeline("tiny-flux", device="cpu")
        unet_only = tpl.load_unet("tiny-flux", device="cpu")
        clip = tpl.load_clip(["tiny-te", "tiny-t5-shared"], layout="flux", device="cpu")
    for module, want in ((loaded.unet, tb.unet), (unet_only.unet, tb.unet),
                         (loaded.text_encoder, tb.text_encoder),
                         (clip.text_encoder, tb.text_encoder)):
        got = module.state_dict()
        for key, value in want.state_dict().items():
            torch.testing.assert_close(got[key], value, rtol=0, atol=0, msg=key)
    assert tsdc.checkpoint_layout(files["tiny-flux"]) == "flux"
    # an SD3 file is a layout of its own now, bare or nested
    for key in ("joint_blocks.0.x_block.attn.qkv.weight",
                "model.diffusion_model.joint_blocks.0.x_block.attn.qkv.weight"):
        assert tsdc.checkpoint_layout({key: None}) == "sd3"
    # a WAN file too, since the video slice: bare or nested
    for key in ("blocks.0.self_attn.q.weight",
                "model.diffusion_model.blocks.0.self_attn.q.weight"):
        assert tsdc.checkpoint_layout({key: None}) == "wan"


# --- conditioning, workflows and USDU -----------------------------------------------------

def test_flux_conditioning_matches_jax(pair):
    """T5 context and CLIP pooled, one prompt and the two of
    CLIPTextEncodeFlux; 2e-5 absolute (f32)."""
    jb, tb = pair
    for jc, tc in (
        (jpl.encode_text_pooled(jb, ["a fox in the snow"]),
         tpl.encode_text_pooled(tb, ["a fox in the snow"])),
        (jpl.encode_text_pooled_flux(jb, ["a red fox on a log"], ["cinematic"], guidance=3.5),
         tpl.encode_text_pooled_flux(tb, ["a red fox on a log"], ["cinematic"], guidance=3.5)),
    ):
        assert tc.context.shape == (1, 16, 64) and tc.pooled.shape == (1, 64)
        np.testing.assert_allclose(_np(tc.context), np.asarray(jc.context), atol=2e-5, rtol=0)
        np.testing.assert_allclose(_np(tc.pooled), np.asarray(jc.pooled), atol=2e-5, rtol=0)
        assert tc.guidance == jc.guidance


FLUX_WORKFLOWS = ("distributed-txt2img-flux.json", "distributed-flux-custom-sampling.json",
                  "distributed-flux-dual-prompt.json", "distributed-kontext-edit.json")
TINY = {"flux-schnell": "tiny-flux", "flux-dev": "tiny-flux", "clip-l": "tiny-te",
        "t5-xxl": "tiny-t5-shared", "vae-flux": "tiny-vae-flux"}


def tiny_flux_workflow(name, px=32, steps=2):
    """A bundled Flux workflow on the tiny models at `px` (its loaders'
    names, its latent and ModelSamplingFlux sizes, its step counts), its
    SaveImage a PreviewImage."""
    with open(os.path.join(REPO, "workflows", name), encoding="utf-8") as fh:
        workflow = json.load(fh)
    for node in workflow.values():
        inputs = node["inputs"]
        for key in ("ckpt_name", "unet_name", "clip_name1", "clip_name2", "vae_name"):
            if key in inputs:
                inputs[key] = TINY[inputs[key]]
        for key in ("width", "height"):
            if key in inputs:
                inputs[key] = px
        if "steps" in inputs:
            inputs["steps"] = steps
        if node["class_type"] == "SaveImage":
            node["class_type"] = "PreviewImage"
            del inputs["filename_prefix"]
    return workflow


def run_flux_workflow_in_both(workflow, jb, tb, monkeypatch, tmp_path):
    """`workflow` through both GraphExecutors: every loader resolves to the
    pair's bundles, the port draws the JAX package's initial noise, a
    LoadImage reads a seeded 32-px reference.png → (JAX, port) images."""
    from comfyui_distributed_tpu.graph import executor as jexec
    from comfyui_distributed_tpu_torch.graph import ExecutionContext, GraphExecutor
    from comfyui_distributed_tpu_torch.utils import image as img_utils

    pixels = np.random.default_rng(31).uniform(size=(32, 32, 3)).astype(np.float32)
    (tmp_path / "reference.png").write_bytes(img_utils.encode_png(pixels))
    monkeypatch.setenv("CDT_INPUT_DIR", str(tmp_path))
    monkeypatch.setattr(tpl, "default_noise",
                        lambda seed, shape, device: torch.from_numpy(jax_noise(seed, shape)))
    monkeypatch.setattr(jpl, "load_vae", lambda name, **kw: jb)
    monkeypatch.setattr(tpl, "load_vae", lambda name, **kw: tb)
    keys = ("tiny-flux", "unet:tiny-flux", "clip:flux:tiny-te,tiny-t5-shared")
    (sink,) = [k for k, v in workflow.items() if v["class_type"] == "PreviewImage"]
    jout = jexec.GraphExecutor(jexec.ExecutionContext(pipelines=dict.fromkeys(keys, jb)))
    tout = GraphExecutor(ExecutionContext(device="cpu", pipelines=dict.fromkeys(keys, tb)))
    return (np.asarray(jout.execute(workflow)[sink][0]["images"]),
            tout.execute(workflow)[sink][0]["images"].numpy())


@pytest.mark.parametrize("name", FLUX_WORKFLOWS)
def test_the_bundled_flux_workflows_match_jax(pair, name, monkeypatch, tmp_path):
    """Each workflow's image at 32 px, 2 steps: 1e-4 absolute on [0, 1]
    pixels (f32 through the MMDiT, the sampler and the VAE decode;
    measured 2.7e-6 - 7.2e-6), and the image is not flat."""
    jb, tb = pair
    ref, got = run_flux_workflow_in_both(tiny_flux_workflow(name), jb, tb, monkeypatch, tmp_path)
    assert got.shape == ref.shape == (1, 32, 32, 3)
    assert float(ref.std()) > 0.01
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_kontext_without_its_reference_differs(pair, monkeypatch, tmp_path):
    """The Kontext workflow with ReferenceLatent bypassed (FluxGuidance
    reads the text conditioning): the image moves, so the reference is
    read."""
    jb, tb = pair
    workflow = tiny_flux_workflow("distributed-kontext-edit.json")
    plain = copy.deepcopy(workflow)
    guidance = next(k for k, v in plain.items() if v["class_type"] == "FluxGuidance")
    ref_node = next(k for k, v in plain.items() if v["class_type"] == "ReferenceLatent")
    plain[guidance]["inputs"]["conditioning"] = plain[ref_node]["inputs"]["conditioning"]
    _, with_ref = run_flux_workflow_in_both(workflow, jb, tb, monkeypatch, tmp_path)
    _, without = run_flux_workflow_in_both(plain, jb, tb, monkeypatch, tmp_path)
    assert np.abs(with_ref - without).max() > 1.0 / 255


def test_usdu_on_flux_with_reference_latents_matches_jax(pair):
    """The tile path on the flow family: interpolation noising, the flow
    sigmas at denoise 0.4, reference latents windowed per tile (they move
    the output by 0.04); the JAX tile keys replayed. 1e-4 absolute on
    pixels [measured 1.1e-5]."""
    jb, tb = pair
    rng = np.random.default_rng(13)
    img = rng.random((1, 64, 64, 3), dtype=np.float32)
    ref = rng.random((1, 16, 16, 16), dtype=np.float32)
    jpos = JCond(context=jpl.encode_text(jb, ["p"]), reference_latents=[jnp.asarray(ref)])
    tpos = TCond(context=tpl.encode_text(tb, ["p"]), reference_latents=[torch.from_numpy(ref)])
    kw = dict(mesh=None, upscale_by=2.0, tile=64, padding=16, steps=2, denoise=0.4, seed=3,
              sampler="euler", scheduler="simple", cfg=1.0)
    want = np.asarray(jup.run_upscale(jb, jnp.asarray(img), jpos, jpl.encode_text(jb, [""]),
                                      tile_batch=1, **kw))
    got = tup.run_upscale(tb, torch.from_numpy(img), tpos, tpl.encode_text(tb, [""]),
                          noise=JaxTileNoise(3), **kw)
    assert _np(got).shape == want.shape == (1, 128, 128, 3)
    np.testing.assert_allclose(_np(got), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("neg_refs", [True, False], ids=["batched_pair", "two_passes"])
def test_cfg_with_guidance_and_references_matches_jax(pair, neg_refs):
    """True CFG (scale 3) over a Kontext positive with FluxGuidance's
    scale: with references on both sides the pair rides one batch-2 pass,
    with them on the positive only two passes (the JAX batching rule).
    2e-4 absolute on guided velocities of |x| up to 8.7: f32 summation
    order, amplified 3x by the guidance [measured 4.0e-5 - 5.7e-5]."""
    from comfyui_distributed_tpu.ops import conditioning as jcond
    from comfyui_distributed_tpu_torch.ops import conditioning as tcond

    jb, tb = pair
    rng = np.random.default_rng(21)
    x = rng.standard_normal((1, 4, 4, 16), dtype=np.float32)
    ref = rng.standard_normal((1, 4, 4, 16), dtype=np.float32)
    sig = np.array([0.6], np.float32)

    def conds(mod, pl, b, arr):
        pos = pl.encode_text_pooled(b, ["an edit"])
        neg = pl.encode_text_pooled(b, [""])
        pos = dataclasses.replace(pos, guidance=2.5, reference_latents=[arr(ref)])
        if neg_refs:
            neg = dataclasses.replace(neg, guidance=2.5, reference_latents=[arr(ref)])
        return pos, neg

    jpos, jneg = conds(jcond, jpl, jb, jnp.asarray)
    tpos, tneg = conds(tcond, tpl, tb, torch.from_numpy)
    want = np.asarray(jpl.guided_model(jb, jb.params, 3.0)(jnp.asarray(x), jnp.asarray(sig),
                                                           (jpos, jneg)))
    got = tpl.guided_model(tb, 3.0)(torch.from_numpy(x), torch.from_numpy(sig), (tpos, tneg))
    np.testing.assert_allclose(_np(got), want, atol=2e-4, rtol=0)


def test_reference_latents_follow_tile_crops_and_batch_slices_as_in_jax():
    """crop_to_tile windows each reference in latent units after resizing
    it to the frame's latent grid; slice_batch cuts it with the batch.
    1e-5 absolute: f32 rounding of two chained linear resizes [measured
    1.2e-6]."""
    from comfyui_distributed_tpu.ops import conditioning as jcond
    from comfyui_distributed_tpu_torch.ops import conditioning as tcond

    rng = np.random.default_rng(8)
    lat = rng.standard_normal((2, 12, 10, 16), dtype=np.float32)
    ctx = np.zeros((2, 3, 8), np.float32)
    jc = jcond.Conditioning(context=jnp.asarray(ctx), reference_latents=[jnp.asarray(lat)])
    tc = tcond.Conditioning(context=torch.from_numpy(ctx), reference_latents=[torch.from_numpy(lat)])
    for y, x, th, tw in ((0, 0, 64, 64), (40, 24, 48, 64), (-16, 70, 64, 48)):
        want = jcond.crop_to_tile(jc, y, x, th, tw, 128, 112).reference_latents[0]
        got = tcond.crop_to_tile(tc, y, x, th, tw, 128, 112).reference_latents[0]
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(tcond.slice_batch(tc, 1, 1).reference_latents[0].numpy(),
                                  lat[1:2])


def test_the_clip_loaders_seed_their_towers_as_load_pipeline_does():
    """CLIPLoader's tower is load_pipeline's first text tower at the same
    seed; DualCLIPLoader sdxl takes CLIP-L and CLIP-G in either order and
    flux a CLIP and a T5 in either order (te the T5, te2 the CLIP), as
    the JAX loaders do; either gives what the checkpoint bundle encodes."""
    from comfyui_distributed_tpu_torch.graph import ExecutionContext

    context = ExecutionContext(device="cpu")
    (clip,) = tnl.CLIPLoader().load_clip("tiny_te.safetensors", context=context)
    sd = tpl.load_pipeline("tiny-unet", device="cpu")
    for key, value in sd.text_encoder.state_dict().items():
        torch.testing.assert_close(clip.text_encoder.state_dict()[key], value, rtol=0, atol=0)
    (sdxl,) = tnl.DualCLIPLoader().load_clip("tiny-te-g", "tiny-te-l", type="sdxl",
                                             context=context)
    assert (sdxl.te_name, sdxl.te2_name) == ("tiny-te-l", "tiny-te-g")
    (flux,) = tnl.DualCLIPLoader().load_clip("tiny-te", "tiny-t5-shared", type="flux",
                                             context=context)
    assert (flux.model_name, flux.te_name, flux.te2_name) == ("tiny-flux", "tiny-t5-shared",
                                                              "tiny-te")
    assert "clip:flux:tiny-te,tiny-t5-shared" in context.pipelines
    full = tpl.load_pipeline("tiny-flux", device="cpu")
    a = tpl.encode_text_pooled(flux, ["a prompt"])
    b = tpl.encode_text_pooled(full, ["a prompt"])
    torch.testing.assert_close(a.context, b.context, rtol=0, atol=0)
    torch.testing.assert_close(a.pooled, b.pooled, rtol=0, atol=0)
    with pytest.raises(ValueError, match="one T5-family and one CLIP-family"):
        tpl.load_clip(["tiny-te", "tiny-te-l"], layout="flux", device="cpu")
