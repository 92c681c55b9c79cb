"""The port's video pipeline (models/video_pipeline.py) and flow samplers
against the JAX package's on the CPU, at f32.

- `get_flow_timesteps` bit-equal; `sample_flow`, `cfg_flow_model` (one
  batched pass and two passes) and `sample_flow_masked` on a toy
  velocity model within 1e-6;
- `t2v` (tiny-dit, the causal tiny-video-vae-3d), `i2v` native
  (tiny-dit-i2v: the mask and padded-clip latent joined to the input,
  the CLIP-vision tokens) and `i2v`'s masked-flow fallback (tiny-dit, the
  per-frame tiny-vae-video), each on the same numpy-seeded weights in
  both packages and fed the JAX package's noise: frames within 1e-4
  absolute (f32 summation order through the DiT, 2 Euler steps and the
  VAE; measured ~1e-6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_distributed_tpu.models import registry as jreg
from comfyui_distributed_tpu.models import text_encoder as jte
from comfyui_distributed_tpu.models import video_pipeline as jvp
from comfyui_distributed_tpu.models.io import flatten_params
from comfyui_distributed_tpu.ops import samplers as jsmp
from comfyui_distributed_tpu_torch.models import registry as treg
from comfyui_distributed_tpu_torch.models import video_pipeline as tvp
from comfyui_distributed_tpu_torch.models.io import from_jax_params
from comfyui_distributed_tpu_torch.ops import samplers as tsmp

from test_torch_parity import f32, jax_noise, seeded_flax_params


def video_pair(model: str, vae: str, monkeypatch, seed: int = 0):
    """(JAX bundle, port bundle on the CPU) of a tiny video stack in f32
    with the same numpy-seeded weights, tiny-te as the text encoder."""
    names = (model, vae, "tiny-te", "tiny-clip-vision")
    for registry in (jreg.MODEL_REGISTRY, treg.MODEL_REGISTRY):
        for name in names:
            monkeypatch.setitem(registry, name, {**registry[name],
                                                 "config": f32(registry[name]["config"])})
    dit, vae_m, te = (jreg.create_model(n) for n in (model, vae, "tiny-te"))
    cfg, vae_cfg, te_cfg = (jreg.get_config(n) for n in (model, vae, "tiny-te"))
    video_vae = jreg.model_family(vae) == "video_vae"
    dit_args = [jnp.zeros((1, 2, 4, 4, cfg.in_channels)), jnp.zeros((1,)),
                jnp.zeros((1, te_cfg.max_length, cfg.context_dim))]
    cv = None
    params = {}
    if cfg.i2v:
        cv = jreg.create_model("tiny-clip-vision")
        params["clip_vision"] = seeded_flax_params(cv, seed + 4, jnp.zeros((1, 32, 32, 3)))
        dit_args.append(jnp.zeros((1, 17, cfg.img_dim)))
    params["unet"] = seeded_flax_params(dit, seed + 1, *dit_args)
    vae_in = (jnp.zeros((1, vae_cfg.temporal_downscale + 1, 32, 32, 3)) if video_vae
              else jnp.zeros((1, 32, 32, 3)))
    params["vae"] = seeded_flax_params(vae_m, seed + 2, vae_in)
    params["te"] = seeded_flax_params(te, seed + 3, jnp.zeros((1, te_cfg.max_length), jnp.int32))
    jb = jvp.VideoPipelineBundle(
        model_name=model, dit=dit, vae=vae_m, text_encoder=te, params=params,
        tokenizer=jte.Tokenizer(max_length=te_cfg.max_length, pad_id=te_cfg.pad_token_id),
        latent_channels=vae_cfg.latent_channels, latent_scale=vae_cfg.downscale,
        clip_vision=cv, temporal_scale=vae_cfg.temporal_downscale if video_vae else 1)
    tb = tvp.load_video_pipeline(model, vae_name=vae, device="cpu")
    for part, module in tb.parts().items():
        module.load_state_dict(from_jax_params(flatten_params(params[part]), module))
    return jb, tb


def jax_key_noise(seed, shape):
    """normal(key(seed), shape): the JAX t2v's and native i2v's draw."""
    return np.array(jax.random.normal(jax.random.key(seed), shape))


# --- flow samplers --------------------------------------------------------------

def test_flow_timesteps_bit_equal():
    for steps, shift in ((1, 3.0), (20, 3.0), (30, 5.0), (4, 1.0)):
        np.testing.assert_array_equal(tsmp.get_flow_timesteps(steps, shift).numpy(),
                                      np.asarray(jsmp.get_flow_timesteps(steps, shift)))


def _toy(lib):
    """v = tanh(x * (1 + t/1000)) + the mean of the context, per sample."""
    def model(x, t, ctx):
        scale = 1.0 + t.reshape((-1,) + (1,) * (x.ndim - 1)) / 1000.0
        bias = ctx.mean(axis=(1, 2)) if lib is jnp else ctx.mean(dim=(1, 2))
        return lib.tanh(x * scale) + bias.reshape((-1,) + (1,) * (x.ndim - 1))
    return model


@pytest.mark.parametrize("cfg_scale, neg_tokens", [(1.0, 3), (5.0, 3), (5.0, 5)])
def test_sample_flow_and_cfg_match_jax(cfg_scale, neg_tokens):
    """cfg 1 (positive only), cfg 5 batched (equal shapes) and in two
    passes (5 negative tokens against 3)."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 3, 4, 4, 2), dtype=np.float32)
    pos = rng.standard_normal((2, 3, 6), dtype=np.float32)
    neg = rng.standard_normal((2, neg_tokens, 6), dtype=np.float32)
    ts = jsmp.get_flow_timesteps(4, 3.0)
    ref = jsmp.sample_flow(jsmp.cfg_flow_model(_toy(jnp), cfg_scale), jnp.asarray(x), ts,
                           (jnp.asarray(pos), jnp.asarray(neg)))
    got = tsmp.sample_flow(tsmp.cfg_flow_model(_toy(torch), cfg_scale), torch.from_numpy(x),
                           tsmp.get_flow_timesteps(4, 3.0),
                           (torch.from_numpy(pos), torch.from_numpy(neg)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=0)


def test_sample_flow_masked_matches_jax():
    rng = np.random.default_rng(8)
    x, known, noise = (rng.standard_normal((1, 3, 4, 4, 2), dtype=np.float32) for _ in range(3))
    mask = np.zeros((1, 3, 1, 1, 1), np.float32)
    mask[:, 0] = 1.0
    cond = rng.standard_normal((1, 3, 6), dtype=np.float32)
    ts = jsmp.get_flow_timesteps(3, 3.0)
    ref = jsmp.sample_flow_masked(jsmp.cfg_flow_model(_toy(jnp), 4.0), jnp.asarray(x), ts,
                                  (jnp.asarray(cond), jnp.asarray(cond)), jnp.asarray(known),
                                  jnp.asarray(mask), jnp.asarray(noise))
    t = (torch.from_numpy(a) for a in (x, cond, known, mask, noise))
    x_, cond_, known_, mask_, noise_ = t
    got = tsmp.sample_flow_masked(tsmp.cfg_flow_model(_toy(torch), 4.0), x_,
                                  tsmp.get_flow_timesteps(3, 3.0), (cond_, cond_), known_, mask_,
                                  noise_)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got[:, 0].numpy(), known[:, 0], atol=1e-6)  # ends at t = 0


# --- t2v and i2v ------------------------------------------------------------------

def test_t2v_matches_jax(monkeypatch):
    """tiny-dit + the causal tiny-video-vae-3d: 5 frames of 32x32, 2
    steps, CFG 5, on the JAX package's noise for seed 4."""
    jb, tb = video_pair("tiny-dit", "tiny-video-vae-3d", monkeypatch)
    ref = np.asarray(jvp.t2v(jb, "a red kite", "blurry", frames=5, height=32, width=32, steps=2,
                             cfg_scale=5.0, seed=4))
    noise = jax_key_noise(4, (1, tb.latent_frames(5), 16, 16, 16))
    got = tvp.t2v(tb, "a red kite", "blurry", frames=5, height=32, width=32, steps=2,
                  cfg_scale=5.0, noise=torch.from_numpy(noise)).numpy()
    assert got.shape == ref.shape == (1, 5, 32, 32, 3)
    assert ref.std() > 0.01
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    with pytest.raises(ValueError, match="2n\\+1"):
        tvp.t2v(tb, "x", frames=4, height=32, width=32, steps=1)


def _first_frame(seed=11, hw=(32, 32)):
    return np.random.default_rng(seed).random((1, *hw, 3), dtype=np.float32)


def test_i2v_native_matches_jax(monkeypatch):
    """tiny-dit-i2v: the 36-channel input (noise, the 4-channel mask, the
    encoded padded clip) and CLIP-vision tokens of the first frame; 5
    frames, 2 steps, CFG 5, seed 6's JAX noise."""
    jb, tb = video_pair("tiny-dit-i2v", "tiny-video-vae-3d", monkeypatch)
    image = _first_frame()
    ref = np.asarray(jvp.i2v(jb, jnp.asarray(image), "waves", "static", frames=5, steps=2,
                             cfg_scale=5.0, seed=6))
    noise = jax_key_noise(6, (1, tb.latent_frames(5), 16, 16, 16))
    got = tvp.i2v(tb, torch.from_numpy(image), "waves", "static", frames=5, steps=2,
                  cfg_scale=5.0, noise=torch.from_numpy(noise)).numpy()
    assert got.shape == ref.shape == (1, 5, 32, 32, 3)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_i2v_fallback_matches_jax(monkeypatch):
    """tiny-dit with the per-frame tiny-vae-video: frame 0 clamped to the
    reference latent along the flow path; 3 frames (no stride), seed 2's
    JAX noise (its key split, as txt2img's)."""
    jb, tb = video_pair("tiny-dit", "tiny-vae-video", monkeypatch)
    image = _first_frame(12)
    ref = np.asarray(jvp.i2v(jb, jnp.asarray(image), "waves", frames=3, steps=2, cfg_scale=5.0,
                             seed=2))
    side = 32 // tb.latent_scale
    noise = jax_noise(2, (1, 3, side, side, 16))
    got = tvp.i2v(tb, torch.from_numpy(image), "waves", frames=3, steps=2, cfg_scale=5.0,
                  noise=torch.from_numpy(noise)).numpy()
    assert got.shape == ref.shape == (1, 3, 32, 32, 3)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
