"""The port against the SD-family keys of tests/golden/goldens.npz (read by
path), on the CPU.

For every key, the chain scripts/gen_goldens.py runs is run three ways:
the file's golden; the JAX package today, on the weights its own
load_pipeline makes at seed 0 (the goldens' weights); and the port in
f32 on those weights (carried by `from_jax_params`), with the JAX
package's noise replayed (initial noise, and the tile keys of the
upscale). One case per key.

Tolerances, by what each key runs through (relative to the golden's
largest |x|, floored at 1; gaps measured on a CPU in brackets):

- node math in f32 (the sigma grids, the outpaint pad and mask, the
  unsharp mask): 1e-6 [0 - 1.2e-7];
- sampled latents (the custom stages, inpaint, inpaint-model, regional,
  SDXL size conditioning): 1e-3, the golden test's own bar at scale
  (tests/golden/test_goldens.py) [port 1.5e-4, the JAX package 0]. The
  random-init UNet's out_conv is zero, so these latents follow the
  noise and the schedule; the VAE's and the conditioning's parts show;
- through a bf16 UNet or VAE decode (txt2img, v-prediction, USDU, the
  hi-res fix, the four guided evaluations): BF16_BAR, 2^-3. The tiny
  configs compute in bfloat16 in the JAX package, and the goldens were
  made so; the port computes in f32, and this process's 8-device XLA
  client moves the JAX package too (scripts/gen_goldens.py's docstring)
  [port 5.9e-2, the JAX package 3.0e-2]. For the guided keys the same
  evaluation without its patch (plain CFG) must miss the golden by more
  than twice the bar [0.25 - 0.51], so a wrong composition fails.

`sigmas_beta_12` sits on a rounding tie that the JAX package itself no
longer takes as the golden does: the case pins that gap, as
tests/test_torch_samplers.py::test_sigmas_pinned_by_the_goldens does.

The Flux keys (tiny-flux txt2img, the same at ModelSamplingFlux's shift
2.5, and a Kontext edit through ReferenceLatent) and the SD3 keys
(tiny-sd3 and the MMDiT-X tiny-sd35m: triple-encoder conditioning, true
CFG at 4 on the flow schedule) run through the bf16 MMDiT and 16-channel
VAE: BF16_BAR. So does the video key (`t2v_5f_32`: tiny-dit's bf16 DiT
and the causal tiny-video-vae-3d, 5 frames of 32 px, 2 flow steps under
CFG 5), the port fed the JAX package's noise for seed 42. A test holds
the file's keys to these.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_distributed_tpu.graph import nodes_controlnet as jctl
from comfyui_distributed_tpu.graph import nodes_core as jnc
from comfyui_distributed_tpu.graph import nodes_custom_sampling as jcs
from comfyui_distributed_tpu.models import pipeline as jpl
from comfyui_distributed_tpu.models import video_pipeline as jvp
from comfyui_distributed_tpu.models.io import flatten_params
from comfyui_distributed_tpu.ops import samplers as jsmp
from comfyui_distributed_tpu.ops import upscale as jup
from comfyui_distributed_tpu_torch.graph import ExecutionContext
from comfyui_distributed_tpu_torch.graph import nodes_controlnet as tctl
from comfyui_distributed_tpu_torch.graph import nodes_core as tnc
from comfyui_distributed_tpu_torch.graph import nodes_custom_sampling as tcs
from comfyui_distributed_tpu_torch.models import pipeline as tpl
from comfyui_distributed_tpu_torch.models import registry as treg
from comfyui_distributed_tpu_torch.models import video_pipeline as tvp
from comfyui_distributed_tpu_torch.models.io import from_jax_params
from comfyui_distributed_tpu_torch.ops import samplers as tsmp
from comfyui_distributed_tpu_torch.ops import upscale as tup
from test_torch_parity import JaxTileNoise, f32, jax_noise, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "goldens.npz")
BF16_BAR = 2.0**-3
LATENT_BAR = 1e-3
EXACT_BAR = 1e-6


@pytest.fixture(scope="module")
def goldens():
    with np.load(GOLDENS) as data:
        return {k: data[k] for k in data.files}


class Bundles:
    """The JAX package's bundles as load_pipeline(name, seed=0) makes them,
    and the port's in f32 with the same weights, built once each."""

    def __init__(self):
        self.jax, self.port = {}, {}

    def video(self):
        """gen_goldens.py's video bundle (tiny-dit, tiny-video-vae-3d at
        seed 0) and the port's in f32 with its weights."""
        key = "video:tiny-dit"
        if key not in self.jax:
            jb = jvp.load_video_pipeline("tiny-dit", vae_name="tiny-video-vae-3d")
            with pytest.MonkeyPatch.context() as mp:
                for name in ("tiny-dit", "tiny-video-vae-3d", "tiny-te"):
                    entry = treg.MODEL_REGISTRY[name]
                    mp.setitem(treg.MODEL_REGISTRY, name,
                               {**entry, "config": f32(entry["config"])})
                tb = tvp.load_video_pipeline("tiny-dit", vae_name="tiny-video-vae-3d",
                                             device="cpu")
            for part, module in tb.parts().items():
                module.load_state_dict(from_jax_params(flatten_params(jb.params[part]), module))
            self.jax[key], self.port[key] = jb, tb
        return self.jax[key], self.port[key]

    def pair(self, name):
        if name not in self.jax:
            jb = jpl.load_pipeline(name, seed=0)
            self.jax[name] = jb
            self.port[name] = port_bundle(jb)
        return self.jax[name], self.port[name]


def port_bundle(jb):
    """The port's bundle of jb.model_name on the CPU, f32, jb's weights."""
    names = [n for n in (jb.model_name, jb.te_name, jb.te2_name, jb.te3_name,
                         tpl._family_vae_name(jb.model_name)) if n]
    with pytest.MonkeyPatch.context() as mp:
        for name in names:
            entry = treg.MODEL_REGISTRY[name]
            mp.setitem(treg.MODEL_REGISTRY, name, {**entry, "config": f32(entry["config"])})
        tb = tpl.load_pipeline(jb.model_name, seed=0, device="cpu")
    for part, module in tb.parts().items():
        module.load_state_dict(from_jax_params(flatten_params(jb.params[part]), module))
    return tb


@pytest.fixture(scope="module")
def bundles():
    return Bundles()


class Side:
    """One package's modules and conversions, so a key's chain is written
    once."""

    def __init__(self, name, bundles, monkeypatch):
        self.name = name
        self.is_jax = name == "jax"
        self._bundles = bundles
        self.pl = jpl if self.is_jax else tpl
        self.core = jnc if self.is_jax else tnc
        self.custom = jcs if self.is_jax else tcs
        self.ctl = jctl if self.is_jax else tctl
        self.kw = {} if self.is_jax else {"context": ExecutionContext(device="cpu")}
        if not self.is_jax:
            # the port draws the JAX package's initial noise for a seed
            monkeypatch.setattr(tpl, "default_noise",
                                lambda seed, shape, device: torch.from_numpy(
                                    jax_noise(seed, shape)))

    def bundle(self, name):
        jb, tb = self._bundles.pair(name)
        return jb if self.is_jax else tb

    def array(self, x):
        return jnp.asarray(x) if self.is_jax else torch.from_numpy(np.array(x))


def _pix():
    return np.random.default_rng(31).uniform(size=(1, 32, 32, 3)).astype(np.float32)


def _imask():
    m = np.zeros((32, 32), np.float32)
    m[10:22, 10:22] = 1.0
    return m


def _txt2img(s, name, prompt, size, seed, cfg_scale=7.0, bundle=None, **kw):
    bundle = bundle or s.bundle(name)
    if s.is_jax:
        return s.pl.txt2img(bundle, prompt, height=size, width=size, steps=2, seed=seed,
                            cfg_scale=cfg_scale, **kw)
    # _txt2img_jit's initial noise: normal(split(key(seed), 3)[1])
    shape = (1, size // bundle.latent_scale, size // bundle.latent_scale, bundle.latent_channels)
    noise = np.array(jax.random.normal(jax.random.split(jax.random.key(seed), 3)[1], shape))
    return s.pl.txt2img(bundle, prompt, height=size, width=size, steps=2, seed=seed,
                        cfg_scale=cfg_scale, noise=torch.from_numpy(noise), **kw)


def k_txt2img_64(s):
    return _txt2img(s, "tiny-unet", "a golden test image", 64, 1234)


def k_vpred_txt2img_32(s):
    return _txt2img(s, "tiny-unet-v", "a golden vpred image", 32, 55, sampler="euler",
                    scheduler="beta")


def k_flux_txt2img_32(s):
    return _txt2img(s, "tiny-flux", "a golden flux image", 32, 99, cfg_scale=1.0,
                    sampler="euler", scheduler="simple")


def k_flux_shift25_txt2img_32(s):
    shifted = dataclasses.replace(s.bundle("tiny-flux"), flow_shift_override=2.5)
    return _txt2img(s, "tiny-flux", "a golden shifted flux image", 32, 99, cfg_scale=1.0,
                    bundle=shifted, sampler="euler", scheduler="simple")


def k_sd3_txt2img_32(s):
    return _txt2img(s, "tiny-sd3", "a golden sd3 image", 32, 77, cfg_scale=4.0,
                    sampler="euler", scheduler="simple")


def k_sd35m_txt2img_32(s):
    return _txt2img(s, "tiny-sd35m", "a golden mmditx image", 32, 88, cfg_scale=4.0,
                    sampler="euler", scheduler="simple")


def k_kontext_txt2img_32(s):
    b = s.bundle("tiny-flux")
    (ref_lat,) = s.core.VAEEncode().encode(s.array(_pix()), b)
    (pos,) = s.ctl.ReferenceLatent().append(_pooled(s, b, "golden kontext edit"), ref_lat)
    (el,) = s.core.EmptyLatentImage().generate(32, 32, 1, **s.kw)
    (lat,) = s.core.KSampler().sample(b, 21, 2, 1.0, "euler", "simple", pos, _pooled(s, b, ""),
                                      el, denoise=1.0)
    return s.core.VAEDecode().decode(lat, b)[0]


def k_usdu_64_to_128(s):
    b = s.bundle("tiny-unet")
    img = np.linspace(0, 1, 64 * 64 * 3, dtype=np.float32).reshape(1, 64, 64, 3)
    pos, neg = s.pl.encode_text(b, ["golden upscale"]), s.pl.encode_text(b, [""])
    kw = dict(mesh=None, seed=7, upscale_by=2.0, tile=64, padding=16, steps=2, sampler="euler",
              scheduler="karras", cfg=7.0, denoise=0.35)
    if s.is_jax:
        return jup.run_upscale(b, img, pos, neg, tile_batch=1, **kw)
    return tup.run_upscale(b, img, pos, neg, noise=JaxTileNoise(7), **kw)


def k_sigmas_beta_12(s):
    return (jsmp if s.is_jax else tsmp).get_sigmas("beta", 12)


def k_sigmas_kl_optimal_12(s):
    return (jsmp if s.is_jax else tsmp).get_sigmas("kl_optimal", 12)


def _pooled(s, b, text):
    return s.pl.encode_text_pooled(b, [text])


def k_inpaint_latent_32(s):
    b = s.bundle("tiny-unet")
    (lat,) = s.core.VAEEncodeForInpaint().encode(s.array(_pix()), b, s.array(_imask()),
                                                 grow_mask_by=6)
    (out,) = s.core.KSampler().sample(b, 3, 2, 7.0, "euler", "karras",
                                      _pooled(s, b, "golden inpaint"), _pooled(s, b, ""), lat,
                                      denoise=1.0)
    return out["samples"]


def k_outpaint_pad_32(s):
    return s.core.ImagePadForOutpaint().expand(s.array(_pix()), left=0, top=0, right=16,
                                               bottom=8, feathering=8)[0]


def k_outpaint_mask_32(s):
    return s.core.ImagePadForOutpaint().expand(s.array(_pix()), left=0, top=0, right=16,
                                               bottom=8, feathering=8)[1]


def k_hiresfix_64_to_96(s):
    b = s.bundle("tiny-unet")
    pos, neg = _pooled(s, b, "golden inpaint"), _pooled(s, b, "")
    (el,) = s.core.EmptyLatentImage().generate(64, 64, 1, **s.kw)
    (base,) = s.core.KSampler().sample(b, 9, 2, 7.0, "euler", "karras", pos, neg, el,
                                       denoise=1.0)
    (up,) = s.core.LatentUpscaleBy().upscale(base, "bilinear", 1.5)
    (refined,) = s.core.KSampler().sample(b, 10, 2, 7.0, "euler", "karras", pos, neg, up,
                                          denoise=0.5)
    return s.core.VAEDecode().decode(refined, b)[0]


def _custom(s):
    b = s.bundle("tiny-unet")
    (cel,) = s.core.EmptyLatentImage().generate(32, 32, 1, **s.kw)
    (csig,) = s.custom.BasicScheduler().get_sigmas(b, "karras", 4, 1.0)
    high, low = s.custom.SplitSigmas().split(csig, 2)
    (csamp,) = s.custom.KSamplerSelect().get_sampler("euler")
    (cnoise,) = s.custom.RandomNoise().get_noise(5)
    (cguider,) = s.custom.CFGGuider().get_guider(b, _pooled(s, b, "golden inpaint"),
                                                 _pooled(s, b, ""), 7.0)
    s1, s1_den = s.custom.SamplerCustomAdvanced().sample(cnoise, cguider, csamp, high, cel)
    (cno,) = s.custom.DisableNoise().get_noise()
    s2, _ = s.custom.SamplerCustomAdvanced().sample(cno, cguider, csamp, low, s1)
    return s1["samples"], s1_den["samples"], s2["samples"]


def k_custom_stage1_32(s):
    return _custom(s)[0]


def k_custom_stage1_denoised_32(s):
    return _custom(s)[1]


def k_custom_stage2_32(s):
    return _custom(s)[2]


def k_regional_latent_32(s):
    b = s.bundle("tiny-unet")
    pos_p, neg_p = _pooled(s, b, "golden inpaint"), _pooled(s, b, "")
    pos_b = _pooled(s, b, "golden region two")
    (area_a,) = s.ctl.ConditioningSetArea().set_area(pos_p, 16, 32, 0, 0, 1.0)
    (area_b,) = s.ctl.ConditioningSetArea().set_area(pos_b, 16, 32, 16, 0, 1.2)
    (regional,) = s.ctl.ConditioningCombine().combine(area_a, area_b)
    (zeroed,) = s.ctl.ConditioningZeroOut().zero_out(neg_p)
    (neg_early,) = s.ctl.ConditioningSetTimestepRange().set_range(neg_p, 0.0, 0.5)
    (neg_late,) = s.ctl.ConditioningSetTimestepRange().set_range(zeroed, 0.5, 1.0)
    (neg_split,) = s.ctl.ConditioningCombine().combine(neg_early, neg_late)
    (cel,) = s.core.EmptyLatentImage().generate(32, 32, 1, **s.kw)
    (out,) = s.core.KSampler().sample(b, 13, 2, 7.0, "euler", "karras", regional, neg_split,
                                      cel, denoise=1.0)
    return out["samples"]


def k_sdxl_sizecond_latent_32(s):
    b = s.bundle("tiny-unet-adm")
    (cond,) = s.core.CLIPTextEncodeSDXL().encode(b, 64, 64, 8, 8, 32, 32, "golden castle",
                                                 "golden stone")
    (cel,) = s.core.EmptyLatentImage().generate(32, 32, 1, **s.kw)
    (out,) = s.core.KSampler().sample(b, 17, 2, 7.0, "euler", "karras", cond, _pooled(s, b, ""),
                                      cel, denoise=1.0)
    return out["samples"]


def k_inpaint_model_latent_32(s):
    b = s.bundle("tiny-unet-inpaint")
    ip, ineg, lat = s.core.InpaintModelConditioning().encode(
        _pooled(s, b, "golden fill"), _pooled(s, b, ""), b, s.array(_pix()), s.array(_imask()))
    (out,) = s.core.KSampler().sample(b, 19, 2, 7.0, "euler", "karras", ip, ineg, lat,
                                      denoise=1.0)
    return out["samples"]


def k_sharpen_32(s):
    return s.core.ImageSharpen().sharpen(s.array(_pix()), 2, 1.0, 0.8)[0]


def _guidance_bundle(s):
    """gen_goldens.py's guidance bundle: tiny-unet with every all-zero UNet
    leaf refilled, in tree order, from normal draws of default_rng(123)
    times 0.05 (a zero out_conv would make every patch's delta 0)."""
    jb, tb = s._bundles.pair("tiny-unet")
    key = "guided"
    if key not in s._bundles.jax:
        rng = np.random.default_rng(123)

        def fix(leaf):
            arr = np.asarray(leaf)
            if arr.size and not np.any(arr):
                return jnp.asarray((rng.normal(size=arr.shape) * 0.05).astype(arr.dtype))
            return leaf

        gb = dataclasses.replace(jb)
        gb.params = dict(jb.params, unet=jax.tree_util.tree_map(fix, jb.params["unet"]))
        s._bundles.jax[key] = gb
        s._bundles.port[key] = port_bundle(gb)
    return s._bundles.jax[key] if s.is_jax else s._bundles.port[key]


def _guided(s, **spec):
    gb = _guidance_bundle(s)
    gb = dataclasses.replace(gb, **spec)
    conds = [s.pl.encode_text(gb, [t]) for t in ("golden guidance", "golden alternative", "")]
    gx = s.array((np.random.default_rng(77).normal(size=(1, 8, 8, 4)).astype(np.float32)) * 5.0)
    gsig = s.array(np.full((1,), 5.0, np.float32))
    model = s.pl.guided_model(gb, gb.params, 4.0) if s.is_jax else s.pl.guided_model(gb, 4.0)
    gpos, galt, gneg = conds
    if "perp_neg" in spec or "dual_cfg" in spec:
        return model(gx, gsig, ((gpos, galt), gneg))
    return model(gx, gsig, (gpos, gneg))


def k_guided_pag_8(s):
    return _guided(s, pag=s.pl.PAGSpec(scale=2.0))


def k_guided_sag_8(s):
    return _guided(s, sag=s.pl.SAGSpec(scale=0.8, blur_sigma=2.0))


def k_guided_perpneg_8(s):
    return _guided(s, perp_neg=s.pl.PerpNegSpec(neg_scale=1.0))


def k_guided_dualcfg_8(s):
    return _guided(s, dual_cfg=s.pl.DualCFGSpec(cfg_cond2_negative=3.0))


def k_t2v_5f_32(s):
    jb, tb = s._bundles.video()
    kw = dict(frames=5, height=32, width=32, steps=2)
    if s.is_jax:
        return jvp.t2v(jb, "a golden test clip", seed=42, **kw)
    shape = (1, tb.latent_frames(5), 32 // tb.latent_scale, 32 // tb.latent_scale,
             tb.latent_channels)
    noise = np.array(jax.random.normal(jax.random.key(42), shape))
    return tvp.t2v(tb, "a golden test clip", noise=torch.from_numpy(noise), **kw)


KEYS = {name[2:]: fn for name, fn in globals().items() if name.startswith("k_")}
EXACT = {"sigmas_kl_optimal_12", "outpaint_pad_32", "outpaint_mask_32", "sharpen_32"}
LATENTS = {"custom_stage1_32", "custom_stage1_denoised_32", "custom_stage2_32",
           "inpaint_latent_32", "inpaint_model_latent_32", "regional_latent_32",
           "sdxl_sizecond_latent_32"}
GUIDED = {"guided_pag_8", "guided_sag_8", "guided_perpneg_8", "guided_dualcfg_8"}


def test_the_files_keys_are_these_and_the_other_families():
    with np.load(GOLDENS) as data:
        files = set(data.files)
    assert files == set(KEYS)
    assert len(KEYS) == 26
    assert EXACT | LATENTS | GUIDED < set(KEYS)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("key", sorted(KEYS))
def test_the_port_meets_the_golden(key, goldens, bundles, monkeypatch):
    golden = goldens[key]
    ref = _np(KEYS[key](Side("jax", bundles, monkeypatch)))
    got = _np(KEYS[key](Side("port", bundles, monkeypatch)))
    assert got.shape == ref.shape == golden.shape
    scale = max(1.0, float(np.abs(golden).max()))
    if key == "sigmas_beta_12":
        # the tie: the port takes what the JAX package takes today
        np.testing.assert_array_equal(got, ref)
        differs = np.flatnonzero(got != golden).tolist()
        ties = set(tsmp._vp_sigmas()[[499, 500]].astype(np.float32).tolist())
        assert differs == [] or (differs == [6] and {float(got[6]), float(golden[6])} == ties)
        return
    bar = EXACT_BAR if key in EXACT else LATENT_BAR if key in LATENTS else BF16_BAR
    np.testing.assert_allclose(ref, golden, rtol=0, atol=bar * scale)
    np.testing.assert_allclose(got, golden, rtol=0, atol=bar * scale)
    np.testing.assert_allclose(got, ref, rtol=0, atol=bar * scale)
    if key in GUIDED:
        plain = _np(_guided(Side("port", bundles, monkeypatch)))
        assert np.abs(plain - golden).max() > 2 * BF16_BAR * scale
