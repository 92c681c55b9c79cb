"""The port's SD3 / SD3.5 path against the JAX package's on the CPU, at f32.

Both packages get the same numpy-seeded weights (the JAX trees carried by
`from_jax_params`) for tiny-sd3 (QK norm) and tiny-sd35m (MMDiT-X: one
block with the image-only attn2), their 16-channel VAE and the three
text towers (tiny CLIP-L, CLIP-G and a T5 at the 160-wide context):

- the SD3MMDiT forward on a non-square latent (a swapped unpatchify or
  position crop shows there), with skipped layers and without the pooled
  vector;
- the plain attention at the slice's D=64 shapes: a ragged joint length
  against `jax.nn.dot_product_attention`, and 256 tokens against the
  Pallas kernel in interpret mode;
- the triple-encoder and the T5-less (DualCLIPLoader sd3) conditioning;
- txt2img with the JAX noise, CFG 4, euler on the simple schedule;
- skip-layer guidance: `slg_cfg_model` inside and outside its window, the
  guided model on the real MMDiT, and the SkipLayerGuidanceSD3 node's
  checks;
- `sd3_schedule`: a tiny single file written by the JAX package loaded
  exactly, and the published keys and shapes of the committed manifests
  (tests/models/manifests/, read by path) at full width on meta;
- the tile path (`run_upscale`) with the JAX tile keys;
- both bundled SD3.5 workflows and a component-loader graph
  (TripleCLIPLoader, UNETLoader, ModelSamplingSD3, VAELoader) through
  both executors.

Tolerances are stated per test; f32 sums in another order put the two
packages ~1e-6 apart per operation.
"""

import copy
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_distributed_tpu.graph import nodes_controlnet as jctl
from comfyui_distributed_tpu.models import pipeline as jpl
from comfyui_distributed_tpu.models import registry as jreg
from comfyui_distributed_tpu.models import sd_checkpoint as jsdc
from comfyui_distributed_tpu.models import t5_encoder as jt5
from comfyui_distributed_tpu.models import text_encoder as jte
from comfyui_distributed_tpu.models.io import flatten_params
from comfyui_distributed_tpu.ops import attention as jattn
from comfyui_distributed_tpu.ops import samplers as jsmp
from comfyui_distributed_tpu.ops import upscale as jup
from comfyui_distributed_tpu_torch.graph import nodes_controlnet as tctl
from comfyui_distributed_tpu_torch.graph import nodes_loaders as tnl
from comfyui_distributed_tpu_torch.models import pipeline as tpl
from comfyui_distributed_tpu_torch.models import registry as treg
from comfyui_distributed_tpu_torch.models import sd_checkpoint as tsdc
from comfyui_distributed_tpu_torch.models.io import from_jax_params
from comfyui_distributed_tpu_torch.ops import attention as tattn
from comfyui_distributed_tpu_torch.ops import samplers as tsmp
from comfyui_distributed_tpu_torch.ops import upscale as tup

from test_torch_parity import (  # noqa: F401  (one_torch_thread: fixture)
    JaxTileNoise,
    f32,
    jax_noise,
    one_torch_thread,
    seeded_flax_params,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MANIFESTS = os.path.join(REPO, "tests", "models", "manifests")
TINY = ("tiny-sd3", "tiny-sd35m")
TOWERS = ("tiny-te-l", "tiny-te-g", "tiny-t5-sd3")


@pytest.fixture(autouse=True)
def no_spm(monkeypatch):
    monkeypatch.delenv("CDT_T5_SPM", raising=False)


def sd3_pair(name, seed=0):
    """(JAX bundle, port bundle on the CPU) of a tiny SD3 model in f32 with
    the same numpy-seeded weights: the MMDiT (every bias and norm scale
    off 0 and 1), the 16-channel VAE and the three towers."""
    names = (name, "tiny-vae-sd3") + TOWERS
    with pytest.MonkeyPatch.context() as mp:
        for registry in (jreg.MODEL_REGISTRY, treg.MODEL_REGISTRY):
            for n in names:
                mp.setitem(registry, n, {**registry[n], "config": f32(registry[n]["config"])})
        unet, vae, te, te2, te3 = (jreg.create_model(n) for n in names)
        cfg = jreg.get_config(name)
        tokens = jnp.zeros((1, 16), jnp.int32)
        params = {
            "unet": seeded_flax_params(unet, seed + 1, jnp.zeros((1, 8, 8, 16)), jnp.zeros((1,)),
                                       jnp.zeros((1, 16, cfg.context_dim)),
                                       y=jnp.zeros((1, cfg.pooled_dim))),
            "vae": seeded_flax_params(vae, seed + 2, jnp.zeros((1, 32, 32, 3))),
            "te": seeded_flax_params(te, seed + 3, tokens),
            "te2": seeded_flax_params(te2, seed + 4, tokens),
            "te3": seeded_flax_params(te3, seed + 5, tokens),
        }
        te_cfg, te2_cfg, t5_cfg = (jreg.get_config(n) for n in TOWERS)
        jb = jpl.PipelineBundle(
            model_name=name, unet=unet, vae=vae, text_encoder=te, params=params,
            tokenizer=jte.Tokenizer(max_length=te_cfg.max_length, pad_id=te_cfg.pad_token_id),
            latent_channels=16, latent_scale=jreg.get_config("tiny-vae-sd3").downscale,
            text_encoder_2=te2,
            tokenizer_2=jte.Tokenizer(max_length=te2_cfg.max_length, pad_id=te2_cfg.pad_token_id),
            text_encoder_3=te3,
            tokenizer_3=jt5.T5Tokenizer(max_length=t5_cfg.max_length,
                                        vocab_size=t5_cfg.vocab_size),
            te_name=TOWERS[0], te2_name=TOWERS[1], te3_name=TOWERS[2],
        )
        tb = tpl.load_pipeline(name, device="cpu")
    for part, module in tb.parts().items():
        module.load_state_dict(from_jax_params(flatten_params(params[part]), module))
    return jb, tb


@pytest.fixture(scope="module")
def pairs():
    return {name: sd3_pair(name) for name in TINY}


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# --- the MMDiT ---------------------------------------------------------------------

FORWARD_CASES = {"plain": {}, "skip_layers": {"skip": (0,)}, "no_pooled": {"no_y": True}}


@pytest.mark.parametrize("case", sorted(FORWARD_CASES))
@pytest.mark.parametrize("name", TINY)
def test_sd3_forward_matches_jax(pairs, name, case):
    """The velocity of a [2, 16, 24, 16] latent (32x48 px, an 8x12 patch
    grid: a swapped unpatchify order or position crop would show) over 20
    text tokens. 1e-4 absolute on outputs of |x| ~ 4: f32 summation order
    over the 2-block net."""
    jb, tb = pairs[name]
    spec = FORWARD_CASES[case]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, 24, 16), dtype=np.float32)
    t = np.array([0.7, 0.25], np.float32)
    ctx = rng.standard_normal((2, 20, 160), dtype=np.float32)
    y = None if spec.get("no_y") else rng.standard_normal((2, 160), dtype=np.float32)
    skip = spec.get("skip", ())
    ref = np.asarray(jb.unet.apply(jb.params["unet"], jnp.asarray(x), jnp.asarray(t),
                                   jnp.asarray(ctx), y=None if y is None else jnp.asarray(y),
                                   skip_layers=skip))
    with torch.no_grad():
        got = tb.unet(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
                      y=None if y is None else torch.from_numpy(y), skip_layers=skip).numpy()
    assert got.shape == ref.shape == x.shape
    assert np.abs(ref).max() > 0.5
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    if skip:  # the skipped block was read: the plain forward differs
        with torch.no_grad():
            plain = tb.unet(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
                            y=torch.from_numpy(y)).numpy()
        assert np.abs(plain - got).max() > 1e-2


def test_sd3_refuses_what_it_has_no_input_for(pairs):
    _, tb = pairs["tiny-sd3"]
    x = torch.zeros((1, 8, 8, 16))
    t, ctx = torch.zeros((1,)), torch.zeros((1, 4, 160))
    with pytest.raises(ValueError, match="ControlNet"):
        tb.unet(x, t, ctx, control=torch.zeros_like(x))
    with pytest.raises(ValueError, match="reference latents"):
        tb.unet(x, t, ctx, ref_latents=[x])
    with pytest.raises(ValueError, match="position table"):
        tb.unet(torch.zeros((1, 66, 8, 16)), t, ctx)


def test_plain_attention_at_the_sd3_shapes_matches_jax():
    """D=64 as SD3's joint attention runs it: a ragged joint length (two
    128-token tiles and 26 text tokens) against jax.nn.dot_product_attention,
    and 256 tokens against the Pallas kernel in interpret mode, padded to
    D=128 as the JAX package pads it (force_flash=True). 2e-5 absolute:
    f32 summation order. The CPU path launches no kernel."""
    tattn.reset_launch_counts()
    rng = np.random.default_rng(64)
    for n, flash in ((2 * 128 + 26, False), (256, True)):
        q, k, v = (rng.standard_normal((1, n, 2, 64), dtype=np.float32) for _ in range(3))
        jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
        ref = (jattn.dot_product_attention(jq, jk, jv, force_flash=True) if flash
               else jax.nn.dot_product_attention(jq, jk, jv))
        got = tattn.dot_product_attention(*(torch.from_numpy(a) for a in (q, k, v)))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=0)
    assert tattn.flash_attention.launches == 0


# --- conditioning --------------------------------------------------------------------

@pytest.mark.parametrize("t5", [True, False], ids=["triple", "t5_less"])
def test_sd3_conditioning_matches_jax(pairs, t5):
    """CLIP-L ++ CLIP-G on features, padded to the T5 width, then the T5's
    16 tokens on the sequence ([B, 2 * 16, 160]); without the T5
    (DualCLIPLoader's sd3 type) the CLIP sequence alone, padded to the
    backbone's context width ([B, 16, 160]). Pooled = CLIP-L's ++ CLIP-G's
    [B, 160]. 2e-5 absolute (f32)."""
    jb, tb = pairs["tiny-sd3"]
    if not t5:
        jb = dataclasses.replace(jb, text_encoder_3=None, tokenizer_3=None, te3_name=None)
        tb = dataclasses.replace(tb, text_encoder_3=None, tokenizer_3=None, te3_name=None)
    texts = ["a lighthouse in a storm", "blurry, low quality"]
    jc, tc = jpl.encode_text_pooled(jb, texts), tpl.encode_text_pooled(tb, texts)
    tokens = 32 if t5 else 16
    assert tuple(tc.context.shape) == (2, tokens, 160) and tuple(tc.pooled.shape) == (2, 160)
    np.testing.assert_allclose(_np(tc.context), np.asarray(jc.context), atol=2e-5, rtol=0)
    np.testing.assert_allclose(_np(tc.pooled), np.asarray(jc.pooled), atol=2e-5, rtol=0)


def _jax_txt2img_noise(seed, shape):
    """txt2img's initial noise in the JAX package: normal(split(key(seed),
    3)[1])."""
    return np.array(jax.random.normal(jax.random.split(jax.random.key(seed), 3)[1], shape))


def _txt2img_both(jb, tb, seed=5, **kw):
    kw = {"height": 32, "width": 48, "steps": 2, "cfg_scale": 4.0, "sampler": "euler",
          "scheduler": "simple", **kw}
    ref = np.asarray(jpl.txt2img(jb, "a watercolor lighthouse", seed=seed, **kw))
    noise = _jax_txt2img_noise(seed, (1, kw["height"] // tb.latent_scale,
                                      kw["width"] // tb.latent_scale, 16))
    got = tpl.txt2img(tb, "a watercolor lighthouse", seed=seed, noise=torch.from_numpy(noise),
                      **kw).numpy()
    return ref, got


@pytest.mark.parametrize("name", TINY)
def test_txt2img_matches_jax(pairs, name):
    """A 32x48 image, 2 euler steps at CFG 4 on the simple schedule, the
    JAX noise: 1e-4 absolute on [0, 1] pixels (f32 through the MMDiT, the
    sampler and the VAE decode), and the image is not flat."""
    ref, got = _txt2img_both(*pairs[name])
    assert got.shape == ref.shape == (1, 32, 48, 3)
    assert float(ref.std()) > 0.01
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


# --- skip-layer guidance -------------------------------------------------------------

def _toy_jax(x, sigma, cond):
    return x * cond


def _toy_skip_jax(x, sigma, cond):
    return x * cond + 1.0


def _toy_torch(x, sigma, cond):
    # the port's CFG batches a bare context into one Conditioning entry
    return x * getattr(cond, "context", cond)


def _toy_skip_torch(x, sigma, cond):
    return _toy_torch(x, sigma, cond) + 1.0


@pytest.mark.parametrize("sigma", [0.9, 0.8, 0.5, 0.2, 0.1], ids=lambda s: f"sigma{s}")
def test_slg_cfg_model_matches_jax(sigma):
    """On a toy model whose skip pass adds 1: inside [0.2, 0.8] (bounds
    included) the result is plain CFG - 3, outside it is plain CFG bit
    for bit, on both packages (equal to 1e-6)."""
    x = np.ones((2, 4), np.float32)
    conds = (np.full((2, 1), 2.0, np.float32), np.full((2, 1), 0.5, np.float32))
    sig = np.full((2,), sigma, np.float32)
    j = jsmp.slg_cfg_model(_toy_jax, _toy_skip_jax, 4.0, 3.0, sigma_start=0.8, sigma_end=0.2)
    t = tsmp.slg_cfg_model(_toy_torch, _toy_skip_torch, 4.0, 3.0, sigma_start=0.8,
                           sigma_end=0.2)
    ref = np.asarray(j(jnp.asarray(x), jnp.asarray(sig), tuple(jnp.asarray(c) for c in conds)))
    got = t(torch.from_numpy(x), torch.from_numpy(sig),
            tuple(torch.from_numpy(c) for c in conds)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    plain = tsmp.cfg_model(_toy_torch, 4.0)(torch.from_numpy(x), torch.from_numpy(sig),
                                           tuple(torch.from_numpy(c) for c in conds)).numpy()
    inside = 0.2 <= sigma <= 0.8
    np.testing.assert_array_equal(got, plain - 3.0 if inside else plain)


@pytest.mark.parametrize("sigma", [0.6, 0.95], ids=["inside", "outside"])
def test_slg_guided_model_matches_jax(pairs, sigma):
    """guided_model on tiny-sd35m under SLG (block 0, the dual-attention
    one, skipped; progress [0.0, 0.5], so sigma in [0.5, inf]) at CFG 4:
    the skip pass's delta inside the window, plain CFG outside.
    2e-4 absolute on guided velocities: f32 summation order, amplified by
    the guidance."""
    jb, tb = pairs["tiny-sd35m"]
    spec = dict(layers=(0,), scale=3.0, start_percent=0.0, end_percent=0.5)
    jg = dataclasses.replace(jb, slg=jpl.SLGSpec(**spec))
    tg = dataclasses.replace(tb, slg=tpl.SLGSpec(**spec))
    rng = np.random.default_rng(21)
    x = rng.standard_normal((1, 8, 12, 16), dtype=np.float32)
    sig = np.array([sigma], np.float32)
    jc = (jpl.encode_text_pooled(jb, ["a lighthouse"]), jpl.encode_text_pooled(jb, [""]))
    tc = (tpl.encode_text_pooled(tb, ["a lighthouse"]), tpl.encode_text_pooled(tb, [""]))
    guided = jax.jit(lambda x_, s_: jpl.guided_model(jg, jg.params, 4.0)(x_, s_, jc))
    want = np.asarray(guided(jnp.asarray(x), jnp.asarray(sig)))
    got = tpl.guided_model(tg, 4.0)(torch.from_numpy(x), torch.from_numpy(sig), tc).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)
    plain = tpl.guided_model(tb, 4.0)(torch.from_numpy(x), torch.from_numpy(sig), tc).numpy()
    if sigma < 1.0 - 1e-6 and sigma >= 0.5:
        assert np.abs(plain - got).max() > 1e-2
    else:
        np.testing.assert_array_equal(plain, got)


def test_skip_layer_guidance_node(pairs):
    """SkipLayerGuidanceSD3 as the JAX package's tests hold it
    (tests/models/test_sd3.py::test_skip_layer_guidance): a patched
    bundle changes the image inside its window; a window past the
    schedule's sigmas leaves it as it was (here exactly: the skip pass
    does not run); a muted node (no layers, scale 0) passes the model
    through; out-of-range layers, a reversed window, another family and a
    second guidance patch raise. Both packages give the same spec."""
    jb, tb = pairs["tiny-sd35m"]
    node, jnode = tctl.SkipLayerGuidanceSD3(), jctl.SkipLayerGuidanceSD3()
    kw = dict(height=32, width=32, steps=2, cfg_scale=4.0, sampler="euler", scheduler="simple")
    noise = torch.from_numpy(_jax_txt2img_noise(0, (1, 16, 16, 16)))
    base = tpl.txt2img(tb, "p", seed=0, noise=noise, **kw)
    (patched,) = node.skip_guidance(tb, layers="0", scale=3.0, start_percent=0.0,
                                    end_percent=0.5)
    (jpatched,) = jnode.skip_guidance(jb, layers="0", scale=3.0, start_percent=0.0,
                                      end_percent=0.5)
    assert dataclasses.asdict(patched.slg) == dataclasses.asdict(jpatched.slg)
    assert tb.slg is None  # the cached bundle keeps no patch
    slg = tpl.txt2img(patched, "p", seed=0, noise=noise, **kw)
    assert float((slg - base).abs().max()) > 1e-3 and bool(torch.isfinite(slg).all())
    (inactive,) = node.skip_guidance(tb, layers="0", scale=3.0, start_percent=0.99,
                                     end_percent=1.0)
    torch.testing.assert_close(tpl.txt2img(inactive, "p", seed=0, noise=noise, **kw), base,
                               rtol=0, atol=0)
    assert node.skip_guidance(tb, layers="")[0] is tb
    assert node.skip_guidance(tb, layers="0", scale=0.0)[0] is tb
    assert node.skip_guidance(tb, layers="", start_percent=0.9, end_percent=0.1)[0] is tb
    with pytest.raises(ValueError, match="out of range"):
        node.skip_guidance(tb, layers="99")
    with pytest.raises(ValueError, match="must be <="):
        node.skip_guidance(tb, layers="0", start_percent=0.5, end_percent=0.1)
    with pytest.raises(ValueError, match="SD3-class"):
        node.skip_guidance(tpl.load_unet("tiny-unet", device="cpu"), layers="0")
    with pytest.raises(ValueError, match="cannot combine with SkipLayerGuidanceSD3"):
        tnl.RescaleCFG().patch(patched, 0.7)
    (rescaled,) = tnl.RescaleCFG().patch(tb, 0.7)
    with pytest.raises(ValueError, match="cannot combine with RescaleCFG"):
        node.skip_guidance(rescaled, layers="0")


# --- checkpoints -----------------------------------------------------------------------

def _jax_single_file(jb, prefix="model.diffusion_model."):
    """The JAX package's synthesized single file of an SD3 bundle: the
    MMDiT under `prefix`, the VAE under first_stage_model and (with the
    prefix) the three towers under text_encoders.* (HF packing)."""
    cfgs = {n: jreg.get_config(n) for n in (jb.model_name, "tiny-vae-sd3") + TOWERS}
    state = jsdc.synthesize_state_dict(flatten_params(jb.params["unet"]),
                                       jsdc.sd3_schedule(cfgs[jb.model_name], prefix=prefix))
    if prefix:
        for part, entries in (
            ("vae", jsdc.vae_schedule(cfgs["tiny-vae-sd3"])),
            ("te", jsdc.text_encoder_schedule(
                cfgs[TOWERS[0]], prefix="text_encoders.clip_l.transformer.text_model",
                projection_layout="linear")),
            ("te2", jsdc.text_encoder_schedule(
                cfgs[TOWERS[1]], prefix="text_encoders.clip_g.transformer.text_model",
                projection_layout="linear")),
            ("te3", jsdc.t5_encoder_schedule(cfgs[TOWERS[2]],
                                             prefix="text_encoders.t5xxl.transformer.")),
        ):
            state.update(jsdc.synthesize_state_dict(flatten_params(jb.params[part]), entries))
    return {k: torch.from_numpy(np.array(v)) for k, v in state.items()}


@pytest.mark.parametrize("name", TINY)
def test_a_written_sd3_file_loads_exactly(pairs, name, tmp_path, monkeypatch):
    """The JAX package writes a single file (every part, the towers under
    text_encoders.*) and a bare transformer file of its seeded weights;
    the port's load_pipeline and load_unet read them into exactly the
    modules from_jax_params fills. The port's own synthesize inverts its
    conversion bit for bit (the patch conv's reshape included)."""
    jb, tb = pairs[name]
    single, bare = tmp_path / "single", tmp_path / "bare"
    single.mkdir(), bare.mkdir()
    full = _jax_single_file(jb)
    tsdc.save_safetensors(full, str(single / f"{name}.safetensors"))
    tsdc.save_safetensors(_jax_single_file(jb, prefix=""), str(bare / f"{name}.safetensors"))
    assert tsdc.checkpoint_layout(full) == "sd3"
    with pytest.MonkeyPatch.context() as mp:
        for n in (name, "tiny-vae-sd3") + TOWERS:
            entry = treg.MODEL_REGISTRY[n]
            mp.setitem(treg.MODEL_REGISTRY, n, {**entry, "config": f32(entry["config"])})
        loaded = tpl.load_pipeline(name, device="cpu",
                                   checkpoint=str(single / f"{name}.safetensors"))
        monkeypatch.setenv("CDT_CHECKPOINT_DIR", str(bare))
        unet_only = tpl.load_unet(name, device="cpu")
    for part, want in tb.parts().items():
        got = loaded.parts()[part].state_dict()
        for key, value in want.state_dict().items():
            torch.testing.assert_close(got[key], value, rtol=0, atol=0, msg=f"{part}.{key}")
    for key, value in tb.unet.state_dict().items():
        torch.testing.assert_close(unet_only.unet.state_dict()[key], value, rtol=0, atol=0)
    entries = tsdc.sd3_schedule(treg.get_config(name))
    again = tsdc.synthesize_state_dict(tb.unet.state_dict(), entries)
    for key, value in again.items():
        torch.testing.assert_close(value, full[key], rtol=0, atol=0, msg=key)
    with pytest.raises(ValueError, match="SD3-class file"):
        tsdc.load_sd_weights(full, treg.get_config("tiny-unet"), None, None, {})


def _sd_shapes(module, entries):
    """{sd key: the shape the file holds} of a schedule over `module`'s
    parameters (built on meta)."""
    params = {n: tuple(p.shape) for n, p in module.state_dict().items()}
    out = {}
    for sd_key, name, how in tsdc._expand(entries):
        shape = params[name]
        if how.startswith("conv2d:"):
            p, c = (int(n) for n in how.split(":")[1:])
            shape = (shape[0], c, p, p)
        elif how == "proj":  # a 1x1 conv in the file (the VAE's mid attention)
            shape = shape + (1, 1)
        out[sd_key] = shape
    return out


@pytest.mark.parametrize("name, manifest", [
    ("sd3-medium", "sd3_medium_dit"), ("sd35-large", "sd35_large_dit"),
    ("sd35-medium", "sd35_medium_dit"), ("vae-sd3", "sd3_vae"),
])
def test_the_schedules_cover_the_published_manifests(name, manifest):
    """Every key of the committed manifest (the published checkpoint's
    layout, from the reference's torch modules) with its shape, and no
    other, at full width on meta; the MMDiT schedules name the JAX
    package's keys in its order, each parameter under the naming rule."""
    with open(os.path.join(MANIFESTS, f"{manifest}.json"), encoding="utf-8") as fh:
        want = {k: tuple(v) for k, v in json.load(fh).items()}
    cfg = treg.get_config(name)
    with torch.device("meta"):
        module = treg.create_model(name)
    if name.startswith("vae"):
        entries = tsdc.vae_schedule(cfg)
    else:
        entries = tsdc.sd3_schedule(cfg)
        jexp = jsdc._expand(jsdc.sd3_schedule(jreg.get_config(name)))
        texp = tsdc._expand(entries)
        assert [k for k, _, _ in texp] == [k for k, _, _ in jexp]
        for (_, tname, _), (_, jpath, _) in zip(texp, jexp):
            parts = jpath.split("/")
            leaf = {"kernel": "weight", "scale": "weight"}.get(parts[-1], parts[-1])
            assert tname == ".".join(parts[:-1] + [leaf])
    got = _sd_shapes(module, entries)
    assert sorted(set(want) - set(got)) == [] and sorted(set(got) - set(want)) == []
    assert {k: v for k, v in got.items() if want[k] != v} == {}
    assert {n for _, n, _ in tsdc._expand(entries)} == set(module.state_dict())


# --- the tile path and the workflows -------------------------------------------------

def test_usdu_on_sd3_matches_jax(pairs):
    """run_upscale on tiny-sd3 as the JAX package's test runs it (a 64-px
    image doubled, 64-px tiles padded by 16, 2 steps at denoise 0.4; here
    euler on the simple schedule at CFG 4), the JAX tile keys replayed.
    1e-4 absolute on pixels."""
    jb, tb = pairs["tiny-sd3"]
    img = np.random.default_rng(11).random((1, 64, 64, 3), dtype=np.float32)
    kw = dict(mesh=None, upscale_by=2.0, tile=64, padding=16, steps=2, denoise=0.4, seed=3,
              sampler="euler", scheduler="simple", cfg=4.0)
    want = np.asarray(jup.run_upscale(jb, jnp.asarray(img), jpl.encode_text(jb, ["p"]),
                                      jpl.encode_text(jb, [""]), tile_batch=1, **kw))
    got = tup.run_upscale(tb, torch.from_numpy(img), tpl.encode_text(tb, ["p"]),
                          tpl.encode_text(tb, [""]), noise=JaxTileNoise(3), **kw)
    assert _np(got).shape == want.shape == (1, 128, 128, 3)
    np.testing.assert_allclose(_np(got), want, atol=1e-4, rtol=0)


SD35_WORKFLOWS = {"distributed-txt2img-sd35.json": "tiny-sd3",
                  "distributed-txt2img-sd35m-slg.json": "tiny-sd35m"}


def tiny_sd3_workflow(name, px=32, steps=2, slg_steps=8):
    """A bundled SD3.5 workflow on its tiny model at `px`: its checkpoint
    name, its latent size, its step count (8 under SLG, so that one step
    of the simple schedule at the tiny models' shift 1 falls in its [0.01,
    0.2] window), its SLG layers the tiny model's block 0 (it has 2), its
    SaveImage a PreviewImage."""
    with open(os.path.join(REPO, "workflows", name), encoding="utf-8") as fh:
        workflow = json.load(fh)
    slg = any(n["class_type"] == "SkipLayerGuidanceSD3" for n in workflow.values())
    for node in workflow.values():
        inputs = node["inputs"]
        if "ckpt_name" in inputs:
            inputs["ckpt_name"] = SD35_WORKFLOWS[name]
        for key in ("width", "height"):
            if key in inputs:
                inputs[key] = px
        if "steps" in inputs:
            inputs["steps"] = slg_steps if slg else steps
        if node["class_type"] == "SkipLayerGuidanceSD3":
            inputs["layers"] = "0"
        if node["class_type"] == "SaveImage":
            node["class_type"] = "PreviewImage"
            del inputs["filename_prefix"]
    return workflow


def run_sd3_workflow_in_both(workflow, jb, tb, monkeypatch, port_only=False):
    """`workflow` through both GraphExecutors (the port's alone with
    `port_only`), every loader resolving to the pair's bundles and the
    port drawing the JAX package's initial noise → (JAX or None, port)
    images."""
    from comfyui_distributed_tpu.graph import executor as jexec
    from comfyui_distributed_tpu_torch.graph import ExecutionContext, GraphExecutor

    monkeypatch.setattr(tpl, "default_noise",
                        lambda seed, shape, device: torch.from_numpy(jax_noise(seed, shape)))
    monkeypatch.setattr(jpl, "load_vae", lambda name, **kw: jb)
    monkeypatch.setattr(tpl, "load_vae", lambda name, **kw: tb)
    name = jb.model_name
    keys = (name, f"unet:{name}", "clip:sd3:" + ",".join(TOWERS))
    (sink,) = [k for k, v in workflow.items() if v["class_type"] == "PreviewImage"]
    jout = jexec.GraphExecutor(jexec.ExecutionContext(pipelines=dict.fromkeys(keys, jb)))
    tout = GraphExecutor(ExecutionContext(device="cpu", pipelines=dict.fromkeys(keys, tb)))
    ref = None if port_only else np.asarray(jout.execute(workflow)[sink][0]["images"])
    return ref, tout.execute(workflow)[sink][0]["images"].numpy()


@pytest.mark.parametrize("name", sorted(SD35_WORKFLOWS))
def test_the_bundled_sd35_workflows_match_jax(pairs, name, monkeypatch):
    """Each workflow's image at 32 px: 1e-4 absolute on [0, 1] pixels, the
    image not flat; the SLG workflow's image moves when its node is muted
    (scale 0), so its skip pass ran."""
    jb, tb = pairs[SD35_WORKFLOWS[name]]
    workflow = tiny_sd3_workflow(name)
    ref, got = run_sd3_workflow_in_both(workflow, jb, tb, monkeypatch)
    assert got.shape == ref.shape == (1, 32, 32, 3)
    assert float(ref.std()) > 0.01
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    slg = [k for k, v in workflow.items() if v["class_type"] == "SkipLayerGuidanceSD3"]
    if slg:
        muted = copy.deepcopy(workflow)
        muted[slg[0]]["inputs"]["scale"] = 0.0
        _, plain = run_sd3_workflow_in_both(muted, jb, tb, monkeypatch, port_only=True)
        assert np.abs(plain - got).max() > 1.0 / 255


def test_the_component_loaders_graph_matches_jax(pairs, monkeypatch):
    """UNETLoader → ModelSamplingSD3 (shift 2.0) → KSampler, TripleCLIPLoader
    → CLIPTextEncode, EmptySD3LatentImage, VAELoader → VAEDecode, through
    both executors; 1e-4 absolute on pixels. The shift reaches the
    schedule: the image differs from the config's shift."""
    jb, tb = pairs["tiny-sd3"]
    workflow = {
        "1": {"class_type": "UNETLoader", "inputs": {"unet_name": "tiny-sd3.safetensors",
                                                     "weight_dtype": "default"}},
        "2": {"class_type": "ModelSamplingSD3", "inputs": {"model": ["1", 0], "shift": 2.0}},
        "3": {"class_type": "TripleCLIPLoader",
              "inputs": {"clip_name1": "tiny-te-l", "clip_name2": "tiny-te-g",
                         "clip_name3": "tiny-t5-sd3"}},
        "4": {"class_type": "CLIPTextEncode", "inputs": {"text": "a harbour", "clip": ["3", 0]}},
        "5": {"class_type": "CLIPTextEncode", "inputs": {"text": "", "clip": ["3", 0]}},
        "6": {"class_type": "EmptySD3LatentImage",
              "inputs": {"width": 48, "height": 32, "batch_size": 1}},
        "7": {"class_type": "KSampler", "inputs": {
            "model": ["2", 0], "seed": 9, "steps": 3, "cfg": 4.0, "sampler_name": "euler",
            "scheduler": "simple", "positive": ["4", 0], "negative": ["5", 0],
            "latent_image": ["6", 0], "denoise": 1.0}},
        "8": {"class_type": "VAELoader", "inputs": {"vae_name": "tiny-vae-sd3"}},
        "9": {"class_type": "VAEDecode", "inputs": {"samples": ["7", 0], "vae": ["8", 0]}},
        "10": {"class_type": "PreviewImage", "inputs": {"images": ["9", 0]}},
    }
    ref, got = run_sd3_workflow_in_both(workflow, jb, tb, monkeypatch)
    assert got.shape == ref.shape == (1, 32, 48, 3)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    unshifted = copy.deepcopy(workflow)
    unshifted["7"]["inputs"]["model"] = ["1", 0]
    _, plain = run_sd3_workflow_in_both(unshifted, jb, tb, monkeypatch, port_only=True)
    assert np.abs(plain - got).max() > 1.0 / 255
    with pytest.raises(ValueError, match="flow-matching"):
        tnl.ModelSamplingSD3().patch(tpl.load_unet("tiny-unet", device="cpu"))
