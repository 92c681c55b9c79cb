"""The SD guidance patches in the port against the JAX package, on the CPU
in f32: FreeU and FreeU_V2 (the Fourier low-pass alone, then a UNet
forward), SAG (the capture pass's probabilities, `sag_cfg_model` over two
steps), RescaleCFG (with the population std, which an unbiased std would
miss), the one-patch rule, the cached bundle untouched after a patched
run, and each patch node and the area conditioning of chip_smoke.py's
guidance phase through both packages' GraphExecutors.

Weights are numpy-seeded in the flax layout and carried across
(`from_jax_params`), the UNet's out_conv non-zero. Tolerances: f32 on
both sides, differing in summation order; each leaves a margin of about
ten over the difference measured on a CPU.
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
import torch.nn.functional as F

import chip_smoke
from comfyui_distributed_tpu.models import pipeline as jpl
from comfyui_distributed_tpu.models import registry as jreg
from comfyui_distributed_tpu.models import unet as junet
from comfyui_distributed_tpu.ops import conditioning as jcond
from comfyui_distributed_tpu.ops import samplers as jsmp
from comfyui_distributed_tpu.models.io import flatten_params
from comfyui_distributed_tpu_torch.graph import ExecutionContext, GraphExecutor
from comfyui_distributed_tpu_torch.graph import nodes_loaders as tloaders
from comfyui_distributed_tpu_torch.models import layers as tlayers
from comfyui_distributed_tpu_torch.models import pipeline as tpl
from comfyui_distributed_tpu_torch.models import registry as treg
from comfyui_distributed_tpu_torch.models import unet as tunet
from comfyui_distributed_tpu_torch.models.io import from_jax_params
from comfyui_distributed_tpu_torch.ops import conditioning as tcond
from comfyui_distributed_tpu_torch.ops import samplers as tsmp
from test_torch_parity import (  # noqa: F401  (one_torch_thread: fixture)
    f32,
    jax_and_port_bundles,
    one_torch_thread,
    run_workflow_in_both,
    seeded_flax_params,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --- FreeU ---------------------------------------------------------------------------------

@pytest.mark.parametrize("shape, threshold", [((2, 7, 9, 5), 1), ((1, 8, 8, 3), 2),
                                              ((1, 1, 4, 2), 1)])
def test_fourier_lowpass_matches_jax(shape, threshold):
    x = np.random.default_rng(1).standard_normal(shape, dtype=np.float32)
    ref = np.asarray(junet._fourier_lowpass_scale(jnp.asarray(x), threshold, 0.3))
    got = tunet._fourier_lowpass_scale(torch.from_numpy(x).permute(0, 3, 1, 2), threshold, 0.3)
    assert np.abs(ref - x).max() > 1e-3
    # measured 4.8e-7 on a CPU
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, atol=5e-6, rtol=0)


def _three_level_configs(freeu):
    """tiny-unet with a third level, so both FreeU joins occur: widths 16,
    32 and 64 = model_channels * 4 (b1, s1) and * 2 (b2, s2)."""
    change = dict(model_channels=16, channel_mult=(1, 2, 4), transformer_depth=(1, 1, 1),
                  freeu=freeu)
    return (dataclasses.replace(f32(jreg.get_config("tiny-unet")), **change),
            dataclasses.replace(f32(treg.get_config("tiny-unet")), **change))


@pytest.mark.parametrize("v2", [False, True], ids=["FreeU", "FreeU_V2"])
def test_unet_with_freeu_matches_flax(v2):
    freeu = (1.3, 1.4, 0.9, 0.2, v2)
    jcfg, tcfg = _three_level_configs(freeu)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 12, 12, 4), dtype=np.float32)
    t = np.asarray([17.0, 981.0], np.float32)
    ctx = rng.standard_normal((2, 16, 64), dtype=np.float32)
    jm = jreg.UNet(jcfg)
    params = seeded_flax_params(jm, 3, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    ref = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx)))
    tm = tunet.UNet(dataclasses.replace(tcfg, freeu=None))
    tm.load_state_dict(from_jax_params(flatten_params(params), tm))
    tm.eval().requires_grad_(False)
    patched = tm.with_freeu(freeu)
    args = (torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx))
    with torch.no_grad():
        got, plain = patched(*args).numpy(), tm(*args).numpy()
    assert np.abs(got - plain).max() > 1e-3
    assert tm.config.freeu is None and patched.down_0_res_0 is tm.down_0_res_0
    # measured 6.7e-6 on a CPU
    np.testing.assert_allclose(got, ref, atol=5e-5, rtol=0)


# --- SAG ------------------------------------------------------------------------------------

@pytest.fixture
def attention_calls(monkeypatch):
    calls = []
    attention = tlayers.dot_product_attention

    def record(q, k, v):
        calls.append(tuple(q.shape))
        return attention(q, k, v)

    monkeypatch.setattr(tlayers, "dot_product_attention", record)
    return calls


def test_the_capture_pass_returns_flaxs_probabilities(attention_calls):
    """The middle block's first self-attention, computed plain, gives the
    probabilities flax sows; every other call goes to the attention
    function, one fewer than a plain pass."""
    jcfg, tcfg = f32(jreg.get_config("tiny-unet")), f32(treg.get_config("tiny-unet"))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 7, 9, 4), dtype=np.float32)
    t = np.asarray([400.0], np.float32)
    ctx = rng.standard_normal((1, 16, 64), dtype=np.float32)
    jm = jreg.UNet(jcfg)
    params = seeded_flax_params(jm, 5, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    ref, mut = jax.jit(functools.partial(jm.apply, sag_capture=True, mutable=["intermediates"]))(
        params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    ref_probs = np.asarray(jax.tree_util.tree_leaves(mut)[0])
    tm = tunet.UNet(tcfg)
    tm.load_state_dict(from_jax_params(flatten_params(params), tm))
    tm.eval().requires_grad_(False)
    args = (torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx))
    with torch.no_grad():
        out, probs, mid_hw = tm(*args, sag_capture=True)
        captured = len(attention_calls)
        plain = tm(*args)
    assert mid_hw == (4, 5) and tuple(probs.shape) == (1, 2, 20, 20)
    assert captured == len(attention_calls) - captured - 1
    torch.testing.assert_close(out, plain, rtol=0, atol=1e-5)
    # measured 2.4e-7 and 3.8e-6 on a CPU
    np.testing.assert_allclose(probs.numpy(), ref_probs, atol=5e-6, rtol=0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=5e-5, rtol=0)


@pytest.mark.parametrize("src, dst", [((4, 5), (7, 9)), ((3, 3), (8, 8)), ((2, 6), (4, 12))])
def test_the_salience_mask_resize_is_jaxs_nearest(src, dst):
    """nearest-exact samples at half-pixel centres as jax.image.resize's
    "nearest"; plain "nearest" would pick other cells at 4 → 7."""
    mask = (np.random.default_rng(6).random((1, *src)) > 0.5).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(mask), (1, *dst), method="nearest"))
    got = F.interpolate(torch.from_numpy(mask)[:, None], size=dst, mode="nearest-exact")[:, 0]
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.fixture(scope="module")
def pair():
    return jax_and_port_bundles("tiny-unet")


def _conds(seed, jax_side):
    rng = np.random.default_rng(seed)
    ctxs = [rng.standard_normal((1, 16, 64), dtype=np.float32) for _ in range(2)]
    if jax_side:
        return tuple(jcond.Conditioning(jnp.asarray(c)) for c in ctxs)
    return tuple(tcond.Conditioning(torch.from_numpy(c)) for c in ctxs)


@pytest.mark.parametrize("hw", [(8, 8), (7, 9)])
def test_sag_cfg_model_over_two_steps_matches_jax(pair, hw):
    """Two euler steps of the SAG-guided model (capture, salience mask,
    blur, degraded pass) from the same start; on 7 x 9 latents the mask
    resizes 4 x 5 → 7 x 9. The latents reach |x| ≈ 40: tolerance 2e-3
    (5e-5 of the largest), measured 2.0e-4 on a CPU."""
    jb, tb = pair
    spec = dict(scale=0.5, blur_sigma=2.0)
    x = np.random.default_rng(7).standard_normal((1, *hw, 4), dtype=np.float32) * 14.6
    sigmas = tsmp.get_sigmas("karras", 2)
    jguided = jpl.guided_model(dataclasses.replace(jb, sag=jpl.SAGSpec(**spec)), jb.params, 5.0)
    ref = np.asarray(jsmp.sample(jguided, jnp.asarray(x), jnp.asarray(sigmas.numpy()),
                                 _conds(8, True), "euler"))
    tguided = tpl.guided_model(dataclasses.replace(tb, sag=tpl.SAGSpec(**spec)), 5.0)
    with torch.no_grad():
        got = tsmp.sample(tguided, torch.from_numpy(x), sigmas, _conds(8, False), "euler")
        plain = tsmp.sample(tpl.guided_model(tb, 5.0), torch.from_numpy(x), sigmas,
                            _conds(8, False), "euler")
    assert float((got - plain).abs().max()) > 1e-1
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-3, rtol=0)


def test_sag_refuses_a_combined_negative(pair):
    _, tb = pair
    guided = tpl.guided_model(dataclasses.replace(tb, sag=tpl.SAGSpec()), 5.0)
    pos, neg = _conds(9, False)
    with pytest.raises(ValueError, match="single negative"):
        guided(torch.zeros((1, 4, 4, 4)), torch.ones(1), (pos, [neg, neg]))


# --- RescaleCFG -------------------------------------------------------------------------------

def _toy(x, sigma, cond):
    """eps from the latents and, per sample, the context (a batched CFG
    pair gives each half its own)."""
    ctx = cond.context
    return x * ctx.mean(axis=(1, 2)).reshape(-1, 1, 1, 1) + x * x * ctx[:, :1, :1].sum(axis=2)[
        ..., None, None]


def test_rescale_cfg_matches_jax():
    rng = np.random.default_rng(10)
    x = rng.standard_normal((1, 3, 4, 4), dtype=np.float32)
    ctxs = [rng.standard_normal((1, 3, 5), dtype=np.float32) for _ in range(2)]
    sig = np.asarray([3.0], np.float32)
    ref = np.asarray(jsmp.rescale_cfg_model(_toy, 6.0, 0.7)(
        jnp.asarray(x), jnp.asarray(sig), tuple(jcond.Conditioning(jnp.asarray(c)) for c in ctxs)))
    conds = tuple(tcond.Conditioning(torch.from_numpy(c)) for c in ctxs)
    got = tsmp.rescale_cfg_model(_toy, 6.0, 0.7)(torch.from_numpy(x), torch.from_numpy(sig), conds)
    plain = tsmp.cfg_model(_toy, 6.0)(torch.from_numpy(x), torch.from_numpy(sig), conds)
    assert float((got - plain).abs().max()) > 1e-2
    # measured 4.8e-7 on a CPU
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


def test_rescale_cfg_takes_the_population_std(monkeypatch):
    """The rescale is std(v_pos) / max(std(v_cfg), 1e-8): the kind of std
    cancels in the ratio and shows only where the clamp bites. Here both
    predictions are v = ±0.95e-8 over four values a sample (x = 0): the
    population std (jnp.std, the JAX package's) is 0.95e-8 and clamps to
    1e-8, the unbiased one (torch's default) is 1.1e-8 and does not, and
    the results part by 5 %. This test fails with the unbiased std."""
    s = 3.0
    v = np.asarray([1.0, -1.0, 1.0, -1.0], np.float32).reshape(1, 2, 2, 1) * 0.95e-8

    eps = v * np.float32(-1.0 / np.sqrt(s * s + 1.0))

    def model(x, sigma, cond):  # eps whose v at x = 0 is `v`, whatever the cond
        return x * 0 + (torch.from_numpy(eps) if torch.is_tensor(x) else jnp.asarray(eps))

    sig = np.asarray([s], np.float32)
    x = np.zeros((1, 2, 2, 1), np.float32)
    jconds = tuple(jcond.Conditioning(jnp.zeros((1, 1, 2))) for _ in range(2))
    tconds = tuple(tcond.Conditioning(torch.zeros((1, 1, 2))) for _ in range(2))
    ref = np.asarray(jsmp.rescale_cfg_model(model, 4.0, 1.0)(jnp.asarray(x), jnp.asarray(sig),
                                                             jconds))
    got = tsmp.rescale_cfg_model(model, 4.0, 1.0)(torch.from_numpy(x), torch.from_numpy(sig),
                                                  tconds).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=0)
    std = torch.std
    monkeypatch.setattr(torch, "std", lambda t, dim, keepdim, correction: std(
        t, dim=dim, keepdim=keepdim, correction=1))
    unbiased = tsmp.rescale_cfg_model(model, 4.0, 1.0)(torch.from_numpy(x), torch.from_numpy(sig),
                                                       tconds).numpy()
    assert np.abs(unbiased - ref).max() > 0.04 * np.abs(ref).max()


# --- the one-patch rule and the cached bundle ------------------------------------------------------

PATCHES = {
    "PerturbedAttentionGuidance": lambda m: tloaders.PerturbedAttentionGuidance().patch(m),
    "SelfAttentionGuidance": lambda m: tloaders.SelfAttentionGuidance().patch(m),
    "RescaleCFG": lambda m: tloaders.RescaleCFG().patch(m),
}


@pytest.mark.parametrize("first", list(PATCHES))
@pytest.mark.parametrize("second", list(PATCHES))
def test_one_guidance_patch_a_model(pair, first, second):
    _, tb = pair
    (patched,) = PATCHES[first](tb)
    with pytest.raises(ValueError, match=f"{second} cannot combine with {first}"):
        PATCHES[second](patched)


def test_guided_model_refuses_a_hand_built_bundle_with_two_patches(pair):
    _, tb = pair
    both = dataclasses.replace(tb, sag=tpl.SAGSpec(), cfg_rescale=0.7)
    with pytest.raises(ValueError, match="cannot combine on one model"):
        tpl.guided_model(both, 5.0)


def test_freeu_stacks_with_a_guidance_patch_and_refuses_other_families(pair):
    _, tb = pair
    (freeu,) = tloaders.FreeU_V2().patch(tb)
    (sag,) = tloaders.SelfAttentionGuidance().patch(freeu)
    assert sag.unet.config.freeu == (1.3, 1.4, 0.9, 0.2, True) and sag.sag is not None
    other = dataclasses.replace(tb, model_name="tiny-vae")
    for node in (tloaders.FreeU(), tloaders.SelfAttentionGuidance()):
        with pytest.raises(ValueError, match="vae-family"):
            node.patch(other)


def _txt2img_workflow():
    with open(os.path.join(REPO, "workflows", "distributed-txt2img.json"), encoding="utf-8") as fh:
        prompt = json.load(fh)
    prompt["1"]["inputs"]["ckpt_name"] = "tiny-unet"
    prompt["4"]["inputs"].update(width=32, height=32)
    prompt["6"]["inputs"].update(steps=3, cfg=5.0)
    return prompt


def test_the_cached_bundle_renders_as_before_after_a_patched_run(pair):
    """Each patch returns a new bundle over the same modules: the bundle
    the executor caches for the checkpoint keeps no patch, so the plain
    workflow's image is the same after patched runs as before them."""
    _, tb = pair
    workflow = _txt2img_workflow()
    executor = GraphExecutor(ExecutionContext(device="cpu", pipelines={"tiny-unet": tb}))
    plain = {k: v for k, v in workflow.items() if k != "9"}

    def image(prompt):
        executor.context.extras.pop("node_cache", None)
        executor.execute(prompt)
        return executor.last_results["8"][0]

    before = image(plain)
    weights = {name: p.data_ptr() for name, p in tb.unet.named_parameters()}
    patched = [image({k: v for k, v in p.items() if k != "9"})
               for p in chip_smoke._guidance_variants(workflow, 32).values()]
    assert all(float((p - before).abs().max()) > 1e-4 for p in patched)
    assert tb.unet.config.freeu is None and tb.sag is None and tb.cfg_rescale is None
    assert {name: p.data_ptr() for name, p in tb.unet.named_parameters()} == weights
    torch.testing.assert_close(image(plain), before, rtol=0, atol=0)


# --- the patch nodes and the area entry through both executors ---------------------------------------

@pytest.mark.parametrize("variant", list(chip_smoke.GUIDANCE_PATCHES) + ["area"])
def test_the_guidance_phases_workflows_match_jax(pair, variant, monkeypatch):
    """chip_smoke.py's guidance variants of the bundled txt2img workflow on
    tiny-unet at 32 px, 3 euler steps, CFG 5: each patch node between the
    checkpoint and KSampler, and the positive combined with an area entry
    over the top half gated to progress [0, 0.5). Tolerance 5e-5 on
    [0, 1] pixels (measured up to 5.1e-6 on a CPU)."""
    jb, tb = pair
    workflow = chip_smoke._guidance_variants(_txt2img_workflow(), 32)[variant]
    ref, got = run_workflow_in_both(workflow, jb, tb, monkeypatch)
    plain_ref, _ = run_workflow_in_both(_txt2img_workflow(), jb, tb, monkeypatch)
    assert got.shape == ref.shape == (1, 32, 32, 3)
    assert np.abs(ref - plain_ref).max() > 1e-3  # the patch moved the JAX image too
    np.testing.assert_allclose(got, ref, atol=5e-5, rtol=0)
