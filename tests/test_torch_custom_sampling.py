"""The custom-sampling nodes, PerpNeg and DualCFG in the port against the
JAX package, on the CPU in f32.

- Every scheduler and sigma node against its JAX twin: the same numpy
  code, so the grids agree to the bit (tolerance 0).
- `perp_neg_model` and `dual_cfg_model` on a toy model on both sides of
  `_conds_batchable` (one 3B call where the three sides batch, three
  calls where one has a mask or another context length), against the
  JAX functions at 1e-5 relative to the largest |eps|; DualCFG's two
  invariants (regular with cond2 = negative is CFG over (cond1,
  negative); nested at cfg_conds 1 is CFG at cfg_cond2_negative, run as
  that 2B program).
- SamplerCustomAdvanced through both packages' nodes on tiny-unet
  (numpy-seeded weights carried by `from_jax_params`, the JAX package's
  initial noise handed to the port): a stage of a split schedule, its
  denoised output and the resumed second stage under CFGGuider,
  PerpNegGuider and DualCFGGuider; 5e-5 absolute on the sampled latents
  (as tests/test_torch_parity.py's users hold them) relative to their
  size, stated per case.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_distributed_tpu.graph import nodes_core as jnc
from comfyui_distributed_tpu.graph import nodes_custom_sampling as jcs
from comfyui_distributed_tpu.ops import conditioning as jcond
from comfyui_distributed_tpu.ops import samplers as jsmp
from comfyui_distributed_tpu_torch.graph import ExecutionContext
from comfyui_distributed_tpu_torch.graph import nodes_core as tnc
from comfyui_distributed_tpu_torch.graph import nodes_custom_sampling as tcs
from comfyui_distributed_tpu_torch.graph.nodes_core import SeedSpec
from comfyui_distributed_tpu_torch.models import layers as tlayers
from comfyui_distributed_tpu_torch.models import pipeline as tpl
from comfyui_distributed_tpu_torch.ops import conditioning as tcond
from comfyui_distributed_tpu_torch.ops import samplers as tsmp
from test_torch_parity import jax_and_port_bundles, jax_noise, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def pair():
    return jax_and_port_bundles("tiny-unet")


# --- the sigma nodes ---------------------------------------------------------------------------

SIGMA_NODES = {
    "KarrasScheduler": ("get_sigmas", dict(steps=7, sigma_max=14.6, sigma_min=0.03, rho=7.0)),
    "ExponentialScheduler": ("get_sigmas", dict(steps=6, sigma_max=10.0, sigma_min=0.1)),
    "PolyexponentialScheduler": ("get_sigmas", dict(steps=5, sigma_max=14.6, sigma_min=0.03,
                                                    rho=2.5)),
}
MODEL_SIGMA_NODES = {
    "BasicScheduler-karras": ("BasicScheduler", dict(scheduler="karras", steps=9, denoise=1.0)),
    "BasicScheduler-normal-half": ("BasicScheduler", dict(scheduler="normal", steps=6,
                                                          denoise=0.5)),
    "BasicScheduler-beta": ("BasicScheduler", dict(scheduler="beta", steps=8, denoise=1.0)),
    "BasicScheduler-zero": ("BasicScheduler", dict(scheduler="simple", steps=4, denoise=0.0)),
    "BetaSamplingScheduler": ("BetaSamplingScheduler", dict(steps=10, alpha=0.5, beta=0.7)),
    "SDTurboScheduler": ("SDTurboScheduler", dict(steps=3, denoise=0.8)),
}


@pytest.mark.parametrize("name", list(SIGMA_NODES))
def test_model_free_schedulers_equal_jax(name):
    method, kwargs = SIGMA_NODES[name]
    (ref,) = getattr(getattr(jcs, name)(), method)(**kwargs)
    (got,) = getattr(getattr(tcs, name)(), method)(**kwargs)
    assert got.dtype == torch.float32 and float(got[-1]) == 0.0
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("case", list(MODEL_SIGMA_NODES))
def test_model_schedulers_equal_jax(pair, case):
    jb, tb = pair
    name, kwargs = MODEL_SIGMA_NODES[case]
    (ref,) = getattr(jcs, name)().get_sigmas(jb, **kwargs)
    (got,) = getattr(tcs, name)().get_sigmas(tb, **kwargs)
    assert got.shape == np.asarray(ref).shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("step", [0, 3, 9])
@pytest.mark.parametrize("denoise", [0.0, 0.45, 1.0])
def test_split_and_flip_nodes_equal_jax(step, denoise):
    sig = tsmp.get_sigmas("karras", 8)
    jsig = jnp.asarray(sig.numpy())
    for got, ref in zip(tcs.SplitSigmas().split(sig, step), jcs.SplitSigmas().split(jsig, step)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    for got, ref in zip(tcs.SplitSigmasDenoise().split(sig, denoise),
                        jcs.SplitSigmasDenoise().split(jsig, denoise)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    (flipped,) = tcs.FlipSigmas().flip(sig)
    np.testing.assert_array_equal(flipped.numpy(), np.asarray(jcs.FlipSigmas().flip(jsig)[0]))
    assert float(flipped[0]) == pytest.approx(1e-4) and float(sig[-1]) == 0.0


def test_sampler_select_and_turbo_refuse_bad_inputs(pair):
    _, tb = pair
    assert tcs.KSamplerSelect().get_sampler("dpmpp_2m")[0].name == "dpmpp_2m"
    with pytest.raises(ValueError, match="unknown sampler"):
        tcs.KSamplerSelect().get_sampler("eulr")
    with pytest.raises(ValueError, match="1-10 steps"):
        tcs.SDTurboScheduler().get_sigmas(tb, steps=11)


# --- PerpNeg and DualCFG on a toy model ----------------------------------------------------------

def _toy(calls):
    """eps from the latents and, per sample, the context; each call's
    batch recorded."""

    def model(x, sigma, cond):
        calls.append(int(x.shape[0]))
        ctx = cond.context
        return x * ctx.mean(axis=(1, 2)).reshape(-1, 1, 1, 1) + x * x * ctx[:, :1, :1].sum(
            axis=2)[..., None, None]

    return model


def _conds(kind):
    """Three conditionings (a, b, c) for both packages: "plain" batch;
    "mask" puts a mask on b (the per-entry path); "length" gives c
    another context length (the static shapes differ)."""
    rng = np.random.default_rng(11)
    ctxs = [rng.standard_normal((1, 3, 5), dtype=np.float32) for _ in range(3)]
    if kind == "length":
        ctxs[2] = rng.standard_normal((1, 4, 5), dtype=np.float32)
    mask = (rng.random((1, 3, 4)) > 0.4).astype(np.float32) if kind == "mask" else None
    out = []
    for mod, conv in ((jcond, jnp.asarray), (tcond, torch.from_numpy)):
        conds = [mod.Conditioning(conv(c)) for c in ctxs]
        if mask is not None:
            conds[1].mask = conv(mask)
        out.append(conds)
    return out


def _call(fn, x, sig, cond, jax_side):
    conv = jnp.asarray if jax_side else torch.from_numpy
    return np.asarray(fn(conv(x), conv(sig), cond))


@pytest.mark.parametrize("kind, calls_expected", [("plain", [3]), ("mask", [1, 1, 1]),
                                                  ("length", [1, 1, 1])])
@pytest.mark.parametrize("which", ["perp_neg", "dual_regular", "dual_nested"])
def test_perp_neg_and_dual_cfg_match_jax_on_both_sides_of_batching(kind, calls_expected, which):
    """Tolerance 1e-5 of the largest |eps| (f32 on both sides)."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((1, 3, 4, 4), dtype=np.float32)
    sig = np.asarray([2.5], np.float32)
    (ja, jb, jc), (ta, tb, tc) = _conds(kind)
    jcalls, tcalls = [], []
    if which == "perp_neg":
        jf = jsmp.perp_neg_model(_toy(jcalls), 5.0, 0.7)
        tf = tsmp.perp_neg_model(_toy(tcalls), 5.0, 0.7)
    else:
        nested = which == "dual_nested"
        jf = jsmp.dual_cfg_model(_toy(jcalls), 4.0, 2.5, nested=nested)
        tf = tsmp.dual_cfg_model(_toy(tcalls), 4.0, 2.5, nested=nested)
    ref = _call(jf, x, sig, ((ja, jb), jc), True)
    got = _call(tf, x, sig, ((ta, tb), tc), False)
    assert tcalls == calls_expected and jcalls == calls_expected
    np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max(), rtol=0)


def test_dual_cfg_invariants():
    """Regular with cond2 = negative is plain CFG over (cond1, negative)
    at cfg_conds; nested at cfg_conds 1 is plain CFG over (cond1,
    negative) at cfg_cond2_negative and runs as that one 2B call."""
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.standard_normal((1, 3, 4, 4), dtype=np.float32))
    sig = torch.tensor([1.5])
    _, (a, b, c) = _conds("plain")
    calls = []
    regular = tsmp.dual_cfg_model(_toy(calls), 4.0, 2.5)(x, sig, ((a, c), c))
    cfg = tsmp.cfg_model(_toy(calls), 4.0)(x, sig, (a, c))
    torch.testing.assert_close(regular, cfg, rtol=0, atol=1e-5 * float(cfg.abs().max()))
    calls.clear()
    nested = tsmp.dual_cfg_model(_toy(calls), 1.0, 2.5, nested=True)(x, sig, ((a, b), c))
    assert calls == [2]
    cfg = tsmp.cfg_model(_toy(calls), 2.5)(x, sig, (a, c))
    torch.testing.assert_close(nested, cfg, rtol=0, atol=0)


def test_perp_neg_drops_the_negatives_part_along_the_positive():
    """A negative parallel to the positive (eps_neg - eps_empty = k *
    (eps_pos - eps_empty)) has no orthogonal part: the result is the
    positive guided alone, whatever neg_scale."""
    x = torch.ones((1, 2, 2, 1))

    def model(x, sigma, cond):
        return cond.context.reshape(-1, 1, 1, 1) * x

    conds = tuple(tcond.Conditioning(torch.tensor([[[v]]])) for v in (3.0, 7.0, 1.0))
    out = tsmp.perp_neg_model(model, 5.0, 2.0)(x, torch.tensor([1.0]),
                                                ((conds[0], conds[1]), conds[2]))
    torch.testing.assert_close(out, torch.full_like(x, 1.0 + 5.0 * 2.0))


def test_guider_patches_exclude_each_other(pair):
    _, tb = pair
    cond = torch.zeros((1, 16, 64))
    (perp,) = tcs.PerpNegGuider().get_guider(tb, cond, cond, cond)
    with pytest.raises(ValueError, match="DualCFGGuider cannot combine with PerpNegGuider"):
        tcs.DualCFGGuider().get_guider(perp.bundle, cond, cond, cond)
    with pytest.raises(ValueError, match="unknown style"):
        tcs.DualCFGGuider().get_guider(tb, cond, cond, cond, style="both")
    assert tb.perp_neg is None and tb.dual_cfg is None


# --- SamplerCustomAdvanced through both packages --------------------------------------------------

def _guiders(mod, bundle, pos, alt, neg):
    return {
        "CFGGuider": mod.CFGGuider().get_guider(bundle, pos, neg, 7.0)[0],
        "PerpNegGuider": mod.PerpNegGuider().get_guider(bundle, pos, alt, neg, 6.0, 0.8)[0],
        "DualCFGGuider": mod.DualCFGGuider().get_guider(bundle, pos, alt, neg, 4.0, 3.0)[0],
    }


def _two_stages(mod, core, bundle, guider, context=None):
    kw = {} if context is None else {"context": context}
    (latent,) = core.EmptyLatentImage().generate(32, 32, 1, **kw)
    (sig,) = mod.BasicScheduler().get_sigmas(bundle, "karras", 4, 1.0)
    high, low = mod.SplitSigmas().split(sig, 2)
    (sampler,) = mod.KSamplerSelect().get_sampler("euler")
    (noise,) = mod.RandomNoise().get_noise(5)
    s1, s1_den = mod.SamplerCustomAdvanced().sample(noise, guider, sampler, high, latent)
    (off,) = mod.DisableNoise().get_noise()
    s2, s2_den = mod.SamplerCustomAdvanced().sample(off, guider, sampler, low, s1)
    return [np.asarray(d["samples"]) for d in (s1, s1_den, s2, s2_den)]


@pytest.mark.parametrize("guider", ["CFGGuider", "PerpNegGuider", "DualCFGGuider"])
def test_two_stage_custom_sampling_matches_jax(pair, guider, monkeypatch):
    """Stage 1 stops at sigma[2] > 0 (its denoised output is one more
    guided evaluation), stage 2 resumes without noise to 0 (its denoised
    output is its output). The latents reach |x| ≈ 15-130 on random
    weights: 5e-5 absolute per unit of the largest |x| (f32 summation
    order), the 5e-5 of tests/test_torch_parity.py's latent cases at
    scale 1."""
    jb, tb = pair
    monkeypatch.setattr(tpl, "default_noise",
                        lambda seed, shape, device: torch.from_numpy(jax_noise(seed, shape)))
    rng = np.random.default_rng(14)
    ctx = [rng.standard_normal((1, 16, 64), dtype=np.float32) for _ in range(3)]
    jg = _guiders(jcs, jb, *(jcond.Conditioning(jnp.asarray(c)) for c in ctx))[guider]
    tg = _guiders(tcs, tb, *(tcond.Conditioning(torch.from_numpy(c)) for c in ctx))[guider]
    refs = _two_stages(jcs, jnc, jb, jg)
    gots = _two_stages(tcs, tnc, tb, tg, ExecutionContext(device="cpu"))
    assert np.abs(refs[1] - refs[0]).max() > 0.1  # the denoised output is its own
    np.testing.assert_array_equal(gots[3], gots[2])
    for got, ref in zip(gots, refs):
        scale = max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(got, ref, atol=5e-5 * scale, rtol=0)


def test_perp_neg_and_dual_cfg_run_the_unet_at_batch_3(pair, monkeypatch):
    """Each evaluation of PerpNegGuider and DualCFGGuider is one UNet call
    at batch 3 (every attention call's batch is 3); CFGGuider's at 2."""
    _, tb = pair
    batches = []
    attention = tlayers.dot_product_attention

    def record(q, k, v):
        batches.append(int(q.shape[0]))
        return attention(q, k, v)

    monkeypatch.setattr(tlayers, "dot_product_attention", record)
    ctx = [torch.randn((1, 16, 64), generator=torch.Generator().manual_seed(i)) for i in range(3)]
    guiders = _guiders(tcs, tb, *(tcond.Conditioning(c) for c in ctx))
    for name, batch in (("PerpNegGuider", 3), ("DualCFGGuider", 3), ("CFGGuider", 2)):
        batches.clear()
        _two_stages(tcs, tnc, tb, guiders[name], ExecutionContext(device="cpu"))
        assert batches and set(batches) == {batch}, name


def test_random_noise_takes_the_worker_seed_and_refuses_the_mesh(pair):
    """A worker's SeedSpec through RandomNoise samples base + index + 1,
    as KSampler does; a per-participant spec (the mesh fan-out) raises."""
    _, tb = pair
    ctx = torch.randn((1, 16, 64), generator=torch.Generator().manual_seed(3))
    (guider,) = tcs.CFGGuider().get_guider(tb, ctx, ctx * 0.5, 5.0)
    (sig,) = tcs.BasicScheduler().get_sigmas(tb, "karras", 2, 1.0)
    (sampler,) = tcs.KSamplerSelect().get_sampler("euler")
    latent = {"samples": torch.zeros((1, 4, 4, 4))}

    def run(seed):
        (noise,) = tcs.RandomNoise().get_noise(seed)
        return tcs.SamplerCustomAdvanced().sample(noise, guider, sampler, sig, latent)[0]

    torch.testing.assert_close(run(SeedSpec(40, worker_index=1))["samples"],
                               run(42)["samples"], rtol=0, atol=0)
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        run(SeedSpec(40, per_participant=True))
    empty = tcs.SamplerCustomAdvanced().sample(tcs.DisableNoise().get_noise()[0], guider,
                                               sampler, sig[:0], latent)
    assert all(torch.equal(d["samples"], latent["samples"]) for d in empty)


def test_sampler_custom_equals_the_advanced_node_with_cfg_guider(pair):
    _, tb = pair
    ctx = torch.randn((1, 16, 64), generator=torch.Generator().manual_seed(4))
    (sig,) = tcs.KarrasScheduler().get_sigmas(steps=3)
    (sampler,) = tcs.KSamplerSelect().get_sampler("euler")
    latent = {"samples": torch.zeros((1, 4, 4, 4))}
    out = tcs.SamplerCustom().sample(tb, True, 9, 6.0, ctx, ctx * 0.3, sampler, sig, latent)
    (guider,) = tcs.CFGGuider().get_guider(tb, ctx, ctx * 0.3, 6.0)
    adv = tcs.SamplerCustomAdvanced().sample(tcs.RandomNoise().get_noise(9)[0], guider, sampler,
                                             sig, latent)
    for a, b in zip(out, adv):
        torch.testing.assert_close(a["samples"], b["samples"], rtol=0, atol=0)
    (basic,) = tcs.BasicGuider().get_guider(tb, ctx)
    assert basic.negative is None and dataclasses.replace(basic).cfg == 1.0
