"""The port's samplers and schedulers against the JAX package's
(comfyui_distributed_tpu/ops/samplers.py) on the CPU: sigmas bit for
bit, every sampler's trajectory on a toy model written in both
frameworks (the JAX package's step noise replayed for the stochastic
ones), the evaluation counts, and tiny-unet txt2img and a tiny USDU
upscale through the executors for one deterministic second-order and
one stochastic sampler."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_distributed_tpu.models import pipeline as jpl
from comfyui_distributed_tpu.ops import samplers as jsmp
from comfyui_distributed_tpu_torch.models import pipeline as tpl
from comfyui_distributed_tpu_torch.ops import samplers as tsmp

from test_torch_parity import (  # noqa: F401  (one_torch_thread: fixture)
    JaxTileNoise,
    jax_and_port_bundles,
    jax_step_noise,
    one_torch_thread,
    run_workflow_in_both,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

STOCHASTIC = ("euler_ancestral", "dpm_2_ancestral", "dpmpp_2s_ancestral", "dpmpp_sde",
              "dpmpp_2m_sde", "lcm")


def test_the_names_are_the_jax_packages():
    assert tsmp.SAMPLER_NAMES == jsmp.SAMPLER_NAMES
    assert tsmp.SCHEDULER_NAMES == jsmp.SCHEDULER_NAMES
    assert set(STOCHASTIC) == set(tsmp._STOCHASTIC)
    assert tsmp._SECOND_ORDER == jsmp._SECOND_ORDER


# --- schedulers ---------------------------------------------------------------

@pytest.mark.parametrize("parameterization", ["eps", "v"])
@pytest.mark.parametrize("denoise", [1.0, 0.35])
@pytest.mark.parametrize("steps", [1, 2, 12, 20])
@pytest.mark.parametrize("scheduler", jsmp.SCHEDULER_NAMES)
def test_sigmas_equal_to_the_last_bit(scheduler, steps, denoise, parameterization):
    ref = np.asarray(jsmp.get_model_sigmas(parameterization, scheduler, steps, denoise=denoise))
    out = tsmp.get_model_sigmas(parameterization, scheduler, steps, denoise=denoise).numpy()
    assert out.dtype == ref.dtype == np.float32
    assert out.shape == (steps + 1,)
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("scheduler", ["beta", "kl_optimal"])
def test_sigmas_pinned_by_the_goldens(scheduler):
    """The golden pins, read by path. One beta value sits on a rounding
    tie: its quantile is Beta(0.6, 0.6)'s median, 0.5 x 999 = 499.5 table
    steps, and the last bit of the bisected CDF sends it to table index
    499 or 500. The JAX package here takes 500, the golden file holds
    499; the port takes what the JAX package takes."""
    goldens = np.load("tests/golden/goldens.npz")
    golden = goldens[f"sigmas_{scheduler}_12"]
    out = tsmp.get_sigmas(scheduler, 12).numpy()
    np.testing.assert_array_equal(out, np.asarray(jsmp.get_sigmas(scheduler, 12)))
    differs = np.flatnonzero(out != golden).tolist()
    if scheduler == "beta" and differs:
        ties = set(tsmp._vp_sigmas()[[499, 500]].astype(np.float32).tolist())
        assert differs == [6] and {float(out[6]), float(golden[6])} == ties
    else:
        assert differs == []


@pytest.mark.parametrize("rho", [1.0, 2.5])
def test_grid_helpers_equal_jax(rho):
    np.testing.assert_array_equal(tsmp.exponential_sigmas(0.03, 14.6, 9),
                                  jsmp.exponential_sigmas(0.03, 14.6, 9))
    np.testing.assert_array_equal(tsmp.polyexponential_sigmas(0.03, 14.6, 9, rho),
                                  jsmp.polyexponential_sigmas(0.03, 14.6, 9, rho))
    q = np.linspace(0.0, 1.0, 11)
    np.testing.assert_array_equal(tsmp._beta_ppf(q, 0.6, rho), jsmp._beta_ppf(q, 0.6, rho))


def test_unknown_names_raise_with_the_valid_ones():
    with pytest.raises(ValueError, match="kl_optimal"):
        tsmp.get_sigmas("linear", 10)
    with pytest.raises(ValueError, match="dpmpp_2m_sde"):
        tsmp.check_sampler_names("dpmpp_3m", "karras")
    with pytest.raises(ValueError, match="ddim_uniform"):
        tsmp.check_sampler_names("euler", "ays")
    tsmp.check_sampler_names("lcm", "sgm_uniform")


# --- samplers on a toy model --------------------------------------------------

def _toy_jax(x, sigma_batch, cond):
    sig = sigma_batch.reshape((-1, 1, 1, 1))
    return jnp.tanh(0.7 * x + 0.05 * sig) * 0.6 + 0.3 * cond + x * (sig / (sig * sig + 1.0))


def _toy_torch(x, sigma_batch, cond):
    sig = sigma_batch.reshape((-1, 1, 1, 1))
    return torch.tanh(0.7 * x + 0.05 * sig) * 0.6 + 0.3 * cond + x * (sig / (sig * sig + 1.0))


def _toy_inputs(scheduler, steps, denoise):
    rng = np.random.default_rng(11)
    sigmas = np.array(jsmp.get_sigmas(scheduler, steps, denoise=denoise))
    x = (rng.standard_normal((2, 4, 4, 3)) * sigmas[0]).astype(np.float32)
    cond = rng.standard_normal((2, 4, 4, 3)).astype(np.float32)
    return sigmas, x, cond


@pytest.mark.parametrize("schedule", [("karras", 6, 1.0), ("exponential", 4, 0.5)])
@pytest.mark.parametrize("sampler", jsmp.SAMPLER_NAMES)
def test_every_sampler_follows_jax_on_a_toy_model(sampler, schedule):
    """f32 trajectories from latents at sigma_max ~15: the two frameworks
    round their transcendentals differently, so the tolerance is 1e-5 of
    the latents' scale."""
    sigmas, x, cond = _toy_inputs(*schedule)
    key = jax.random.key(3)
    ref = np.asarray(jsmp.sample(_toy_jax, jnp.asarray(x), jnp.asarray(sigmas), jnp.asarray(cond),
                                 sampler, noise_key=key if sampler in STOCHASTIC else None))
    out = tsmp.sample(_toy_torch, torch.from_numpy(x), torch.from_numpy(sigmas),
                      torch.from_numpy(cond), sampler,
                      noise=jax_step_noise(key, sampler) if sampler in STOCHASTIC else None)
    assert out.dtype == torch.float32 and np.isfinite(ref).all()
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5 * float(np.abs(x).max()))


@pytest.mark.parametrize("sampler", STOCHASTIC)
def test_stochastic_samplers_need_step_noise_and_follow_it(sampler):
    sigmas, x, cond = _toy_inputs("karras", 4, 1.0)
    args = (_toy_torch, torch.from_numpy(x), torch.from_numpy(sigmas), torch.from_numpy(cond),
            sampler)
    with pytest.raises(ValueError, match="step noise"):
        tsmp.sample(*args)

    def run(seed):
        gen = torch.Generator()
        gen.manual_seed(seed)
        return tsmp.sample(*args, noise=tsmp.generator_step_noise(gen))

    assert torch.equal(run(1), run(1))
    assert not torch.allclose(run(1), run(2))


@pytest.mark.parametrize("steps", [1, 2, 5])
@pytest.mark.parametrize("sampler", jsmp.SAMPLER_NAMES)
def test_model_evals_per_scan_counts_the_model_calls(sampler, steps):
    sigmas = tsmp.get_sigmas("karras", steps)
    calls = []

    def counted(x, sigma_batch, cond):
        calls.append(sigma_batch.shape)
        return _toy_torch(x, sigma_batch, cond)

    gen = torch.Generator()
    gen.manual_seed(0)
    x = torch.randn((1, 2, 2, 3), generator=gen) * sigmas[0]
    tsmp.sample(counted, x, sigmas, torch.zeros_like(x), sampler,
                noise=tsmp.generator_step_noise(gen))
    assert len(calls) == tsmp.model_evals_per_scan(sampler, steps)
    assert tsmp.model_evals_per_scan(sampler, steps) == jsmp.model_evals_per_scan(sampler, steps)


# --- end to end: tiny-unet txt2img and a tiny USDU upscale -------------------------

# one deterministic second-order sampler and one stochastic sampler
END_TO_END = ("heun", "dpmpp_2m_sde")


@pytest.fixture(scope="module")
def pair():
    return jax_and_port_bundles("tiny-unet")


def _txt2img_workflow(sampler, scheduler="karras"):
    with open(os.path.join(REPO, "workflows", "distributed-txt2img.json"), encoding="utf-8") as fh:
        prompt = json.load(fh)
    prompt["1"]["inputs"]["ckpt_name"] = "tiny-unet"
    prompt["4"]["inputs"].update(width=32, height=32)
    prompt["6"]["inputs"].update(steps=3, cfg=3.0, sampler_name=sampler, scheduler=scheduler)
    return prompt


@pytest.mark.parametrize("sampler", END_TO_END)
def test_txt2img_workflow_matches_jax(pair, sampler, monkeypatch, one_torch_thread):
    """The bundled txt2img workflow on tiny-unet at 32 px, 3 steps,
    through both GraphExecutors; the port draws the JAX package's initial
    noise and, for the stochastic sampler, replays its step noise
    (split(key(seed))[1]). Tolerance as the two-pass workflow's, 3e-5 on
    [0, 1] pixels."""
    jb, tb = pair
    monkeypatch.setattr(tpl, "default_step_noise", lambda seed, device: jax_step_noise(
        jax.random.split(jax.random.key(seed))[1], sampler))
    ref, got = run_workflow_in_both(_txt2img_workflow(sampler), jb, tb, monkeypatch)
    assert got.shape == ref.shape == (1, 32, 32, 3)
    assert got.std() > 0.01
    np.testing.assert_allclose(got, ref, atol=3e-5, rtol=0)


@pytest.fixture(scope="module")
def adm_pair():
    """tiny-unet-adm (the SDXL layout) in both packages with the same
    numpy-seeded weights, at f32."""
    return jax_and_port_bundles("tiny-unet-adm", te_name="tiny-te-l", te2_name="tiny-te-g")


def _usdu_workflow(image, sampler):
    with open(os.path.join(REPO, "workflows", "distributed-upscale.json"), encoding="utf-8") as fh:
        prompt = json.load(fh)
    del prompt["4"], prompt["6"]
    prompt["1"]["inputs"]["ckpt_name"] = "tiny-unet-adm"
    prompt["5"]["inputs"].update(image=image, steps=2, tile_width=64, tile_height=64,
                                 tile_padding=16, seed=11, sampler_name=sampler)
    return prompt


@pytest.mark.parametrize("sampler", END_TO_END)
def test_usdu_workflow_matches_jax(adm_pair, sampler, monkeypatch, one_torch_thread):
    """The upscale workflow on tiny-unet-adm through the port's
    GraphExecutor (64 → 128 px, four 64-px tiles with 16-px padding, 2
    steps at denoise 0.35) against the JAX package's run_upscale with the
    node's options; the port's tile noise is the JAX package's, folded by
    the global tile index. Tolerance as the euler slice's, 5e-5."""
    from comfyui_distributed_tpu.ops import upscale as jup
    from comfyui_distributed_tpu_torch.graph import ExecutionContext, GraphExecutor
    from comfyui_distributed_tpu_torch.ops import upscale as tup

    jb, tb = adm_pair
    image = np.random.default_rng(3).random((1, 64, 64, 3), dtype=np.float32)
    prompt = _usdu_workflow(torch.from_numpy(image), sampler)
    texts = [prompt[prompt["5"]["inputs"][side][0]]["inputs"]["text"]
             for side in ("positive", "negative")]
    jpos, jneg = (jpl.encode_text_pooled(jb, [t]) for t in texts)
    ref = np.asarray(jup.run_upscale(
        jb, jnp.asarray(image), jpos, jneg, upscale_by=2.0, tile=64, tile_h=64, padding=16,
        steps=2, sampler=sampler, scheduler="karras", cfg=7.0, denoise=0.35, seed=11,
        mask_blur=8, tile_batch=1))
    monkeypatch.setattr(tup, "default_noise", lambda seed, device: JaxTileNoise(seed, sampler))
    context = ExecutionContext(device="cpu")
    context.pipelines["tiny-unet-adm"] = tb
    executor = GraphExecutor(context)
    assert executor.execute(prompt) == {}
    out = executor.last_results["5"][0].numpy()
    assert out.shape == ref.shape == (1, 128, 128, 3)
    np.testing.assert_allclose(out, ref, atol=5e-5, rtol=0)


def test_a_tiles_output_does_not_depend_on_its_grant(adm_pair, one_torch_thread):
    """With a stochastic sampler and the default tile noise, a tile run
    alone equals the same tile inside a larger grant, and its step noise
    follows the global tile index."""
    from comfyui_distributed_tpu_torch.graph.tile_pipeline import GrantSampler
    from comfyui_distributed_tpu_torch.ops import upscale as tup

    _, tb = adm_pair
    image = torch.from_numpy(np.random.default_rng(4).random((1, 64, 64, 3), dtype=np.float32))
    _, grid, extracted = tup.prepare_upscaled_tiles(image, 2.0, 64, 16)
    pos, neg = (tup.prep_cond_for_tiles(tpl.encode_text_pooled(tb, [t]), grid)
                for t in ("a", "b"))
    process = tup._process_tile_fn(tb, grid, 2, "euler_ancestral", "karras", 7.0, 0.35)
    with torch.no_grad():
        sampler = GrantSampler(process, extracted, grid.positions, pos, neg,
                               tup.default_noise(11, "cpu"))
        whole = sampler.sample([0, 1, 2, 3])
        alone = sampler.sample([2])
        reordered = sampler.sample([3, 2])
        other_seed = GrantSampler(process, extracted, grid.positions, pos, neg,
                                  tup.default_noise(12, "cpu")).sample([2])
    assert torch.equal(alone[0], whole[2]) and torch.equal(reordered[1], whole[2])
    assert not torch.allclose(other_seed[0], whole[2])


@pytest.mark.parametrize("sampler, scheduler, listed", [
    ("dpmpp_3m", "karras", "dpmpp_2m_sde"), ("euler", "ays", "kl_optimal"),
])
def test_the_sampler_nodes_reject_unknown_names(pair, sampler, scheduler, listed):
    """KSampler, KSamplerAdvanced and the upscale node raise ValueError
    listing the valid names, as the JAX package's do."""
    from comfyui_distributed_tpu_torch.graph.nodes_core import KSampler, KSamplerAdvanced
    from comfyui_distributed_tpu_torch.graph.nodes_upscale import UltimateSDUpscaleDistributed

    _, tb = pair
    args = dict(model=tb, steps=1, cfg=1.0, sampler_name=sampler, scheduler=scheduler,
                positive=None, negative=None, latent_image={"samples": torch.zeros((1, 4, 4, 4))})
    with pytest.raises(ValueError, match=listed):
        KSampler().sample(seed=1, **args)
    with pytest.raises(ValueError, match=listed):
        KSamplerAdvanced().sample(add_noise="enable", noise_seed=1, **args)
    with pytest.raises(ValueError, match=listed):
        UltimateSDUpscaleDistributed().run(torch.zeros((1, 64, 64, 3)), tb, None, None, None,
                                           sampler_name=sampler, scheduler=scheduler)
