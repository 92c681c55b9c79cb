"""KSamplerAdvanced and the bundled two-pass workflow in the port against
the JAX package, on the CPU in f32.

- `advanced_window_sigmas` over the edges of its window: starts and ends
  clamped, the last sigma forced to 0, the VP table for eps and v.
- `img2img_latents_advanced` on tiny-unet with the JAX package's noise
  and weights (`from_jax_params`): a refine pass that adds no noise over
  a noise mask, whose pin uses zero noise.
- `workflows/distributed-txt2img-2pass.json`, unmodified but for the
  checkpoint (tiny-unet) and the size (32 px), through both packages'
  GraphExecutors: CLIPSetLastLayer, then 14 steps with leftover noise
  and 6 refine steps without noise.
- The port alone: the two passes walk one KSampler's trajectory, the
  node's flags, empty windows, the mask's exact keep.

Tolerances: both sides are f32 and differ in summation order and in the
last bit of exp/erf; the latents start at 14.6 times unit noise, and 20
euler steps carry a few 1e-6 of that scale forward. Each tolerance
leaves a margin of about ten over the difference measured on a CPU.
"""

import json
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_distributed_tpu.models import pipeline as jpl
from comfyui_distributed_tpu_torch.graph.nodes_core import (
    EmptyLatentImage,
    KSampler,
    KSamplerAdvanced,
)
from comfyui_distributed_tpu_torch.models import pipeline as tpl
from test_torch_parity import (  # noqa: F401  (one_torch_thread: fixture)
    jax_and_port_bundles,
    jax_noise,
    one_torch_thread,
    run_workflow_in_both,
)

# one intra-op thread: the tiny models gain nothing from more, and the
# xdist run's processes would oversubscribe the cores
pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("param", ["eps", "v"])
@pytest.mark.parametrize("steps, start, end, force", [
    (8, 2, 5, False), (8, 2, 5, True), (8, 0, 10000, False), (8, 0, 10000, True),
    (8, -3, 4, False), (8, 5, 2, True), (8, 9, 12, True), (8, 8, 8, True),
    (8, 7, 8, False), (20, 0, 14, False), (20, 14, 20, True), (1, 0, 1, True),
])
def test_advanced_window_sigmas_match_jax(param, steps, start, end, force):
    ref = np.asarray(jpl.advanced_window_sigmas(param, "karras", steps, start, end, force, 3.0))
    got = tpl.advanced_window_sigmas(param, "karras", steps, start, end, force)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.fixture(scope="module")
def pair():
    return jax_and_port_bundles("tiny-unet")


def _conds(seed=5):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((1, 16, 64), dtype=np.float32) for _ in range(2))


def test_no_noise_masked_refine_pass_matches_jax(pair):
    """add_noise disabled with a noise mask: the trajectory starts from
    the latents as given and the pin uses zero noise, in both packages;
    the unmasked half comes back exactly."""
    jb, tb = pair
    rng = np.random.default_rng(8)
    z = rng.standard_normal((1, 4, 4, 4), dtype=np.float32) * 3.0
    mask = np.zeros((1, 4, 4, 1), np.float32)
    mask[:, 2:] = 1.0
    pos, neg = _conds()
    kw = dict(steps=20, sampler="euler", scheduler="karras", cfg_scale=7.0, seed=3,
              start_at_step=14, end_at_step=20, add_noise=False, force_full_denoise=True)
    ref = np.asarray(jpl.img2img_latents_advanced(
        jb, jnp.asarray(z), jnp.asarray(pos), jnp.asarray(neg), noise_mask=jnp.asarray(mask),
        **kw))
    got = tpl.img2img_latents_advanced(
        tb, torch.from_numpy(z), torch.from_numpy(pos), torch.from_numpy(neg),
        noise_mask=torch.from_numpy(mask), **kw).numpy()
    np.testing.assert_array_equal(got[:, :2], z[:, :2])
    assert np.abs(got[:, 2:] - z[:, 2:]).max() > 0.1  # the masked half moved
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)  # measured 7.2e-7


def _two_pass_workflow():
    with open(os.path.join(REPO, "workflows", "distributed-txt2img-2pass.json"),
              encoding="utf-8") as fh:
        workflow = json.load(fh)
    workflow["1"]["inputs"]["ckpt_name"] = "tiny-unet"
    workflow["5"]["inputs"].update(width=32, height=32)
    return workflow


def test_two_pass_workflow_matches_the_jax_executor(pair, monkeypatch):
    jb, tb = pair
    ref, got = run_workflow_in_both(_two_pass_workflow(), jb, tb, monkeypatch)
    assert got.shape == ref.shape == (1, 32, 32, 3)
    assert got.std() > 0.01  # an image, not a constant
    np.testing.assert_allclose(got, ref, atol=3e-5, rtol=0)  # measured 3.1e-6


def _port_conds(tb):
    return tuple(tpl.encode_text_pooled(tb, [t]) for t in ("a harbor", ""))


def test_two_passes_walk_one_ksampler_trajectory(pair):
    """Steps 0-14 with leftover noise, then 14-20 without adding noise:
    the euler trajectory of one 20-step KSampler run, to the bit: the
    same sigmas and the same operations in the same order."""
    _, tb = pair
    (empty,) = EmptyLatentImage().generate(32, 32, 1, context=types.SimpleNamespace(device="cpu"))
    pos, neg = _port_conds(tb)
    args = dict(steps=20, cfg=7.0, sampler_name="euler", scheduler="karras", positive=pos,
                negative=neg)
    (single,) = KSampler().sample(tb, 5, latent_image=empty, denoise=1.0, **args)
    (first,) = KSamplerAdvanced().sample(tb, "enable", 5, latent_image=empty, start_at_step=0,
                                         end_at_step=14, return_with_leftover_noise="enable",
                                         **args)
    (second,) = KSamplerAdvanced().sample(tb, "disable", 5, latent_image=first,
                                          start_at_step=14, end_at_step=20,
                                          return_with_leftover_noise="disable", **args)
    assert not torch.equal(first["samples"], single["samples"])
    assert torch.equal(second["samples"], single["samples"])


def test_flags_are_validated(pair):
    _, tb = pair
    latent = {"samples": torch.zeros((1, 4, 4, 4))}
    pos, neg = _port_conds(tb)
    args = dict(noise_seed=1, steps=2, cfg=7.0, sampler_name="euler", scheduler="karras",
                positive=pos, negative=neg, latent_image=latent)
    with pytest.raises(ValueError, match="add_noise"):
        KSamplerAdvanced().sample(tb, "yes", **args)
    with pytest.raises(ValueError, match="return_with_leftover_noise"):
        KSamplerAdvanced().sample(tb, "enable", return_with_leftover_noise="maybe", **args)


def test_empty_windows(pair):
    """No step to take: without noise the latents come back as given;
    with noise and a mask, the kept half comes back exactly and the
    other is noised."""
    _, tb = pair
    z = torch.from_numpy(np.random.default_rng(4).standard_normal((1, 4, 4, 4),
                                                                  dtype=np.float32))
    pos, neg = _port_conds(tb)
    args = dict(steps=4, cfg=7.0, sampler_name="euler", scheduler="karras", positive=pos,
                negative=neg, start_at_step=2, end_at_step=2)
    (out,) = KSamplerAdvanced().sample(tb, "disable", 1, latent_image={"samples": z}, **args)
    assert torch.equal(out["samples"], z)
    mask = torch.zeros((1, 4, 4, 1))
    mask[:, 2:] = 1.0
    (out,) = KSamplerAdvanced().sample(tb, "enable", 3, latent_image={
        "samples": z, "noise_mask": mask}, **args)
    assert torch.equal(out["samples"][:, :2], z[:, :2])
    assert not torch.equal(out["samples"][:, 2:], z[:, 2:])
    assert out["noise_mask"] is mask  # carried forward for a chained pass


def test_noise_is_the_seeds_default_or_the_one_given(pair):
    _, tb = pair
    z = torch.zeros((1, 4, 4, 4))
    pos, neg = _port_conds(tb)
    kw = dict(steps=4, start_at_step=0, end_at_step=2, force_full_denoise=False)
    a = tpl.img2img_latents_advanced(tb, z, pos, neg, seed=9, **kw)
    b = tpl.img2img_latents_advanced(tb, z, pos, neg, noise=torch.from_numpy(
        jax_noise(9, (1, 4, 4, 4))), **kw)
    c = tpl.img2img_latents_advanced(tb, z, pos, neg, noise=tpl.default_noise(
        9, (1, 4, 4, 4), "cpu"), **kw)
    assert torch.equal(a, c) and not torch.equal(a, b)
