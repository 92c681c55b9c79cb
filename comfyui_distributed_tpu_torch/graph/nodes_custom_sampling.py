"""The custom-sampling nodes: KSampler taken apart into NOISE, GUIDER,
SAMPLER and SIGMAS values that small nodes make and SamplerCustom or
SamplerCustomAdvanced consume.

Counterpart of comfyui_distributed_tpu/graph/nodes_custom_sampling.py,
with its node names and inputs. SIGMAS is a [n] f32 tensor on the host
(the samplers keep their scalars there). The schedulers are the same
numpy code as the JAX package's, so their grids agree to the bit.
DistributedSeed's SeedSpec goes through RandomNoise unchanged: on a
worker of the elastic tier its offset seed is the one sampled, as with
KSampler; the JAX package's mesh fan-out of a per-participant seed is
not ported (ROADMAP.md Queue 1 item 6) and raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..models import pipeline as pl
from ..ops import samplers as smp
from .nodes_core import _MESH_UNPORTED, SeedSpec, _prep_latents, resolve_seed
from .registry import register_node


@dataclasses.dataclass(frozen=True)
class SamplerSpec:
    """A SAMPLER value: which trajectory solver runs."""

    name: str


@dataclasses.dataclass(frozen=True)
class NoiseSpec:
    """A NOISE value: the seed of the initial noise (a SeedSpec, so
    DistributedSeed's link passes through), or none at all (DisableNoise:
    the trajectory starts from the latents as they are)."""

    seed: SeedSpec
    add_noise: bool = True


@dataclasses.dataclass(frozen=True)
class GuiderSpec:
    """A GUIDER value: the model, its conditioning and the guidance. A
    negative of None is BasicGuider (one evaluation a step at cfg 1)."""

    bundle: Any
    positive: Any
    negative: Any = None
    cfg: float = 1.0


def _terminal_zero(sigmas: np.ndarray) -> torch.Tensor:
    """A descending grid with the terminal 0 appended, f32 on the host."""
    return torch.from_numpy(np.concatenate([np.asarray(sigmas, np.float32),
                                            np.zeros((1,), np.float32)]))


@register_node
class KSamplerSelect:
    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"sampler_name": ("STRING", {"default": "euler"})}}

    RETURN_TYPES = ("SAMPLER",)
    FUNCTION = "get_sampler"

    def get_sampler(self, sampler_name: str, context=None):
        name = str(sampler_name)
        if name not in smp.SAMPLER_NAMES:
            raise ValueError(f"unknown sampler {name!r}; use {smp.SAMPLER_NAMES}")
        return (SamplerSpec(name),)


@register_node
class BasicScheduler:
    """The model's schedule shaped by `scheduler`; denoise < 1 keeps the
    tail of a longer one, denoise 0 gives the empty grid (no sampling)."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "model": ("MODEL",),
                "scheduler": ("STRING", {"default": "normal"}),
                "steps": ("INT", {"default": 20}),
                "denoise": ("FLOAT", {"default": 1.0}),
            }
        }

    RETURN_TYPES = ("SIGMAS",)
    FUNCTION = "get_sigmas"

    def get_sigmas(self, model, scheduler="normal", steps=20, denoise=1.0, context=None):
        if float(denoise) <= 0.0:
            return (torch.zeros((0,), dtype=torch.float32),)
        return (smp.get_model_sigmas(pl.model_schedule_info(model), str(scheduler), int(steps),
                                     denoise=float(denoise)),)


@register_node
class KarrasScheduler:
    """Karras's rho-spaced grid between sigma_max and sigma_min, then 0."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "steps": ("INT", {"default": 20}),
                "sigma_max": ("FLOAT", {"default": 14.614642}),
                "sigma_min": ("FLOAT", {"default": 0.0291675}),
                "rho": ("FLOAT", {"default": 7.0}),
            }
        }

    RETURN_TYPES = ("SIGMAS",)
    FUNCTION = "get_sigmas"

    def get_sigmas(self, steps=20, sigma_max=14.614642, sigma_min=0.0291675, rho=7.0,
                   context=None):
        return (_terminal_zero(smp.karras_sigmas(float(sigma_min), float(sigma_max), int(steps),
                                                 rho=float(rho))),)


@register_node
class ExponentialScheduler:
    """A log-uniform grid between sigma_max and sigma_min, then 0."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "steps": ("INT", {"default": 20}),
                "sigma_max": ("FLOAT", {"default": 14.614642}),
                "sigma_min": ("FLOAT", {"default": 0.0291675}),
            }
        }

    RETURN_TYPES = ("SIGMAS",)
    FUNCTION = "get_sigmas"

    def get_sigmas(self, steps=20, sigma_max=14.614642, sigma_min=0.0291675, context=None):
        return (_terminal_zero(smp.exponential_sigmas(float(sigma_min), float(sigma_max),
                                                      int(steps))),)


@register_node
class PolyexponentialScheduler:
    """A log-space ramp warped by rho (rho 1 is ExponentialScheduler),
    then 0."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "steps": ("INT", {"default": 20}),
                "sigma_max": ("FLOAT", {"default": 14.614642}),
                "sigma_min": ("FLOAT", {"default": 0.0291675}),
                "rho": ("FLOAT", {"default": 1.0}),
            }
        }

    RETURN_TYPES = ("SIGMAS",)
    FUNCTION = "get_sigmas"

    def get_sigmas(self, steps=20, sigma_max=14.614642, sigma_min=0.0291675, rho=1.0,
                   context=None):
        return (_terminal_zero(smp.polyexponential_sigmas(float(sigma_min), float(sigma_max),
                                                          int(steps), rho=float(rho))),)


@register_node
class BetaSamplingScheduler:
    """Beta-quantile spacing over the model's sigma table with alpha and
    beta exposed (0.6/0.6 is scheduler "beta"), then 0."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "model": ("MODEL",),
                "steps": ("INT", {"default": 20}),
                "alpha": ("FLOAT", {"default": 0.6}),
                "beta": ("FLOAT", {"default": 0.6}),
            }
        }

    RETURN_TYPES = ("SIGMAS",)
    FUNCTION = "get_sigmas"

    def get_sigmas(self, model, steps=20, alpha=0.6, beta=0.6, context=None):
        pl.model_schedule_info(model)  # the VP table: eps and v models
        sigmas = smp.beta_spaced_sigmas(np.asarray(smp._vp_sigmas()), int(steps), float(alpha),
                                        float(beta))
        return (_terminal_zero(np.asarray(sigmas, np.float32)),)


@register_node
class SDTurboScheduler:
    """`steps` sigmas of the training table at timesteps 999, 899, ...,
    99, starting (1 - denoise) * 10 decades down, then 0."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "model": ("MODEL",),
                "steps": ("INT", {"default": 1}),
                "denoise": ("FLOAT", {"default": 1.0}),
            }
        }

    RETURN_TYPES = ("SIGMAS",)
    FUNCTION = "get_sigmas"

    def get_sigmas(self, model, steps=1, denoise=1.0, context=None):
        pl.model_schedule_info(model)
        n = int(steps)
        if not 1 <= n <= 10:
            raise ValueError("SDTurboScheduler takes 1-10 steps")
        start = 10 - int(10 * max(0.0, min(1.0, float(denoise))))
        chosen = [999 - 100 * i for i in range(10)][start:start + n]
        table = smp._vp_sigmas()  # ascending, index = timestep
        return (_terminal_zero(np.asarray([table[i] for i in chosen], np.float32)),)


@register_node
class SplitSigmas:
    """A schedule cut at a step: high = sigmas[:step + 1], low =
    sigmas[step:]; the shared point lets a second stage resume exactly
    where the first stopped."""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"sigmas": ("SIGMAS",), "step": ("INT", {"default": 0})}}

    RETURN_TYPES = ("SIGMAS", "SIGMAS")
    RETURN_NAMES = ("high_sigmas", "low_sigmas")
    FUNCTION = "split"

    def split(self, sigmas, step=0, context=None):
        s = int(step)
        return (sigmas[:s + 1], sigmas[s:])


@register_node
class SplitSigmasDenoise:
    """A schedule cut so the low part keeps the last round(steps *
    denoise) steps (rounded half up)."""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"sigmas": ("SIGMAS",), "denoise": ("FLOAT", {"default": 1.0})}}

    RETURN_TYPES = ("SIGMAS", "SIGMAS")
    RETURN_NAMES = ("high_sigmas", "low_sigmas")
    FUNCTION = "split"

    def split(self, sigmas, denoise=1.0, context=None):
        steps = max(int(sigmas.shape[0]) - 1, 0)
        kept = int(steps * max(0.0, min(1.0, float(denoise))) + 0.5)
        s = steps - kept
        return (sigmas[:s + 1], sigmas[s:])


@register_node
class FlipSigmas:
    """A schedule reversed (unsampling); a leading 0 becomes 1e-4."""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"sigmas": ("SIGMAS",)}}

    RETURN_TYPES = ("SIGMAS",)
    FUNCTION = "flip"

    def flip(self, sigmas, context=None):
        if int(sigmas.shape[0]) == 0:
            return (sigmas,)
        flipped = torch.flip(sigmas, dims=(0,)).clone()
        flipped[0] = torch.clamp(flipped[0], min=1e-4)
        return (flipped,)


@register_node
class RandomNoise:
    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"noise_seed": ("INT", {"default": 0})}}

    RETURN_TYPES = ("NOISE",)
    FUNCTION = "get_noise"

    def get_noise(self, noise_seed, context=None):
        return (NoiseSpec(seed=resolve_seed(noise_seed), add_noise=True),)


@register_node
class DisableNoise:
    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {}}

    RETURN_TYPES = ("NOISE",)
    FUNCTION = "get_noise"

    def get_noise(self, context=None):
        return (NoiseSpec(seed=SeedSpec(0), add_noise=False),)


@register_node
class BasicGuider:
    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"model": ("MODEL",), "conditioning": ("CONDITIONING",)}}

    RETURN_TYPES = ("GUIDER",)
    FUNCTION = "get_guider"

    def get_guider(self, model, conditioning, context=None):
        return (GuiderSpec(bundle=model, positive=conditioning),)


@register_node
class CFGGuider:
    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "model": ("MODEL",),
                "positive": ("CONDITIONING",),
                "negative": ("CONDITIONING",),
                "cfg": ("FLOAT", {"default": 8.0}),
            }
        }

    RETURN_TYPES = ("GUIDER",)
    FUNCTION = "get_guider"

    def get_guider(self, model, positive, negative, cfg=8.0, context=None):
        return (GuiderSpec(bundle=model, positive=positive, negative=negative, cfg=float(cfg)),)


@register_node
class DualCFGGuider:
    """Dual-conditioning CFG: one 3B-batched evaluation a step over cond1,
    cond2 and the negative. "regular" guides cond2 against the negative
    at cfg_cond2_negative and adds cfg_conds * (eps1 - eps2); "nested"
    guides cond1 against cond2 first (ops/samplers.py::dual_cfg_model).
    The composition rides on a new bundle, as the other guidance patches
    do."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "model": ("MODEL",),
                "cond1": ("CONDITIONING",),
                "cond2": ("CONDITIONING",),
                "negative": ("CONDITIONING",),
                "cfg_conds": ("FLOAT", {"default": 8.0}),
                "cfg_cond2_negative": ("FLOAT", {"default": 8.0}),
                "style": ("STRING", {"default": "regular"}),
            }
        }

    RETURN_TYPES = ("GUIDER",)
    FUNCTION = "get_guider"

    def get_guider(self, model, cond1, cond2, negative, cfg_conds=8.0, cfg_cond2_negative=8.0,
                   style="regular", context=None):
        if str(style) not in ("regular", "nested"):
            raise ValueError(f"unknown style {style!r}; use 'regular' or 'nested'")
        pl.reject_existing_guidance_patches(model, "DualCFGGuider")
        bundle = dataclasses.replace(model, dual_cfg=pl.DualCFGSpec(
            cfg_cond2_negative=float(cfg_cond2_negative), nested=str(style) == "nested"))
        return (GuiderSpec(bundle=bundle, positive=(cond1, cond2), negative=negative,
                           cfg=float(cfg_conds)),)


@register_node
class PerpNegGuider:
    """Perpendicular negative guidance: only the part of the negative
    orthogonal to the positive pushes away. One 3B-batched evaluation a
    step over positive, negative and the empty conditioning
    (ops/samplers.py::perp_neg_model)."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "model": ("MODEL",),
                "positive": ("CONDITIONING",),
                "negative": ("CONDITIONING",),
                "empty_conditioning": ("CONDITIONING",),
                "cfg": ("FLOAT", {"default": 8.0}),
                "neg_scale": ("FLOAT", {"default": 1.0}),
            }
        }

    RETURN_TYPES = ("GUIDER",)
    FUNCTION = "get_guider"

    def get_guider(self, model, positive, negative, empty_conditioning, cfg=8.0, neg_scale=1.0,
                   context=None):
        pl.reject_existing_guidance_patches(model, "PerpNegGuider")
        bundle = dataclasses.replace(model, perp_neg=pl.PerpNegSpec(neg_scale=float(neg_scale)))
        return (GuiderSpec(bundle=bundle, positive=(positive, negative),
                           negative=empty_conditioning, cfg=float(cfg)),)


def _run_custom(noise: NoiseSpec, guider: GuiderSpec, sampler: SamplerSpec, sigmas,
                latent_image: dict, context) -> tuple[dict, dict]:
    """SamplerCustom's and SamplerCustomAdvanced's core →
    (output, denoised_output), through pipeline.sample_custom_sigmas. An
    empty grid returns the latents. A per-participant seed that adds
    noise (the mesh fan-out) raises."""
    bundle = guider.bundle
    latents, noise_mask, extras = _prep_latents(bundle, latent_image)
    if int(sigmas.shape[0]) == 0:
        out = {**extras, "samples": latents}
        return out, dict(out)
    spec = noise.seed
    if noise.add_noise and spec.per_participant:
        raise NotImplementedError(_MESH_UNPORTED)
    negative = guider.negative if guider.negative is not None else guider.positive
    cfg = guider.cfg if guider.negative is not None else 1.0
    out, denoised = pl.sample_custom_sigmas(
        bundle, latents, guider.positive, negative, sigmas, sampler=sampler.name,
        cfg_scale=cfg, seed=spec.effective_seed(), add_noise=noise.add_noise,
        noise_mask=noise_mask,
        batch_fixed_noise=bool(latent_image.get("batch_index_fixed", False)),
    )
    return {**extras, "samples": out}, {**extras, "samples": denoised}


@register_node
class SamplerCustom:
    """KSampler's knobs, with the sampler and the sigma grid as values;
    outputs (output, denoised_output), which differ only where the grid
    stops above sigma 0."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "model": ("MODEL",),
                "add_noise": ("BOOLEAN", {"default": True}),
                "noise_seed": ("INT", {"default": 0}),
                "cfg": ("FLOAT", {"default": 8.0}),
                "positive": ("CONDITIONING",),
                "negative": ("CONDITIONING",),
                "sampler": ("SAMPLER",),
                "sigmas": ("SIGMAS",),
                "latent_image": ("LATENT",),
            }
        }

    RETURN_TYPES = ("LATENT", "LATENT")
    RETURN_NAMES = ("output", "denoised_output")
    FUNCTION = "sample"

    def sample(self, model, add_noise, noise_seed, cfg, positive, negative, sampler, sigmas,
               latent_image, context=None):
        noise = NoiseSpec(seed=resolve_seed(noise_seed), add_noise=bool(add_noise))
        guider = GuiderSpec(bundle=model, positive=positive, negative=negative, cfg=float(cfg))
        return _run_custom(noise, guider, sampler, sigmas, latent_image, context)


@register_node
class SamplerCustomAdvanced:
    """NOISE, GUIDER, SAMPLER and SIGMAS in, (output, denoised_output)
    out."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "noise": ("NOISE",),
                "guider": ("GUIDER",),
                "sampler": ("SAMPLER",),
                "sigmas": ("SIGMAS",),
                "latent_image": ("LATENT",),
            }
        }

    RETURN_TYPES = ("LATENT", "LATENT")
    RETURN_NAMES = ("output", "denoised_output")
    FUNCTION = "sample"

    def sample(self, noise, guider, sampler, sigmas, latent_image, context=None):
        return _run_custom(noise, guider, sampler, sigmas, latent_image, context)
