"""Noise schedules, classifier-free guidance and the euler sampler.

Counterpart of comfyui_distributed_tpu/ops/samplers.py. The schedules
are the same numpy code, so sigmas agree with the JAX package to the
last bit. The step loop, a lax.scan there, is a Python loop here:
PyTorch runs eagerly.

Model contract: `model_fn(x, sigma_batch, cond) -> eps` (VP noise
prediction); `denoised(x, sigma) = x - sigma * eps`.

Only `euler` and the `karras` schedule family the workflow uses are
ported; the other samplers are named and raise.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from .conditioning import Conditioning

ModelFn = Callable[[torch.Tensor, torch.Tensor, Any], torch.Tensor]

SAMPLER_NAMES = (
    "euler", "euler_ancestral", "heun", "dpm_2", "dpm_2_ancestral", "lms",
    "dpmpp_2s_ancestral", "dpmpp_sde", "dpmpp_2m", "dpmpp_2m_sde", "ddim",
    "lcm",
)


# --- schedules -----------------------------------------------------------

def _vp_sigmas(n_training: int = 1000) -> np.ndarray:
    """SD's scaled-linear beta schedule → per-timestep sigmas (float64)."""
    betas = np.linspace(0.00085**0.5, 0.012**0.5, n_training) ** 2
    alphas_cumprod = np.cumprod(1.0 - betas)
    return np.sqrt((1 - alphas_cumprod) / alphas_cumprod)


def karras_sigmas(sigma_min: float, sigma_max: float, steps: int, rho: float = 7.0):
    """Descending Karras rho-ramp grid (no terminal zero)."""
    ramp = np.linspace(0, 1, steps)
    min_r, max_r = sigma_min ** (1 / rho), sigma_max ** (1 / rho)
    return (max_r + ramp * (min_r - max_r)) ** rho


def _spaced_from_table(all_sigmas: np.ndarray, scheduler: str, total_steps: int):
    """Descending [total_steps] sigma spacing over an ascending table."""
    if scheduler != "karras":
        raise NotImplementedError(
            f"scheduler {scheduler!r} is not ported to the PyTorch package yet "
            "(ROADMAP.md, Queue 1: the rest of the sampler, guidance and node "
            "catalogue); use 'karras'"
        )
    return karras_sigmas(float(all_sigmas[0]), float(all_sigmas[-1]), total_steps)


def get_sigmas(scheduler: str, steps: int, denoise: float = 1.0) -> torch.Tensor:
    """[steps+1] descending f32 sigmas ending at 0; `denoise < 1` keeps
    the tail of a longer schedule (img2img / tile re-diffusion)."""
    total_steps = steps
    if denoise < 1.0:
        total_steps = max(int(steps / max(denoise, 1e-4)), steps)
    sigmas = _spaced_from_table(_vp_sigmas(), scheduler, total_steps)
    sigmas = sigmas[-steps:] if denoise < 1.0 else sigmas
    return torch.from_numpy(np.concatenate([sigmas, np.zeros((1,))]).astype(np.float32))


def get_model_sigmas(parameterization: str, scheduler: str, steps: int,
                     denoise: float = 1.0) -> torch.Tensor:
    """Family-aware schedule; the VP (eps) family only in this slice."""
    if parameterization != "eps":
        raise NotImplementedError(
            f"{parameterization!r} models are not ported yet; the PyTorch "
            "package runs eps-prediction UNets"
        )
    return get_sigmas(scheduler, steps, denoise=denoise)


def noise_latents(parameterization: str, latents: torch.Tensor, noise: torch.Tensor,
                  sigma0: torch.Tensor) -> torch.Tensor:
    """img2img/tile noising to the schedule start (VP: z + sigma * n)."""
    if parameterization != "eps":
        raise NotImplementedError(f"{parameterization!r} noising is not ported yet")
    return latents + noise * sigma0


def sigma_to_timestep(sigma: torch.Tensor) -> torch.Tensor:
    """Nearest training timestep of each sigma, as f32."""
    log_all = torch.from_numpy(np.log(_vp_sigmas()).astype(np.float32)).to(sigma.device)
    dist = torch.abs(torch.log(torch.clamp(sigma, min=1e-10))[..., None] - log_all)
    return torch.argmin(dist, dim=-1).float()


# --- CFG -----------------------------------------------------------------

def _conds_batchable(pos: Conditioning, neg: Conditioning) -> bool:
    """Whether cond and uncond can ride one 2B-batched model pass: the
    same fields set, with the same shapes."""
    if (pos.pooled is None) != (neg.pooled is None):
        return False
    if pos.context.shape != neg.context.shape:
        return False
    return pos.pooled is None or pos.pooled.shape == neg.pooled.shape


def cfg_model(model_fn: ModelFn, cfg_scale: float) -> ModelFn:
    """Classifier-free guidance; cond is the (positive, negative) pair.
    The two passes run as one 2B-batched model call where they can."""

    def guided(x, sigma, cond):
        pos, neg = cond
        if cfg_scale == 1.0:
            return model_fn(x, sigma, pos)
        if _conds_batchable(pos, neg):
            both = Conditioning(
                context=torch.cat([pos.context, neg.context], dim=0),
                pooled=(None if pos.pooled is None
                        else torch.cat([pos.pooled, neg.pooled], dim=0)),
            )
            eps_pos, eps_neg = model_fn(
                torch.cat([x, x], dim=0), torch.cat([sigma, sigma], dim=0), both
            ).chunk(2, dim=0)
        else:
            eps_pos = model_fn(x, sigma, pos)
            eps_neg = model_fn(x, sigma, neg)
        return eps_neg + cfg_scale * (eps_pos - eps_neg)

    return guided


# --- samplers ------------------------------------------------------------

def _denoised(model_fn: ModelFn, x: torch.Tensor, sigma: torch.Tensor, cond) -> torch.Tensor:
    """x0 prediction from the eps model at a scalar sigma."""
    eps = model_fn(x, sigma.expand(x.shape[0]), cond)
    return x - sigma * eps


def _sample_euler(model_fn: ModelFn, x: torch.Tensor, sigmas: torch.Tensor, cond) -> torch.Tensor:
    for i in range(sigmas.shape[0] - 1):
        sigma, sigma_next = sigmas[i], sigmas[i + 1]
        den = _denoised(model_fn, x, sigma, cond)
        d = (x - den) / torch.clamp(sigma, min=1e-10)
        x = x + d * (sigma_next - sigma)
    return x


def sample(model_fn: ModelFn, x_init: torch.Tensor, sigmas: torch.Tensor, cond: Any,
           sampler: str = "euler") -> torch.Tensor:
    """Run a sampling trajectory from x_init (already at sigmas[0])."""
    if sampler == "euler":
        return _sample_euler(model_fn, x_init, sigmas.to(x_init.device), cond)
    if sampler in SAMPLER_NAMES:
        raise NotImplementedError(
            f"sampler {sampler!r} is not ported to the PyTorch package yet "
            "(ROADMAP.md, Queue 1: the rest of the sampler, guidance and node "
            "catalogue); use 'euler'"
        )
    raise ValueError(f"unknown sampler {sampler!r}; use {SAMPLER_NAMES}")
