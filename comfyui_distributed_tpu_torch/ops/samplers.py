"""Noise schedules, classifier-free guidance and the samplers.

Counterpart of comfyui_distributed_tpu/ops/samplers.py. The schedules
are the same numpy code, so sigmas agree with the JAX package to the
last bit. The step loop, a lax.scan there, is a Python loop here:
PyTorch runs eagerly.

Model contract: `model_fn(x, sigma_batch, cond) -> eps` (VP noise
prediction); `denoised(x, sigma) = x - sigma * eps`.

Every sampler and scheduler of the JAX package runs on the VP families:
eps- and v-prediction share the sigma table and the noising rule (the
model function converts v to eps). Rectified-flow models are not ported
(`require_vp`). Guidance: plain CFG and perturbed-attention guidance
(PAG); inpainting pins the unmasked region (`masked_inpaint_model`).

Scalars: each trajectory keeps its sigmas as f32 tensors on the host.
The per-step scalar arithmetic (logs, clamps, ancestral splits) runs
there in f32, as the JAX package's does on its f32 scalars, branches on
host values (no device synchronisation), and the host 0-d tensors scale
the latents on whatever device they live.

Step noise: the stochastic samplers draw it from a `StepNoise` callable,
`noise(step, slot, like)` → standard normals of `like`'s shape, called
once per draw in trajectory order; `slot` numbers the draws of one step
(two for dpmpp_sde). `generator_step_noise` draws in turn from a
`torch.Generator`; parity tests replay the JAX package's key splits
instead. Global RNG state is never read.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import numpy as np
import torch

from .conditioning import Conditioning

ModelFn = Callable[[torch.Tensor, torch.Tensor, Any], torch.Tensor]
StepNoise = Callable[[int, int, torch.Tensor], torch.Tensor]

SAMPLER_NAMES = (
    "euler", "euler_ancestral", "heun", "dpm_2", "dpm_2_ancestral", "lms",
    "dpmpp_2s_ancestral", "dpmpp_sde", "dpmpp_2m", "dpmpp_2m_sde", "ddim",
    "lcm",
)
SCHEDULER_NAMES = (
    "karras", "normal", "simple", "exponential", "sgm_uniform",
    "ddim_uniform", "beta", "kl_optimal",
)


def check_sampler_names(sampler: str, scheduler: str) -> None:
    """ValueError listing the valid names for an unknown sampler or
    scheduler (the KSampler and upscale nodes' input check)."""
    if sampler not in SAMPLER_NAMES:
        raise ValueError(f"unknown sampler {sampler!r}; use {SAMPLER_NAMES}")
    if scheduler not in SCHEDULER_NAMES:
        raise ValueError(f"unknown scheduler {scheduler!r}; use {SCHEDULER_NAMES}")


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


def exponential_sigmas(sigma_min: float, sigma_max: float, steps: int):
    """Descending log-uniform grid (no terminal zero)."""
    return np.exp(np.linspace(np.log(sigma_max), np.log(sigma_min), steps))


def polyexponential_sigmas(sigma_min: float, sigma_max: float, steps: int, rho: float = 1.0):
    """Descending poly-exponential grid: a log-space ramp warped by rho
    (rho=1 is exponential_sigmas; rho>1 spends more steps near
    sigma_min)."""
    ramp = np.linspace(1.0, 0.0, steps) ** rho
    return np.exp(ramp * (np.log(sigma_max) - np.log(sigma_min)) + np.log(sigma_min))


def _spaced_from_table(all_sigmas: np.ndarray, scheduler: str, total_steps: int):
    """Descending [total_steps] sigma spacing over an ascending table."""
    sigma_max = float(all_sigmas[-1])
    sigma_min = float(all_sigmas[0])

    if scheduler == "karras":
        sigmas = karras_sigmas(sigma_min, sigma_max, total_steps)
    elif scheduler == "exponential":
        sigmas = exponential_sigmas(sigma_min, sigma_max, total_steps)
    elif scheduler in ("normal", "simple"):
        idx = np.linspace(len(all_sigmas) - 1, 0, total_steps)
        sigmas = all_sigmas[idx.astype(np.int64)]
    elif scheduler == "sgm_uniform":
        # uniform timestep spacing, the smallest timestep left out before
        # the terminal zero (the SGM convention)
        idx = np.linspace(len(all_sigmas) - 1, 0, total_steps + 1)[:-1]
        sigmas = all_sigmas[idx.astype(np.int64)]
    elif scheduler == "ddim_uniform":
        # a uniform timestep stride from the top of the table (the DDIM
        # convention): always starts at sigma_max
        n = len(all_sigmas)
        ss = n / max(total_steps, 1)
        idx = np.asarray([n - 1 - int(i * ss) for i in range(total_steps)], dtype=np.int64)
        sigmas = all_sigmas[np.clip(idx, 0, n - 1)]
    elif scheduler == "beta":
        sigmas = beta_spaced_sigmas(all_sigmas, total_steps)
    elif scheduler == "kl_optimal":
        # arctan-interpolated spacing (the "Align Your Steps" KL-optimal
        # closed form)
        r = np.linspace(0.0, 1.0, total_steps)
        sigmas = np.tan(r * np.arctan(sigma_min) + (1.0 - r) * np.arctan(sigma_max))
    else:
        raise ValueError(f"unknown scheduler {scheduler!r}; use {SCHEDULER_NAMES}")
    return sigmas


def beta_spaced_sigmas(all_sigmas: np.ndarray, total_steps: int, alpha: float = 0.6,
                       beta: float = 0.6):
    """Timesteps at Beta(alpha, beta) quantiles over an ascending table:
    dense at both ends of the schedule at the 0.6/0.6 default."""
    n = len(all_sigmas)
    ts = 1.0 - np.linspace(0.0, 1.0, total_steps, endpoint=False)
    idx = np.rint(_beta_ppf(ts, float(alpha), float(beta)) * (n - 1)).astype(np.int64)
    # strictly decreasing indices (rounded quantiles can collide; equal
    # neighbours would break the multistep solvers); a bottom-up pass
    # lifts the ones a downward nudge pushed below 0
    for i in range(1, len(idx)):
        if idx[i] >= idx[i - 1]:
            idx[i] = idx[i - 1] - 1
    floor = 0
    for i in range(len(idx) - 1, -1, -1):
        if idx[i] < floor:
            idx[i] = floor
        floor = idx[i] + 1
    return all_sigmas[np.clip(idx, 0, n - 1)]


def _betainc_np(a: float, b: float, x):
    """Regularized incomplete beta I_x(a, b) in float64 (Lentz continued
    fraction, Numerical Recipes 6.4)."""

    def betacf(aa: float, bb: float, xx: float) -> float:
        tiny, eps = 1e-30, 3e-16
        qab, qap, qam = aa + bb, aa + 1.0, aa - 1.0
        c = 1.0
        d = 1.0 - qab * xx / qap
        if abs(d) < tiny:
            d = tiny
        d = 1.0 / d
        h = d
        for m in range(1, 200):
            m2 = 2 * m
            num = m * (bb - m) * xx / ((qam + m2) * (aa + m2))
            d = 1.0 + num * d
            if abs(d) < tiny:
                d = tiny
            c = 1.0 + num / c
            if abs(c) < tiny:
                c = tiny
            d = 1.0 / d
            h *= d * c
            num = -(aa + m) * (qab + m) * xx / ((aa + m2) * (qap + m2))
            d = 1.0 + num * d
            if abs(d) < tiny:
                d = tiny
            c = 1.0 + num / c
            if abs(c) < tiny:
                c = tiny
            d = 1.0 / d
            delta = d * c
            h *= delta
            if abs(delta - 1.0) < eps:
                break
        return h

    ln_beta = math.lgamma(a) + math.lgamma(b) - math.lgamma(a + b)

    def one(xx: float) -> float:
        if xx <= 0.0:
            return 0.0
        if xx >= 1.0:
            return 1.0
        front = math.exp(a * math.log(xx) + b * math.log1p(-xx) - ln_beta)
        if xx < (a + 1.0) / (a + b + 2.0):
            return front * betacf(a, b, xx) / a
        return 1.0 - front * betacf(b, a, 1.0 - xx) / b

    return np.vectorize(one, otypes=[np.float64])(np.asarray(x, np.float64))


def _beta_ppf(q, a: float, b: float, iters: int = 60):
    """Beta(a, b) quantiles by bisection on `_betainc_np` (no scipy)."""
    q = np.asarray(q, np.float64)
    lo = np.zeros_like(q)
    hi = np.ones_like(q)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        cdf = _betainc_np(a, b, mid)
        lo = np.where(cdf < q, mid, lo)
        hi = np.where(cdf < q, hi, mid)
    return 0.5 * (lo + hi)


def get_sigmas(scheduler: str, steps: int, denoise: float = 1.0) -> torch.Tensor:
    """[steps+1] descending f32 sigmas ending at 0, on the host;
    `denoise < 1` keeps the tail of a longer schedule (img2img / tile
    re-diffusion)."""
    total_steps = steps
    if denoise < 1.0:
        total_steps = max(int(steps / max(denoise, 1e-4)), steps)
    sigmas = _spaced_from_table(_vp_sigmas(), scheduler, total_steps)
    sigmas = sigmas[-steps:] if denoise < 1.0 else sigmas
    return torch.from_numpy(np.concatenate([sigmas, np.zeros((1,))]).astype(np.float32))


# the parameterizations of the VP families: one sigma table, one noising
# rule; the model function turns a v prediction into eps
VP_PARAMETERIZATIONS = ("eps", "v")


def require_vp(parameterization: str) -> None:
    if parameterization not in VP_PARAMETERIZATIONS:
        raise NotImplementedError(
            f"{parameterization!r} models are not ported yet (ROADMAP.md, Queue 1 item 5: "
            "other model families); the PyTorch package runs eps- and v-prediction UNets"
        )


def get_model_sigmas(parameterization: str, scheduler: str, steps: int,
                     denoise: float = 1.0) -> torch.Tensor:
    """Family-aware schedule: the VP table for eps and v models."""
    require_vp(parameterization)
    return get_sigmas(scheduler, steps, denoise=denoise)


def noise_latents(parameterization: str, latents: torch.Tensor, noise: torch.Tensor,
                  sigma0: torch.Tensor) -> torch.Tensor:
    """img2img/tile noising to the schedule start (VP: z + sigma * n)."""
    require_vp(parameterization)
    return latents + noise * sigma0


def masked_inpaint_model(model_fn: ModelFn, parameterization: str, latents: torch.Tensor,
                         noise: torch.Tensor, mask: torch.Tensor) -> ModelFn:
    """Inpainting: before every evaluation the unmasked region (mask 0)
    is pinned to the original `latents` re-noised to the current sigma
    with the trajectory's own `noise`, so only the masked region (mask 1
    = regenerate, ComfyUI's noise_mask polarity) evolves. Callers
    composite `out * mask + latents * (1 - mask)` after sampling."""

    def wrapped(x, sigma_batch, cond):
        sig = sigma_batch.reshape((-1,) + (1,) * (x.ndim - 1))
        ref = noise_latents(parameterization, latents, noise, sig)
        return model_fn(x * mask + ref * (1.0 - mask), sigma_batch, cond)

    return wrapped


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


def _cfg_eval(model_fn: ModelFn, cfg_scale: float, x, sigma, cond):
    """One CFG evaluation → (eps_pos, guided eps). The two passes run as
    one 2B-batched model call where they can."""
    pos, neg = cond
    if cfg_scale == 1.0:
        eps_pos = model_fn(x, sigma, pos)
        return eps_pos, eps_pos
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
    return eps_pos, eps_neg + cfg_scale * (eps_pos - eps_neg)


def cfg_model(model_fn: ModelFn, cfg_scale: float) -> ModelFn:
    """Classifier-free guidance; cond is the (positive, negative) pair."""

    def guided(x, sigma, cond):
        return _cfg_eval(model_fn, cfg_scale, x, sigma, cond)[1]

    return guided


def _perturbed_delta(pert_model_fn: ModelFn, x, sigma, pos, eps_pos, scale: float):
    """scale * (eps_pos - eps_perturbed): one perturbed evaluation
    against the positive conditioning."""
    return scale * (eps_pos - pert_model_fn(x, sigma, pos))


def pag_cfg_model(model_fn: ModelFn, pag_model_fn: ModelFn, cfg_scale: float,
                  pag_scale: float) -> ModelFn:
    """CFG plus perturbed-attention guidance (PAG, Ahn et al. 2024): the
    result gains pag_scale * (cond - cond with the middle block's
    self-attention as identity), `pag_model_fn` being that perturbed
    model. One extra positive-cond evaluation a step, at batch B."""

    def guided(x, sigma, cond):
        pos, _neg = cond
        eps_pos, base = _cfg_eval(model_fn, cfg_scale, x, sigma, cond)
        return base + _perturbed_delta(pag_model_fn, x, sigma, pos, eps_pos, pag_scale)

    return guided


# --- samplers ------------------------------------------------------------

def generator_step_noise(generator: torch.Generator) -> StepNoise:
    """Step noise drawn in turn from `generator` (on the latents' device)."""

    def draw(step: int, slot: int, like: torch.Tensor) -> torch.Tensor:
        return torch.randn(like.shape, generator=generator, device=like.device,
                           dtype=torch.float32).to(like.dtype)

    return draw


def stream_seed(seed: int, *indices: int) -> int:
    """A generator seed for one noise stream of `seed`: the indices
    (global tile index, stream number, ...) folded in base 1_000_003,
    mod 2^63."""
    out = int(seed)
    for index in indices:
        out = (out * 1_000_003 + int(index)) % (2**63)
    return out


def _floor(t: torch.Tensor) -> torch.Tensor:
    """max(t, 1e-10), the JAX package's guard of every log and division."""
    return torch.clamp(t, min=1e-10)


def _denoised(model_fn: ModelFn, x: torch.Tensor, sigma: torch.Tensor, cond) -> torch.Tensor:
    """x0 prediction from the eps model at a host scalar sigma."""
    sig_batch = torch.full((x.shape[0],), float(sigma), device=x.device, dtype=torch.float32)
    eps = model_fn(x, sig_batch, cond)
    return x - sigma * eps


def _ancestral_split(sigma: torch.Tensor, sigma_next: torch.Tensor, eta: float = 1.0):
    """(sigma_down, sigma_up) of an ancestral step (k-diffusion's
    get_ancestral_step)."""
    sigma_up = torch.minimum(
        sigma_next,
        eta * torch.sqrt(torch.clamp(
            sigma_next**2 * (sigma**2 - sigma_next**2) / _floor(sigma**2), min=0.0)),
    )
    sigma_down = torch.sqrt(torch.clamp(sigma_next**2 - sigma_up**2, min=0.0))
    return sigma_down, sigma_up


def _pairs(sigmas: torch.Tensor):
    return ((i, sigmas[i], sigmas[i + 1]) for i in range(sigmas.shape[0] - 1))


def _sample_euler(model_fn, x, sigmas, cond):
    for _, sigma, sigma_next in _pairs(sigmas):
        den = _denoised(model_fn, x, sigma, cond)
        d = (x - den) / _floor(sigma)
        x = x + d * (sigma_next - sigma)
    return x


def _sample_heun(model_fn, x, sigmas, cond):
    for _, sigma, sigma_next in _pairs(sigmas):
        den = _denoised(model_fn, x, sigma, cond)
        d = (x - den) / _floor(sigma)
        x_euler = x + d * (sigma_next - sigma)
        if sigma_next > 0:
            den2 = _denoised(model_fn, x_euler, sigma_next, cond)
            d2 = (x_euler - den2) / _floor(sigma_next)
            x = x + 0.5 * (d + d2) * (sigma_next - sigma)
        else:
            x = x_euler
    return x


def _midpoint_step(model_fn, x, d, sigma, sigma_to, cond):
    """DPM-Solver-2's step from sigma to sigma_to through the model at
    their geometric mean."""
    sigma_mid = torch.exp(0.5 * (torch.log(_floor(sigma)) + torch.log(_floor(sigma_to))))
    x_2 = x + d * (sigma_mid - sigma)
    den_2 = _denoised(model_fn, x_2, _floor(sigma_mid), cond)
    d_2 = (x_2 - den_2) / _floor(sigma_mid)
    return x + d_2 * (sigma_to - sigma)


def _sample_dpm_2(model_fn, x, sigmas, cond):
    """DPM-Solver-2; the final step (sigma_next == 0) is Euler."""
    for _, sigma, sigma_next in _pairs(sigmas):
        den = _denoised(model_fn, x, sigma, cond)
        d = (x - den) / _floor(sigma)
        if sigma_next > 0:
            x = _midpoint_step(model_fn, x, d, sigma, sigma_next, cond)
        else:
            x = x + d * (sigma_next - sigma)
    return x


def _sample_dpm_2_ancestral(model_fn, x, sigmas, cond, noise):
    for i, sigma, sigma_next in _pairs(sigmas):
        sigma_down, sigma_up = _ancestral_split(sigma, sigma_next)
        den = _denoised(model_fn, x, sigma, cond)
        d = (x - den) / _floor(sigma)
        if sigma_down > 0:
            x = _midpoint_step(model_fn, x, d, sigma, sigma_down, cond)
        else:
            x = x + d * (sigma_down - sigma)
        if sigma_up > 0:
            x = x + noise(i, 0, x) * sigma_up
    return x


def _lms_coefficients(sigmas_np: np.ndarray, order: int = 4) -> np.ndarray:
    """[steps, order] exact integrals of the Lagrange basis over each
    [sigma_i, sigma_{i+1}] (k-diffusion's linear_multistep_coeff); column
    j weights the derivative from j steps ago, zero beyond the history."""
    steps = len(sigmas_np) - 1
    coeffs = np.zeros((steps, order), dtype=np.float64)
    for i in range(steps):
        cur_order = min(i + 1, order)
        for j in range(cur_order):
            nodes = [sigmas_np[i - k] for k in range(cur_order)]
            poly = np.poly1d([1.0])
            for k in range(cur_order):
                if k == j:
                    continue
                poly *= np.poly1d([1.0, -nodes[k]]) / (nodes[j] - nodes[k])
            integral = poly.integ()
            coeffs[i, j] = integral(sigmas_np[i + 1]) - integral(sigmas_np[i])
    return coeffs


def _sample_lms(model_fn, x, sigmas, cond, order: int = 4):
    """Linear multistep (order 4) with exact per-step coefficients."""
    coeffs = torch.from_numpy(
        _lms_coefficients(sigmas.numpy().astype(np.float64), order).astype(np.float32))
    history: list[torch.Tensor] = []  # newest first
    for i, sigma, _ in _pairs(sigmas):
        den = _denoised(model_fn, x, sigma, cond)
        history = [(x - den) / _floor(sigma)] + history[:order - 1]
        x = x + sum(coeffs[i, j] * d for j, d in enumerate(history))
    return x


def _sample_dpmpp_2s_ancestral(model_fn, x, sigmas, cond, noise):
    """DPM-Solver++(2S) ancestral, in lambda = -log sigma."""
    for i, sigma, sigma_next in _pairs(sigmas):
        sigma_down, sigma_up = _ancestral_split(sigma, sigma_next)
        den = _denoised(model_fn, x, sigma, cond)
        if sigma_down > 0:
            t = -torch.log(_floor(sigma))
            h = -torch.log(_floor(sigma_down)) - t
            sig_mid = torch.exp(-(t + 0.5 * h))
            x_2 = (sig_mid / _floor(sigma)) * x - torch.expm1(-0.5 * h) * den
            den_2 = _denoised(model_fn, x_2, _floor(sig_mid), cond)
            x = (_floor(sigma_down) / _floor(sigma)) * x - torch.expm1(-h) * den_2
        else:
            d = (x - den) / _floor(sigma)
            x = x + d * (sigma_down - sigma)
        if sigma_up > 0:
            x = x + noise(i, 0, x) * sigma_up
    return x


def _sample_dpmpp_sde(model_fn, x, sigmas, cond, noise, eta: float = 1.0):
    """DPM-Solver++ SDE (r = 1/2): two model evaluations and two noise
    draws a step; the terminal step is Euler."""
    r = 0.5
    for i, sigma, sigma_next in _pairs(sigmas):
        den = _denoised(model_fn, x, sigma, cond)
        if sigma_next > 0:
            t = -torch.log(_floor(sigma))
            h = -torch.log(_floor(sigma_next)) - t
            sig_mid = torch.exp(-(t + h * r))
            # sub-step 1 to sigma(s_mid), with its own ancestral split
            sd_1, su_1 = _ancestral_split(sigma, sig_mid, eta)
            t_d1 = -torch.log(_floor(sd_1))
            x_2 = (_floor(sd_1) / _floor(sigma)) * x - torch.expm1(t - t_d1) * den
            x_2 = x_2 + noise(i, 0, x) * su_1
            den_2 = _denoised(model_fn, x_2, _floor(sig_mid), cond)
            # sub-step 2 to sigma_next
            sd_2, su_2 = _ancestral_split(sigma, sigma_next, eta)
            t_d2 = -torch.log(_floor(sd_2))
            fac = 1.0 / (2.0 * r)
            den_mix = (1.0 - fac) * den + fac * den_2
            x_solver = (_floor(sd_2) / _floor(sigma)) * x - torch.expm1(t - t_d2) * den_mix
            x = x_solver + noise(i, 1, x) * su_2
        else:
            d = (x - den) / _floor(sigma)
            x = x + d * (sigma_next - sigma)
    return x


def _sample_dpmpp_2m_sde(model_fn, x, sigmas, cond, noise, eta: float = 1.0):
    """DPM-Solver++(2M) SDE, midpoint variant: one model evaluation a
    step, corrected from the previous step's denoised from the second."""
    old_den, h_last = None, None
    for i, sigma, sigma_next in _pairs(sigmas):
        den = _denoised(model_fn, x, sigma, cond)
        t = -torch.log(_floor(sigma))
        h = -torch.log(_floor(sigma_next)) - t
        eta_h = eta * h
        if sigma_next > 0:
            x_solver = ((_floor(sigma_next) / _floor(sigma)) * torch.exp(-eta_h) * x
                        - torch.expm1(-h - eta_h) * den)
            if h_last is not None and h_last > 0:
                r = h_last / _floor(h)
                x_solver = x_solver + (-0.5 * torch.expm1(-h - eta_h) * (1.0 / _floor(r))
                                       * (den - old_den))
            x = x_solver + noise(i, 0, x) * torch.clamp(sigma_next, min=0.0) * torch.sqrt(
                torch.clamp(-torch.expm1(-2.0 * eta_h), min=0.0))
        else:
            x = den
        old_den, h_last = den, h
    return x


def _sample_lcm(model_fn, x, sigmas, cond, noise):
    """LCM: jump to the denoised estimate, re-noise to the next sigma."""
    for i, sigma, sigma_next in _pairs(sigmas):
        den = _denoised(model_fn, x, sigma, cond)
        x = den + sigma_next * noise(i, 0, x) if sigma_next > 0 else den
    return x


def _sample_ddim(model_fn, x, sigmas, cond):
    """Deterministic (eta = 0) DDIM in its own form, x0 + sigma_next * eps:
    in the sigma-space eps parameterisation the same step as Euler."""
    for _, sigma, sigma_next in _pairs(sigmas):
        den = _denoised(model_fn, x, sigma, cond)
        eps = (x - den) / _floor(sigma)
        x = den + sigma_next * eps
    return x


def _sample_euler_ancestral(model_fn, x, sigmas, cond, noise):
    for i, sigma, sigma_next in _pairs(sigmas):
        den = _denoised(model_fn, x, sigma, cond)
        sigma_down, sigma_up = _ancestral_split(sigma, sigma_next)
        d = (x - den) / _floor(sigma)
        x = x + d * (sigma_down - sigma)
        if sigma_up > 0:
            x = x + noise(i, 0, x) * sigma_up
    return x


def _sample_dpmpp_2m(model_fn, x, sigmas, cond):
    """DPM-Solver++(2M): second-order multistep in log-sigma time; the
    step to sigma = 0 returns the denoised sample."""
    old_den = None
    for i, sigma, sigma_next in _pairs(sigmas):
        den = _denoised(model_fn, x, sigma, cond)
        if sigma_next > 0:
            t = -torch.log(_floor(sigma))
            h = -torch.log(_floor(sigma_next)) - t
            den_d = den
            if old_den is not None:
                # the clamps guard equal neighbouring sigmas
                h_last = t - -torch.log(_floor(sigmas[i - 1]))
                r = _floor(h_last) / _floor(h)
                den_d = (1 + 1 / (2 * r)) * den - (1 / (2 * r)) * old_den
            x = (sigma_next / sigma) * x - torch.expm1(-h) * den_d
        else:
            x = den
        old_den = den
    return x


_DETERMINISTIC = {
    "euler": _sample_euler,
    "heun": _sample_heun,
    "dpm_2": _sample_dpm_2,
    "lms": _sample_lms,
    "dpmpp_2m": _sample_dpmpp_2m,
    "ddim": _sample_ddim,
}
_STOCHASTIC = {
    "euler_ancestral": _sample_euler_ancestral,
    "dpm_2_ancestral": _sample_dpm_2_ancestral,
    "dpmpp_2s_ancestral": _sample_dpmpp_2s_ancestral,
    "dpmpp_sde": _sample_dpmpp_sde,
    "dpmpp_2m_sde": _sample_dpmpp_2m_sde,
    "lcm": _sample_lcm,
}

STOCHASTIC_SAMPLERS = tuple(_STOCHASTIC)

# samplers whose step makes a second model evaluation on every sigma pair
# but the last (sigma_next == 0)
_SECOND_ORDER = {"heun", "dpm_2", "dpm_2_ancestral", "dpmpp_2s_ancestral", "dpmpp_sde"}


def model_evals_per_scan(sampler: str, n_pairs: int) -> int:
    """The (CFG-batched) model evaluations `sample` makes over n_pairs
    sigma pairs."""
    return 2 * n_pairs - 1 if sampler in _SECOND_ORDER else n_pairs


def sample(model_fn: ModelFn, x_init: torch.Tensor, sigmas: torch.Tensor, cond: Any,
           sampler: str = "euler",
           noise: StepNoise | None = None) -> torch.Tensor:
    """Run a sampling trajectory from x_init (already at sigmas[0]).
    `noise` is the stochastic samplers' step noise; they raise without
    it. Pass `sigmas` on the host: a device copy costs a synchronisation
    here."""
    sigmas = sigmas.detach().to("cpu", torch.float32)
    if sampler in _DETERMINISTIC:
        return _DETERMINISTIC[sampler](model_fn, x_init, sigmas, cond)
    if sampler in _STOCHASTIC:
        if noise is None:
            raise ValueError(f"{sampler} requires step noise")
        return _STOCHASTIC[sampler](model_fn, x_init, sigmas, cond, noise)
    raise ValueError(f"unknown sampler {sampler!r}; use {SAMPLER_NAMES}")
