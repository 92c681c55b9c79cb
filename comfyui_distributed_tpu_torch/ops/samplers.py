"""Noise schedules, classifier-free guidance and the samplers.

Counterpart of comfyui_distributed_tpu/ops/samplers.py. The schedules
are the same numpy code, so sigmas agree with the JAX package to the
last bit. The step loop, a lax.scan there, is a Python loop here:
PyTorch runs eagerly.

Model contract: `model_fn(x, sigma_batch, cond) -> eps` (VP noise
prediction); `denoised(x, sigma) = x - sigma * eps`.

The video DiT family samples on its own flow grid (`get_flow_timesteps`,
`sample_flow`, `cfg_flow_model`, `sample_flow_masked`): Euler steps of
the predicted velocity in flow time t from 1 (noise) to 0 (data), the
model called with t x 1000.

Every sampler and scheduler of the JAX package runs on the VP families:
eps- and v-prediction share the sigma table and the noising rule (the
model function converts v to eps). Rectified-flow models (Flux) take the
shifted flow table (`get_flow_sigmas`, every scheduler) and the
interpolation noising; their velocity is eps under the contract, so the
deterministic samplers apply unchanged, euler_ancestral takes the RF
renoising rule and the other stochastic samplers are refused (their VE
renoising leaves the flow marginal). Guidance: CFG with the per-entry
composition of multi-entry, area, mask and timestep-window conditioning
(`composite_eps`), perturbed-attention guidance (PAG), self-attention
guidance (SAG), RescaleCFG, perpendicular negative guidance (PerpNeg) and
dual-conditioning CFG (DualCFG); inpainting pins the unmasked region
(`masked_inpaint_model`).

Scalars: each trajectory keeps its sigmas as f32 tensors on the host.
The per-step scalar arithmetic (logs, clamps, ancestral splits) runs
there in f32, as the JAX package's does on its f32 scalars, branches on
host values (no device synchronisation), and the host 0-d tensors scale
the latents on whatever device they live. A model function gets its
sigma batch on the host too: the timestep windows of conditioning and
ControlNet hints are host comparisons (`in_window`), and `on_device`
copies the batch where the latents are.

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
import torch.nn.functional as F

from .conditioning import (
    LIST_FIELDS,
    STATIC_FIELDS,
    TENSOR_FIELDS,
    as_conditioning,
    concat_batch,
    reject_unported,
    resolve_area,
)
from .filters import gaussian_blur
from .resize import resize_image

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


# the parameterizations of the ported families: eps and v share the VP
# table and noising rule (the model function turns v into eps); flow is
# rectified flow (the Flux class)
PARAMETERIZATIONS = ("eps", "v", "flow")


def require_parameterization(parameterization: str) -> None:
    """NotImplementedError for a parameterization outside PARAMETERIZATIONS:
    every family the JAX package registers is one of them."""
    if parameterization not in PARAMETERIZATIONS:
        raise NotImplementedError(
            f"{parameterization!r} models are not supported: every model family is eps-, v- "
            "or flow-parameterized")


def _flow_sigma_table(shift: float, n_training: int = 1000) -> np.ndarray:
    """Ascending flow sigma table sigma(t) = s t / (1 + (s - 1) t) for t
    in {1/n, ..., 1} (float64), the flow analogue of `_vp_sigmas`."""
    t = np.arange(1, n_training + 1, dtype=np.float64) / n_training
    return shift * t / (1.0 + (shift - 1.0) * t)


def get_flow_sigmas(steps: int, denoise: float = 1.0, shift: float = 3.0,
                    scheduler: str = "simple") -> torch.Tensor:
    """[steps+1] descending f32 rectified-flow sigmas on the host, through
    the timestep shift t' = s t / (1 + (s - 1) t). sigma is the flow time:
    x_t = (1 - sigma) x0 + sigma n. "simple" and "normal" keep the exact
    uniform-t grid through the shift (the Flux default); every other
    scheduler spaces the shifted table as it spaces the VP one. `denoise
    < 1` keeps the tail of a longer schedule, as `get_sigmas` does."""
    total = steps
    if denoise < 1.0:
        total = max(int(steps / max(denoise, 1e-4)), steps)
    if scheduler in ("normal", "simple"):
        t = np.linspace(1.0, 0.0, total + 1)
        t = shift * t / (1.0 + (shift - 1.0) * t)
        return torch.from_numpy(t[-(steps + 1):].astype(np.float32))
    sigmas = _spaced_from_table(_flow_sigma_table(shift), scheduler, total)
    sigmas = sigmas[-steps:] if denoise < 1.0 else sigmas
    return torch.from_numpy(np.concatenate([sigmas, np.zeros((1,))]).astype(np.float32))


def get_model_sigmas(parameterization: str, scheduler: str, steps: int,
                     denoise: float = 1.0, flow_shift: float = 3.0) -> torch.Tensor:
    """Family-aware schedule: the shifted flow grid for flow models, the VP
    table for eps and v models; `scheduler` shapes the spacing of both."""
    require_parameterization(parameterization)
    if parameterization == "flow":
        return get_flow_sigmas(steps, denoise=denoise, shift=flow_shift, scheduler=scheduler)
    return get_sigmas(scheduler, steps, denoise=denoise)


def noise_latents(parameterization: str, latents: torch.Tensor, noise: torch.Tensor,
                  sigma0: torch.Tensor) -> torch.Tensor:
    """img2img/tile noising to the schedule start: VP families add scaled
    noise (z + sigma n), rectified flow interpolates ((1 - sigma) z +
    sigma n)."""
    require_parameterization(parameterization)
    if parameterization == "flow":
        return (1.0 - sigma0) * latents + sigma0 * noise
    return latents + noise * sigma0


def masked_inpaint_model(model_fn: ModelFn, parameterization: str, latents: torch.Tensor,
                         noise: torch.Tensor, mask: torch.Tensor) -> ModelFn:
    """Inpainting: before every evaluation the unmasked region (mask 0)
    is pinned to the original `latents` re-noised to the current sigma
    with the trajectory's own `noise`, so only the masked region (mask 1
    = regenerate, ComfyUI's noise_mask polarity) evolves. Callers
    composite `out * mask + latents * (1 - mask)` after sampling."""

    def wrapped(x, sigma_batch, cond):
        sig = on_device(sigma_batch, x).reshape((-1,) + (1,) * (x.ndim - 1))
        ref = noise_latents(parameterization, latents, noise, sig)
        return model_fn(x * mask + ref * (1.0 - mask), sigma_batch, cond)

    return wrapped


def sigma_to_timestep(sigma: torch.Tensor) -> torch.Tensor:
    """Nearest training timestep of each sigma, as f32."""
    log_all = torch.from_numpy(np.log(_vp_sigmas()).astype(np.float32)).to(sigma.device)
    dist = torch.abs(torch.log(torch.clamp(sigma, min=1e-10))[..., None] - log_all)
    return torch.argmin(dist, dim=-1).float()


# --- sigmas on the host ---------------------------------------------------

def on_device(sigma_batch: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A host sigma batch on `like`'s device: an asynchronous copy, no
    wait for the device's queue."""
    return sigma_batch.to(device=like.device, non_blocking=True)


def percent_to_sigma(percent: float, parameterization: str = "eps",
                     shift: float = 3.0) -> float:
    """Sampling-progress percent (0 = the schedule's start, 1 = its end)
    → sigma: inf at 0, 0 at 1; between, the shifted flow time of t = 1 -
    percent for flow models, else the VP table's entry."""
    require_parameterization(parameterization)
    p = float(percent)
    if p <= 0.0:
        return float("inf")
    if p >= 1.0:
        return 0.0
    if parameterization == "flow":
        t = 1.0 - p
        return float(shift * t / (1.0 + (shift - 1.0) * t))
    table = _vp_sigmas()
    return float(table[round((1.0 - p) * (len(table) - 1))])


def _default_p2s(percent: float) -> float:
    return percent_to_sigma(percent, "eps")


def in_window(sigma_batch: torch.Tensor, window: tuple, p2s=_default_p2s) -> bool:
    """Whether sigma_batch[0] lies in the progress window [start, end):
    sigma <= p2s(start) and sigma > p2s(end). The sampler builds the
    batch on the host, so this reads no device. The bounds are rounded
    to f32 first: the JAX package compares its f32 sigma with them as
    f32, and a schedule's sigma can equal a bound only in f32."""
    s0 = np.float32(float(sigma_batch[0]))
    hi = np.float32(p2s(float(window[0])))
    lo = np.float32(p2s(float(window[1])))
    return bool(s0 <= hi and s0 > lo)


# --- multi-entry composition ---------------------------------------------

def _as_entries(cond) -> list:
    """A CONDITIONING value as its list of entries."""
    if isinstance(cond, (list, tuple)):
        return list(cond)
    return [cond]


def _needs_composite(cond) -> bool:
    """Whether a CONDITIONING value takes the per-entry path: several
    entries, or one restricted by an area, a mask or a timestep window."""
    entries = _as_entries(cond)
    if len(entries) > 1:
        return True
    e = entries[0]
    return (getattr(e, "area", None) is not None or getattr(e, "mask", None) is not None
            or getattr(e, "timestep_range", None) is not None)


def composite_eps(model_fn: ModelFn, x, sigma, cond, p2s=_default_p2s):
    """Multi-entry composition (the JAX package's `composite_eps`): each
    entry's prediction applies over its area (pixels // 8 in latents, or
    a percentage of the latent; evaluated on the crop), weighted by its
    strength x mask x timestep-window gate; the sum is divided by the
    summed weights, and cells no entry covers get eps 0. Every entry is
    evaluated every step, gated off or not, as the JAX package's single
    program does."""
    entries = _as_entries(cond)
    acc = torch.zeros_like(x)
    count = torch.zeros(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)
    for e in entries:
        weight = float(getattr(e, "strength", 1.0))
        mask = getattr(e, "mask", None)
        if mask is not None:
            m = torch.as_tensor(mask).to(device=x.device, dtype=x.dtype)
            if m.ndim == 4:
                m = m[..., 0]
            if m.ndim == 2:
                m = m[None]
            if tuple(m.shape[1:]) != tuple(x.shape[1:3]):
                m = resize_image(m[..., None], x.shape[1], x.shape[2], "bilinear")[..., 0]
            wmap = torch.clamp(m.to(x.dtype), 0.0, 1.0)[..., None] * weight
        else:
            wmap = torch.full(x.shape[:-1] + (1,), weight, dtype=x.dtype, device=x.device)
        window = getattr(e, "timestep_range", None)
        if window is not None and not in_window(sigma, window, p2s):
            wmap = wmap * 0.0
        area = getattr(e, "area", None)
        if area is None:
            acc = acc + model_fn(x, sigma, e) * wmap
            count = count + wmap.expand(count.shape)
            continue
        if area[0] == "percentage":
            ah, aw, ay, ax = resolve_area(area, x.shape[1], x.shape[2])
        else:
            ah, aw, ay, ax = (int(v) // 8 for v in area)
        # the origin clamped into the latent: an off-frame one would crop
        # nothing
        ay = min(max(ay, 0), x.shape[1] - 1)
        ax = min(max(ax, 0), x.shape[2] - 1)
        ah = max(1, min(ah, x.shape[1] - ay))
        aw = max(1, min(aw, x.shape[2] - ax))
        e_c = e
        concat = getattr(e, "concat_latent", None)
        if concat is not None and tuple(concat.shape[1:3]) == tuple(x.shape[1:3]):
            # the concat plane follows the crop: the model would otherwise
            # squash the whole plane into the window
            e_c = e.clone()
            e_c.concat_latent = concat[:, ay:ay + ah, ax:ax + aw, :]
        if getattr(e, "control_hint", None) is not None:
            # the hint is in pixels: crop the matching pixel window
            e_c = e_c.clone() if e_c is e else e_c
            k = max(1, e.control_hint.shape[1] // x.shape[1])
            e_c.control_hint = e.control_hint[:, ay * k:(ay + ah) * k, ax * k:(ax + aw) * k, :]
        eps_c = model_fn(x[:, ay:ay + ah, ax:ax + aw, :], sigma, e_c)
        w_c = wmap.expand(x.shape[:-1] + (1,))[:, ay:ay + ah, ax:ax + aw, :]
        acc[:, ay:ay + ah, ax:ax + aw, :] += eps_c * w_c
        count[:, ay:ay + ah, ax:ax + aw, :] += w_c
    return acc / torch.clamp(count, min=1e-9)


# --- CFG -----------------------------------------------------------------

def _reject_unsupported_cond(*conds) -> None:
    """Fail on conditioning that no ported model consumes."""
    for cond in conds:
        for e in _as_entries(cond):
            reject_unported(e)


def _conds_batchable(pos, neg) -> bool:
    """Whether cond and uncond can ride one 2B-batched model pass (the
    JAX package's rule): neither carries a ControlNet, the static fields
    agree and the same tensor fields are set, with the same shapes."""
    pos, neg = as_conditioning(pos), as_conditioning(neg)
    if pos.control_net is not None or neg.control_net is not None:
        return False
    if any(getattr(pos, name) != getattr(neg, name) for name in STATIC_FIELDS):
        return False
    for name in TENSOR_FIELDS:
        a, b = getattr(pos, name), getattr(neg, name)
        if (a is None) != (b is None) or (a is not None and a.shape != b.shape):
            return False
    for name in LIST_FIELDS:
        a, b = getattr(pos, name), getattr(neg, name)
        if (a is None) != (b is None) or (a is not None and [t.shape for t in a]
                                          != [t.shape for t in b]):
            return False
    return True


def _eps_each(model_fn: ModelFn, x, sigma, conds, p2s=_default_p2s) -> list:
    """One prediction per CONDITIONING value: several in one batched model
    call (2B for CFG's pair, 3B for PerpNeg's and DualCFG's three) where
    none takes the per-entry path and every pair passes
    `_conds_batchable`, else one call (or one per-entry composition)
    each."""
    composite = any(_needs_composite(c) for c in conds)
    entries = [_as_entries(c)[0] for c in conds]
    if len(conds) > 1 and not composite and all(
            _conds_batchable(a, b) for i, a in enumerate(entries) for b in entries[i + 1:]):
        n = len(entries)
        joined = concat_batch(*(as_conditioning(e) for e in entries))
        return list(model_fn(torch.cat([x] * n, dim=0), torch.cat([sigma] * n, dim=0),
                             joined).chunk(n, dim=0))
    return [composite_eps(model_fn, x, sigma, c, p2s) if _needs_composite(c)
            else model_fn(x, sigma, _as_entries(c)[0]) for c in conds]


def _cfg_eval(model_fn: ModelFn, cfg_scale: float, x, sigma, cond, p2s=_default_p2s):
    """One CFG evaluation → (eps_pos, guided eps), through `_eps_each`:
    the two sides as one 2B-batched model call where they batch, the
    per-entry path where a side needs it; at cfg 1 the positive alone."""
    pos, neg = cond
    _reject_unsupported_cond(pos, neg)
    if cfg_scale == 1.0:
        (eps_pos,) = _eps_each(model_fn, x, sigma, (pos,), p2s)
        return eps_pos, eps_pos
    eps_pos, eps_neg = _eps_each(model_fn, x, sigma, (pos, neg), p2s)
    return eps_pos, eps_neg + cfg_scale * (eps_pos - eps_neg)


def cfg_model(model_fn: ModelFn, cfg_scale: float, p2s=_default_p2s) -> ModelFn:
    """Classifier-free guidance; cond is the (positive, negative) pair.
    `p2s` converts progress percents to sigmas for the timestep windows."""

    def guided(x, sigma, cond):
        return _cfg_eval(model_fn, cfg_scale, x, sigma, cond, p2s)[1]

    return guided


def dual_cfg_model(model_fn: ModelFn, cfg_conds: float, cfg_cond2_negative: float,
                   p2s=_default_p2s, nested: bool = False) -> ModelFn:
    """Dual-conditioning CFG (DualCFGGuider); cond is ((cond1, cond2),
    negative):

    regular:  mid = neg + cfg_cond2_negative * (eps2 - neg)
              out = mid + cfg_conds * (eps1 - eps2)
    nested:   inner = eps2 + cfg_conds * (eps1 - eps2)
              out   = neg + cfg_cond2_negative * (inner - neg)

    Regular with cond2 equal to the negative is plain CFG over (cond1,
    negative) at cfg_conds; nested at cfg_conds 1 is plain CFG over
    (cond1, negative) at cfg_cond2_negative, and runs as that 2B program.
    Otherwise the three sides run as one 3B-batched call where they
    batch (`_eps_each`)."""

    def guided(x, sigma, cond):
        (pos1, pos2), neg = cond
        _reject_unsupported_cond(pos1, pos2, neg)
        if nested and cfg_conds == 1.0:
            # inner == eps1: plain CFG, no cond2 evaluation
            return _cfg_eval(model_fn, cfg_cond2_negative, x, sigma, (pos1, neg), p2s)[1]
        e1, e2, en = _eps_each(model_fn, x, sigma, (pos1, pos2, neg), p2s)
        if nested:
            inner = e2 + cfg_conds * (e1 - e2)
            return en + cfg_cond2_negative * (inner - en)
        mid = en + cfg_cond2_negative * (e2 - en)
        return mid + cfg_conds * (e1 - e2)

    return guided


def perp_neg_model(model_fn: ModelFn, cfg_scale: float, neg_scale: float,
                   p2s=_default_p2s) -> ModelFn:
    """Perpendicular negative guidance (PerpNegGuider; Armandpour et al.
    2023); cond is ((positive, negative), empty):

        pos  = eps(positive) - eps(empty)
        neg  = eps(negative) - eps(empty)
        perp = neg - (<neg, pos> / |pos|^2) * pos     (per sample)
        out  = eps(empty) + cfg_scale * (pos - neg_scale * perp)

    Only the part of the negative orthogonal to the positive pushes away.
    The three sides run as one 3B-batched call where they batch."""

    def guided(x, sigma, cond):
        (pos_c, neg_c), empty_c = cond
        _reject_unsupported_cond(pos_c, neg_c, empty_c)
        e_pos, e_neg, e_empty = _eps_each(model_fn, x, sigma, (pos_c, neg_c, empty_c), p2s)
        pos = e_pos - e_empty
        neg = e_neg - e_empty
        dims = tuple(range(1, x.ndim))
        dot = torch.sum(neg * pos, dim=dims, keepdim=True)
        sq = torch.clamp(torch.sum(pos * pos, dim=dims, keepdim=True), min=1e-12)
        perp = neg - (dot / sq) * pos
        return e_empty + cfg_scale * (pos - neg_scale * perp)

    return guided


def _perturbed_delta(pert_model_fn: ModelFn, x, sigma, pos, eps_pos, scale: float,
                     p2s=_default_p2s):
    """scale * (eps_pos - eps_perturbed): one perturbed evaluation
    against the positive conditioning, composed per entry where it needs
    that."""
    if _needs_composite(pos):
        eps_pert = composite_eps(pert_model_fn, x, sigma, pos, p2s)
    else:
        eps_pert = pert_model_fn(x, sigma, _as_entries(pos)[0])
    return scale * (eps_pos - eps_pert)


def pag_cfg_model(model_fn: ModelFn, pag_model_fn: ModelFn, cfg_scale: float,
                  pag_scale: float, p2s=_default_p2s) -> ModelFn:
    """CFG plus perturbed-attention guidance (PAG, Ahn et al. 2024): the
    result gains pag_scale * (cond - cond with the middle block's
    self-attention as identity), `pag_model_fn` being that perturbed
    model. One extra positive-cond evaluation a step, at batch B."""

    def guided(x, sigma, cond):
        pos, _neg = cond
        eps_pos, base = _cfg_eval(model_fn, cfg_scale, x, sigma, cond, p2s)
        return base + _perturbed_delta(pag_model_fn, x, sigma, pos, eps_pos, pag_scale, p2s)

    return guided


def in_slg_window(sigma: float, sigma_start: float, sigma_end: float) -> bool:
    """Whether skip-layer guidance acts at `sigma`: sigma_end <= sigma <=
    sigma_start, compared in f32 as the JAX package compares its f32
    sigma with the bounds."""
    s0 = np.float32(sigma)
    return bool(np.float32(sigma_end) <= s0 <= np.float32(sigma_start))


def slg_cfg_model(model_fn: ModelFn, skip_model_fn: ModelFn, cfg_scale: float,
                  slg_scale: float, sigma_start: float, sigma_end: float,
                  p2s=_default_p2s) -> ModelFn:
    """CFG plus SD3.5's skip-layer guidance (SkipLayerGuidanceSD3): while
    sigma lies in [sigma_end, sigma_start] the result gains slg_scale *
    (eps_pos - eps_pos with the listed joint blocks skipped), one more
    evaluation of the positive conditioning at its own batch; outside the
    window it is plain CFG and the skip pass does not run. The gate reads
    sigma_batch[0] (every step broadcasts one sigma), which the sampler
    hands over on the host from its schedule: no read from the device."""

    def guided(x, sigma, cond):
        pos, _neg = cond
        eps_pos, base = _cfg_eval(model_fn, cfg_scale, x, sigma, cond, p2s)
        if not in_slg_window(float(sigma[0]), sigma_start, sigma_end):
            return base
        return base + _perturbed_delta(skip_model_fn, x, sigma, pos, eps_pos, slg_scale, p2s)

    return guided


def rescale_cfg_model(model_fn: ModelFn, cfg_scale: float, multiplier: float,
                      p2s=_default_p2s) -> ModelFn:
    """CFG with std rescaling (RescaleCFG; Lin et al., "Common Diffusion
    Noise Schedules and Sample Steps are Flawed", 3.4): the guided and
    the positive denoised outputs go to v space, the guided v is scaled
    to the positive one's per-sample population std (not torch's default
    unbiased std: the JAX package takes jnp.std), lerped by `multiplier`,
    and brought back to eps."""

    def guided(x, sigma, cond):
        eps_pos, eps_cfg = _cfg_eval(model_fn, cfg_scale, x, sigma, cond, p2s)
        sig = on_device(sigma, x).reshape((-1,) + (1,) * (x.ndim - 1))
        x0_pos = x - sig * eps_pos
        x0_cfg = x - sig * eps_cfg
        xs = x / (sig * sig + 1.0)
        scale = torch.sqrt(sig * sig + 1.0) / _floor(sig)
        v_pos = (xs - (x - x0_pos)) * scale
        v_cfg = (xs - (x - x0_cfg)) * scale
        dims = tuple(range(1, x.ndim))
        ro_pos = torch.std(v_pos, dim=dims, keepdim=True, correction=0)
        ro_cfg = torch.clamp(torch.std(v_cfg, dim=dims, keepdim=True, correction=0), min=1e-8)
        v_final = multiplier * (v_cfg * (ro_pos / ro_cfg)) + (1.0 - multiplier) * v_cfg
        x0 = x - (xs - v_final * sig / torch.sqrt(sig * sig + 1.0))
        return (x - x0) / _floor(sig)

    return guided


def sag_cfg_model(model_fn: ModelFn, capture_fn, cfg_scale: float, sag_scale: float,
                  blur_sigma: float, p2s=_default_p2s) -> ModelFn:
    """CFG plus self-attention guidance (SAG, Hong et al. 2023). A step:

      1. the capture pass, `capture_fn(x, sigma, neg)` → (eps_uncond,
         the middle block's first self-attention probabilities [B,
         heads, N, N], (mid_h, mid_w));
      2. the salience mask: the attention each middle token receives
         (mean over heads, summed over queries) above 1, the uniform
         level, resized nearest to the latent (jax.image.resize's
         half-pixel sampling: "nearest-exact");
      3. the uncond x0 estimate blurred (radius 4, `blur_sigma`) where
         salient and re-noised with the same noise, x - x0;
      4. out = cfg + sag_scale * (eps_uncond - eps_degraded).

    Four model evaluations a step: the CFG pair, the capture and the
    degraded pass. The negative must be a single entry."""

    def guided(x, sigma, cond):
        pos, neg = cond
        if _needs_composite(neg):
            raise ValueError("SelfAttentionGuidance needs a single negative conditioning "
                             "entry (the degraded pass re-evaluates the uncond prediction)")
        eps_pos, base = _cfg_eval(model_fn, cfg_scale, x, sigma, cond, p2s)
        neg = _as_entries(neg)[0]
        eps_u, probs, (mid_h, mid_w) = capture_fn(x, sigma, neg)
        sig = on_device(sigma, x).reshape((-1,) + (1,) * (x.ndim - 1))
        u_x0 = x - sig * eps_u
        received = probs.mean(dim=1).sum(dim=1)  # [B, middle tokens]
        mask = (received > 1.0).to(x.dtype).reshape(-1, 1, mid_h, mid_w)
        mask = F.interpolate(mask, size=(x.shape[1], x.shape[2]),
                             mode="nearest-exact").permute(0, 2, 3, 1)
        blurred = gaussian_blur(u_x0, 4, blur_sigma)
        degraded_x0 = blurred * mask + u_x0 * (1.0 - mask)
        eps_d = model_fn(degraded_x0 + (x - u_x0), sigma, neg)
        return base + sag_scale * (eps_u - eps_d)

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
    """x0 prediction from the eps model at a host scalar sigma. The model
    gets the sigma batch on the host (`on_device` moves it), so its gates
    read sigma with no device synchronisation."""
    sig_batch = torch.full((x.shape[0],), float(sigma), dtype=torch.float32)
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


def _sample_euler_ancestral_rf(model_fn, x, sigmas, cond, noise, eta: float = 1.0):
    """Ancestral Euler for rectified flow: under x_t = (1 - s) x0 + s n the
    VE renoising leaves the flow marginal, so the step goes down to
    sigma_down, rescales the signal by alpha_next / alpha_down and
    renoises by the amount that restores the (1 - s_next, s_next)
    marginal; the step to sigma 0 returns the denoised sample."""
    for i, sigma, sigma_next in _pairs(sigmas):
        den = _denoised(model_fn, x, sigma, cond)
        if not sigma_next > 0:
            x = den
            continue
        sigma_down = sigma_next * (1.0 + (sigma_next / _floor(sigma) - 1.0) * eta)
        alpha_next = 1.0 - sigma_next
        alpha_down = _floor(1.0 - sigma_down)
        renoise = torch.sqrt(torch.clamp(
            sigma_next**2 - sigma_down**2 * (alpha_next / alpha_down) ** 2, min=0.0))
        r = sigma_down / _floor(sigma)
        x_det = r * x + (1.0 - r) * den
        x = (alpha_next / alpha_down) * x_det + noise(i, 0, x) * renoise
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
           noise: StepNoise | None = None, flow: bool = False) -> torch.Tensor:
    """Run a sampling trajectory from x_init (already at sigmas[0]).
    `noise` is the stochastic samplers' step noise; they raise without
    it. `flow` (rectified-flow models): euler_ancestral takes the RF rule,
    the other stochastic samplers raise. Pass `sigmas` on the host: a
    device copy costs a synchronisation here."""
    sigmas = sigmas.detach().to("cpu", torch.float32)
    if sampler in _DETERMINISTIC:
        return _DETERMINISTIC[sampler](model_fn, x_init, sigmas, cond)
    if sampler in _STOCHASTIC:
        if noise is None:
            raise ValueError(f"{sampler} requires step noise")
        if flow:
            if sampler != "euler_ancestral":
                raise ValueError(
                    f"{sampler!r} renoises with the VE rule, which is invalid for rectified-flow "
                    "models; use a deterministic sampler (euler, ddim, dpmpp_2m, ...) or "
                    "euler_ancestral")
            return _sample_euler_ancestral_rf(model_fn, x_init, sigmas, cond, noise)
        return _STOCHASTIC[sampler](model_fn, x_init, sigmas, cond, noise)
    raise ValueError(f"unknown sampler {sampler!r}; use {SAMPLER_NAMES}")


# --- flow matching for the video DiT family -------------------------------

def get_flow_timesteps(steps: int, shift: float = 3.0) -> torch.Tensor:
    """[steps+1] descending flow times in [1, 0] as f32 on the host, through
    the timestep shift t' = s t / (1 + (s - 1) t)."""
    t = np.linspace(1.0, 0.0, steps + 1)
    t = shift * t / (1.0 + (shift - 1.0) * t)
    return torch.from_numpy(t.astype(np.float32))


def _t_batch(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The model's [B] timestep, t x 1000 in f32 on the host."""
    return (t * 1000.0).expand(x.shape[0]).clone()


def sample_flow(model_fn: ModelFn, x: torch.Tensor, timesteps: torch.Tensor, cond: Any
                ) -> torch.Tensor:
    """Euler ODE of velocity-prediction flow matching: noise at t = 1,
    data at t = 0; x_{t'} = x + v (t' - t), `model_fn(x, t_batch x 1000,
    cond) -> v` (the batch on the host)."""
    timesteps = timesteps.detach().to("cpu", torch.float32)
    for t, t_next in zip(timesteps[:-1], timesteps[1:]):
        x = x + model_fn(x, _t_batch(t, x), cond) * (t_next - t)
    return x


def _cond_pair_batchable(pos, neg) -> bool:
    """Whether two text conditionings (tensors) ride one 2B-batched pass."""
    return (isinstance(pos, torch.Tensor) and isinstance(neg, torch.Tensor)
            and pos.shape == neg.shape)


def cfg_flow_model(model_fn: ModelFn, cfg_scale: float) -> ModelFn:
    """CFG for velocity models; cond is (positive, negative), joined into
    one 2B-batched pass where they batch."""
    if cfg_scale == 1.0:
        def passthrough(x, t, cond):
            return model_fn(x, t, cond[0])
        return passthrough

    def guided(x, t, cond):
        pos, neg = cond
        if _cond_pair_batchable(pos, neg):
            v_pos, v_neg = model_fn(torch.cat([x, x], dim=0), torch.cat([t, t], dim=0),
                                    torch.cat([pos, neg], dim=0)).chunk(2, dim=0)
        else:
            v_pos, v_neg = model_fn(x, t, pos), model_fn(x, t, neg)
        return v_neg + cfg_scale * (v_pos - v_neg)

    return guided


def sample_flow_masked(model_fn: ModelFn, x: torch.Tensor, timesteps: torch.Tensor, cond: Any,
                       known: torch.Tensor, mask: torch.Tensor, noise: torch.Tensor
                       ) -> torch.Tensor:
    """Flow sampling with clamped known regions (i2v's fallback): where
    mask is 1 the latent is reset after every step onto the straight path
    (1 - t) known + t noise, elsewhere it evolves freely."""
    timesteps = timesteps.detach().to("cpu", torch.float32)
    t0 = timesteps[0]
    x = x * (1.0 - mask) + ((1.0 - t0) * known + t0 * noise) * mask
    for t, t_next in zip(timesteps[:-1], timesteps[1:]):
        x = x + model_fn(x, _t_batch(t, x), cond) * (t_next - t)
        clamped = (1.0 - t_next) * known + t_next * noise
        x = x * (1.0 - mask) + clamped * mask
    return x
