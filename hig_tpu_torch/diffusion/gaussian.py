"""Diffusion schedule tables, the forward process the trainer noises with,
and the DDIM sampler (counterpart of
``hig_tpu/diffusion/gaussian.py:36-140,301-376,522-541``).

The coefficient tables are computed once in float64 on the host and stored
as float32, as the JAX package does. Only the deterministic DDIM fast path
(eta = 0, no x0 clipping) is ported: there the update is linear in
(x, eps), x' = c1·x + c2·eps, with c1/c2 computed in float32 numpy from
the float32 tables exactly as the JAX sampler computes them. DDPM-1000 and
DPM-Solver++ are not ported yet. Training takes the epsilon target only.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch


def linear_betas(num_timesteps: int) -> np.ndarray:
    """Ho et al. linear schedule, scaled for any step count."""
    scale = 1000 / num_timesteps
    return np.linspace(scale * 1e-4, scale * 0.02, num_timesteps, dtype=np.float64)


def schedule_tables_f64(betas: np.ndarray) -> dict[str, np.ndarray]:
    """The reference's float64 coefficient tables."""
    betas = np.asarray(betas, dtype=np.float64)
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
    posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
    return dict(
        betas=betas,
        alphas_cumprod=alphas_cumprod,
        alphas_cumprod_prev=alphas_cumprod_prev,
        sqrt_alphas_cumprod=np.sqrt(alphas_cumprod),
        sqrt_one_minus_alphas_cumprod=np.sqrt(1.0 - alphas_cumprod),
        log_one_minus_alphas_cumprod=np.log(1.0 - alphas_cumprod),
        sqrt_recip_alphas_cumprod=np.sqrt(1.0 / alphas_cumprod),
        sqrt_recipm1_alphas_cumprod=np.sqrt(1.0 / alphas_cumprod - 1),
        posterior_variance=posterior_variance,
        posterior_log_variance_clipped=np.log(
            np.append(posterior_variance[1], posterior_variance[1:])
        ),
        posterior_mean_coef1=betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod),
        posterior_mean_coef2=(1.0 - alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - alphas_cumprod),
    )


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Per-timestep coefficient tables, float32 numpy arrays of shape (T,)."""

    betas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    log_one_minus_alphas_cumprod: np.ndarray
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray
    posterior_variance: np.ndarray
    posterior_log_variance_clipped: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray

    @property
    def num_timesteps(self) -> int:
        return self.betas.shape[0]


def make_schedule(betas: np.ndarray) -> DiffusionSchedule:
    tables = schedule_tables_f64(betas)
    return DiffusionSchedule(**{k: v.astype(np.float32) for k, v in tables.items()})


def _extract(table: np.ndarray, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Per-timestep coefficients for ``t`` (B,), shaped to broadcast over an
    ``ndim`` tensor."""
    out = torch.as_tensor(table, device=t.device)[t]
    return out.reshape(*out.shape, *(1,) * (ndim - out.ndim))


def q_sample(sched: DiffusionSchedule, x_start: torch.Tensor, t: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
    """A draw of q(x_t | x_0) with the given noise."""
    return (_extract(sched.sqrt_alphas_cumprod, t, x_start.ndim) * x_start
            + _extract(sched.sqrt_one_minus_alphas_cumprod, t, x_start.ndim) * noise)


def training_targets(sched: DiffusionSchedule, x_start: torch.Tensor, t: torch.Tensor,
                     noise: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(x_t, target) of the MSE loss; the target is the noise (epsilon
    prediction, the only mean type the trainer uses)."""
    return q_sample(sched, x_start, t, noise), noise


def ddim_timesteps(T: int, num_steps: int) -> np.ndarray:
    """The DDIM stride grid (descending, ending at 0). ``num_steps=1`` is
    the one-call regime: the single evaluation happens at t = T-1."""
    if num_steps == 1:
        return np.asarray([T - 1], np.int64)
    return np.linspace(0, T - 1, num_steps).round().astype(np.int64)[::-1]


def ddim_coefficients(sched: DiffusionSchedule, ts: np.ndarray):
    """float32 (c1, c2) of x' = c1·x + c2·eps for each step of ``ts``."""
    ts_prev = np.append(ts[1:], -1)
    ab = np.asarray(sched.alphas_cumprod, np.float32)
    abp = np.append(ab, np.float32(1.0))[ts_prev]
    sra = np.asarray(sched.sqrt_recip_alphas_cumprod, np.float32)[ts]
    srm1 = np.asarray(sched.sqrt_recipm1_alphas_cumprod, np.float32)[ts]
    c1 = np.sqrt(abp) * sra
    c2 = np.sqrt(1.0 - abp) - np.sqrt(abp) * srm1
    return c1, c2


Denoiser = Callable[..., torch.Tensor]


def ddim_sample_loop(sched: DiffusionSchedule, model: Denoiser, noise: torch.Tensor,
                     num_steps: int | None = None, model_aux=None) -> torch.Tensor:
    """Deterministic DDIM (eta = 0) from the initial ``noise`` (B, ...).

    ``model(x, t)`` predicts eps for timesteps ``t`` (B,) int64; with
    ``model_aux`` (a list with one entry per step) it is called as
    ``model(x, t, model_aux[i])``.
    """
    ts = ddim_timesteps(sched.num_timesteps, num_steps or sched.num_timesteps)
    c1, c2 = ddim_coefficients(sched, ts)
    x = noise
    batch = x.shape[0]
    for i, t_scalar in enumerate(ts):
        t = torch.full((batch,), int(t_scalar), dtype=torch.int64, device=x.device)
        eps = model(x, t) if model_aux is None else model(x, t, model_aux[i])
        x = float(c1[i]) * x + float(c2[i]) * eps.to(x.dtype)
    return x
