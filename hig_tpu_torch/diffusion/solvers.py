"""DPM-Solver++(2M), the second-order multistep ODE sampler (counterpart of
``hig_tpu/diffusion/solvers.py``).

Data-prediction ("++") form in half-log-SNR time λ = log(α/σ), α = √ᾱ,
σ = √(1 − ᾱ), over the DDIM stride grid. Every per-step coefficient is
computed once on the host in float64 from the float32 tables and cast to
float32, as the JAX loop feeds them to its scan; each step is one denoiser
call and a few multiply-adds. The first step has no history and the last
hop (to σ = 0, h = ∞) would make the 2M correction diverge, so both are
first-order; the last returns the x0 prediction exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from hig_tpu_torch.diffusion import gaussian as g


def _grid_lambdas(sched: g.DiffusionSchedule, ts: np.ndarray) -> np.ndarray:
    """Half-log-SNR at each grid point, float64 on the host."""
    ab = np.asarray(sched.alphas_cumprod, np.float64)[ts]
    return 0.5 * (np.log(ab) - np.log1p(-ab))


def dpmpp_2m_coefficients(sched: g.DiffusionSchedule, ts: np.ndarray):
    """float32 (x_coef, d_coef, c0, c1, first) per step: x' = x_coef·x +
    d_coef·D with D = x0 on first-order steps (``first``), else
    c0·x0 + c1·x0_prev."""
    lam = _grid_lambdas(sched, ts)
    ab = np.asarray(sched.alphas_cumprod, np.float64)[ts]
    alpha, sigma = np.sqrt(ab), np.sqrt(1.0 - ab)
    alpha_next = np.append(alpha[1:], 1.0)
    sigma_next = np.append(sigma[1:], 0.0)
    h = np.append(lam[1:], np.inf) - lam  # > 0; the last is inf
    h_prev = np.concatenate([[np.nan], h[:-1]])
    with np.errstate(divide="ignore", invalid="ignore"):
        r = h_prev / h
        c0 = 1.0 + 1.0 / (2.0 * r)
        c1 = -1.0 / (2.0 * r)
    x_coef = sigma_next / sigma
    d_coef = -alpha_next * np.expm1(-h)
    x_coef[-1], d_coef[-1] = 0.0, 1.0  # the final hop returns x0
    first = np.zeros(len(ts), bool)
    first[[0, -1]] = True
    c0[[0, -1]] = 0.0
    c1[[0, -1]] = 0.0
    f32 = lambda a: np.nan_to_num(a).astype(np.float32)
    return f32(x_coef), f32(d_coef), f32(c0), f32(c1), first


def dpmpp_2m_sample_loop(sched: g.DiffusionSchedule, model: g.Denoiser, noise: torch.Tensor,
                         num_steps: int = 20, model_aux=None,
                         tables: g.DiffusionSchedule | None = None) -> torch.Tensor:
    """Deterministic DPM-Solver++(2M) from x_T = ``noise`` over
    ``g.ddim_timesteps(T, num_steps)``; ``model``, ``model_aux`` and
    ``tables`` as in :func:`~hig_tpu_torch.diffusion.gaussian.ddim_sample_loop`."""
    ts = g.ddim_timesteps(sched.num_timesteps, num_steps)
    x_coef, d_coef, c0, c1, first = dpmpp_2m_coefficients(sched, ts)
    tabs = tables if tables is not None else sched.on(noise.device)
    x, x0_prev, batch = noise, torch.zeros_like(noise), noise.shape[0]
    for i, t_scalar in enumerate(ts):
        t = torch.full((batch,), int(t_scalar), dtype=torch.int64, device=x.device)
        eps = model(x, t) if model_aux is None else model(x, t, model_aux[i])
        x0 = g.predict_xstart_from_eps(tabs, x, t, eps.to(x.dtype))
        d = x0 if first[i] else float(c0[i]) * x0 + float(c1[i]) * x0_prev
        x = float(x_coef[i]) * x + float(d_coef[i]) * d
        x0_prev = x0
    return x
