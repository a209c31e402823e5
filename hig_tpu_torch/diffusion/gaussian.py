"""Diffusion schedule tables, the forward process the trainer noises with,
the DDPM and DDIM samplers and the likelihood terms (counterpart of
``hig_tpu/diffusion/gaussian.py``).

The coefficient tables are computed once in float64 on the host and stored
as float32, as the JAX package does. The ancestral sampler
(:func:`p_sample_loop`) and the general DDIM step (eta > 0 or x0 clipping)
gather their coefficients per timestep, on the device, from the tables
there: the caller's ``tables=`` (:meth:`DiffusionSchedule.on`, which a
sampler makes once, so a step copies nothing from the host and a CUDA
graph can capture it), else moved there once per call. The deterministic
DDIM fast path (eta = 0, no x0 clipping) is linear in (x, eps), x' =
c1·x + c2·eps, with c1/c2 computed in float32 numpy from the float32 tables
exactly as the JAX sampler computes them.

Every draw of a loop (x_T, each step's noise, the prefix and pin draws)
comes from its ``generator`` unless the caller hands it in (``noise=``,
``step_noise=``, ``pre_noise=``, ``pin_noise=``), so a test can replay the
JAX package's key chain. Training takes the epsilon target only.

The likelihood terms (``normal_kl`` to ``calc_bpd_loop``, JAX's
``:413-520``) give the variational bound in bits per dimension; the loop
draws one noise per timestep from its ``generator`` unless handed them
(``noise=``).
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Callable

import numpy as np
import torch


class MeanType(enum.Enum):
    PREVIOUS_X = "previous_x"
    START_X = "start_x"
    EPSILON = "epsilon"


class VarType(enum.Enum):
    FIXED_SMALL = "fixed_small"
    FIXED_LARGE = "fixed_large"


def linear_betas(num_timesteps: int) -> np.ndarray:
    """Ho et al. linear schedule, scaled for any step count."""
    scale = 1000 / num_timesteps
    return np.linspace(scale * 1e-4, scale * 0.02, num_timesteps, dtype=np.float64)


def cosine_betas(num_timesteps: int, max_beta: float = 0.999) -> np.ndarray:
    """Nichol & Dhariwal cosine schedule."""
    def alpha_bar(t):
        return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

    betas = [min(1 - alpha_bar((i + 1) / num_timesteps) / alpha_bar(i / num_timesteps),
                 max_beta) for i in range(num_timesteps)]
    return np.array(betas, dtype=np.float64)


def named_betas(name: str, num_timesteps: int) -> np.ndarray:
    if name == "linear":
        return linear_betas(num_timesteps)
    if name == "cosine":
        return cosine_betas(num_timesteps)
    raise ValueError(f"unknown beta schedule: {name}")


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

    def on(self, device) -> "DiffusionSchedule":
        """The same tables as float32 tensors on ``device``, which the
        functions below gather from without a copy per call."""
        return DiffusionSchedule(**{f.name: torch.as_tensor(getattr(self, f.name), device=device)
                                    for f in dataclasses.fields(self)})


def make_schedule(betas: np.ndarray) -> DiffusionSchedule:
    tables = schedule_tables_f64(betas)
    return DiffusionSchedule(**{k: v.astype(np.float32) for k, v in tables.items()})


def _on_device(table, device) -> torch.Tensor:
    """``table`` itself when it is a tensor (on ``device``), else a copy of
    the host table there."""
    return table if torch.is_tensor(table) else torch.as_tensor(table, device=device)


def _extract(table, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Per-timestep coefficients of ``table`` (a tensor on t's device, or a
    host table, copied there per call) for ``t`` (B,), shaped to broadcast
    over an ``ndim`` tensor."""
    out = _on_device(table, t.device)[t]
    return out.reshape(*out.shape, *(1,) * (ndim - out.ndim))


def q_sample(sched: DiffusionSchedule, x_start: torch.Tensor, t: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
    """A draw of q(x_t | x_0) with the given noise."""
    return (_extract(sched.sqrt_alphas_cumprod, t, x_start.ndim) * x_start
            + _extract(sched.sqrt_one_minus_alphas_cumprod, t, x_start.ndim) * noise)


def q_posterior_mean_variance(sched: DiffusionSchedule, x_start: torch.Tensor,
                              x_t: torch.Tensor, t: torch.Tensor):
    """Mean, variance and clipped log-variance of q(x_{t-1} | x_t, x_0)."""
    mean = (_extract(sched.posterior_mean_coef1, t, x_t.ndim) * x_start
            + _extract(sched.posterior_mean_coef2, t, x_t.ndim) * x_t)
    var = _extract(sched.posterior_variance, t, x_t.ndim)
    log_var = _extract(sched.posterior_log_variance_clipped, t, x_t.ndim)
    return mean, var, log_var


def predict_xstart_from_eps(sched: DiffusionSchedule, x_t: torch.Tensor, t: torch.Tensor,
                            eps: torch.Tensor) -> torch.Tensor:
    return (_extract(sched.sqrt_recip_alphas_cumprod, t, x_t.ndim) * x_t
            - _extract(sched.sqrt_recipm1_alphas_cumprod, t, x_t.ndim) * eps)


def predict_eps_from_xstart(sched: DiffusionSchedule, x_t: torch.Tensor, t: torch.Tensor,
                            x0: torch.Tensor) -> torch.Tensor:
    return ((_extract(sched.sqrt_recip_alphas_cumprod, t, x_t.ndim) * x_t - x0)
            / _extract(sched.sqrt_recipm1_alphas_cumprod, t, x_t.ndim))


def p_mean_variance(sched: DiffusionSchedule, model_output: torch.Tensor, x: torch.Tensor,
                    t: torch.Tensor, mean_type: MeanType = MeanType.EPSILON,
                    var_type: VarType = VarType.FIXED_SMALL, clip_denoised: bool = False):
    """Model output → (mean, log-variance) of p(x_{t-1} | x_t) and the x0
    prediction, for the fixed variances and the epsilon or x0 output."""
    if var_type == VarType.FIXED_SMALL:
        log_var = _extract(sched.posterior_log_variance_clipped, t, x.ndim)
    else:
        pv = _on_device(sched.posterior_variance, x.device)
        betas = _on_device(sched.betas, x.device)
        log_var = _extract(torch.log(torch.cat([pv[1:2], betas[1:]])), t, x.ndim)
    if mean_type == MeanType.EPSILON:
        pred_xstart = predict_xstart_from_eps(sched, x, t, model_output)
    elif mean_type == MeanType.START_X:
        pred_xstart = model_output
    else:
        raise NotImplementedError(mean_type)
    if clip_denoised:
        pred_xstart = pred_xstart.clamp(-1.0, 1.0)
    mean, _, _ = q_posterior_mean_variance(sched, pred_xstart, x, t)
    return mean, log_var, pred_xstart


def condition_mean(sched, cond_fn, mean, var, x, t) -> torch.Tensor:
    """Sohl-Dickstein classifier-guidance shift of the posterior mean."""
    return mean + var * cond_fn(x, t)


def condition_score(sched, cond_fn, pred_xstart, x, t):
    """Song et al. score conditioning: shift eps by −√(1−ᾱ)·∇log p(y|x).
    Returns the updated (mean, pred_xstart)."""
    alpha_bar = _extract(sched.alphas_cumprod, t, x.ndim)
    eps = predict_eps_from_xstart(sched, x, t, pred_xstart)
    eps = eps - torch.sqrt(1 - alpha_bar) * cond_fn(x, t)
    new_xstart = predict_xstart_from_eps(sched, x, t, eps)
    mean, _, _ = q_posterior_mean_variance(sched, new_xstart, x, t)
    return mean, new_xstart


def _drawer(x: torch.Tensor, generator: torch.Generator | None):
    """draw(shape): standard normal noise like ``x`` from ``generator``; a
    loop that needs a draw it was not handed and has no generator raises."""
    def draw(shape):
        if generator is None:
            raise ValueError("the sampler needs its per-step draws or a torch.Generator")
        return torch.randn(tuple(shape), generator=generator, device=x.device, dtype=x.dtype)

    return draw


Denoiser = Callable[..., torch.Tensor]


def p_sample_loop(sched: DiffusionSchedule, model: Denoiser, noise: torch.Tensor,
                  generator: torch.Generator | None = None, clip_denoised: bool = False,
                  mean_type: MeanType = MeanType.EPSILON,
                  var_type: VarType = VarType.FIXED_SMALL, cond_fn: Callable | None = None,
                  pre_seq: torch.Tensor | None = None, pre_seq_len: int = 0,
                  transl_req: list | None = None, step_noise: Callable | None = None,
                  pre_noise: Callable | None = None, pin_noise: Callable | None = None,
                  tables: DiffusionSchedule | None = None) -> torch.Tensor:
    """Ancestral (DDPM) sampler over every timestep, from x_T = ``noise``.

    ``model(x, t)`` predicts for timesteps ``t`` (B,) int64. Hooks, as in
    the JAX loop: ``cond_fn(x, t) -> grad`` (classifier guidance);
    ``pre_seq``/``pre_seq_len`` re-noise the first ``pre_seq_len`` tokens
    from ``pre_seq`` every step (motion-prefix inpainting);
    ``transl_req`` [(frame_idx, x, z), ...] pins the root trajectory of a
    (B, T, D) sample. Step ``i`` (t = T − 1 − i) draws, in this order, the
    prefix noise ``pre_noise(i)``, each pin's ``pin_noise(i, pin_i)`` (B,
    2), and the step noise ``step_noise(i)`` (like x; multiplied by 0 at
    t = 0); a hook not given draws from ``generator``. ``tables``: the
    schedule's tables on x's device (``sched.on``), else moved there here.
    """
    tabs = tables if tables is not None else sched.on(noise.device)
    x, batch, T = noise, noise.shape[0], tabs.num_timesteps
    draw = _drawer(noise, generator)
    for i in range(T):
        t_scalar = T - 1 - i
        t = torch.full((batch,), t_scalar, dtype=torch.int64, device=x.device)
        if pre_seq is not None and pre_seq_len > 0:
            z = pre_noise(i) if pre_noise is not None else draw(pre_seq.shape)
            re_noised = q_sample(tabs, pre_seq, t, z)
            x = torch.cat([re_noised[..., :pre_seq_len, :], x[..., pre_seq_len:, :]], dim=-2)
        if transl_req is not None:
            x = x.clone()
            for pin_i, (frame_idx, tx, tz) in enumerate(transl_req):
                target = torch.tensor([tx, tz], dtype=x.dtype, device=x.device)
                z = pin_noise(i, pin_i) if pin_noise is not None else draw((batch, 2))
                x[:, frame_idx, 1:3] = q_sample(tabs, target.expand(batch, 2), t, z)
        eps = model(x, t).to(x.dtype)  # a bfloat16 model's ε joins the float32 state
        mean, log_var, _ = p_mean_variance(tabs, eps, x, t, mean_type, var_type, clip_denoised)
        if cond_fn is not None:
            mean = condition_mean(tabs, cond_fn, mean, torch.exp(log_var), x, t)
        z = step_noise(i) if step_noise is not None else draw(x.shape)
        x = mean + float(t_scalar != 0) * torch.exp(0.5 * log_var) * z
    return x


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


def ddim_sample_loop(sched: DiffusionSchedule, model: Denoiser, noise: torch.Tensor,
                     num_steps: int | None = None, model_aux=None, eta: float = 0.0,
                     clip_denoised: bool = False, generator: torch.Generator | None = None,
                     step_noise: Callable | None = None,
                     tables: DiffusionSchedule | None = None) -> torch.Tensor:
    """DDIM from the initial ``noise`` (B, ...) over ``num_steps`` of the
    stride grid.

    ``model(x, t)`` predicts eps for timesteps ``t`` (B,) int64; with
    ``model_aux`` (a list with one entry per step) it is called as
    ``model(x, t, model_aux[i])``. With eta = 0 and no clipping the update
    is the linear fast path; otherwise the general step, whose noise
    (σ·z, 0 at t = 0) is ``step_noise(i)`` or drawn from ``generator``;
    ``tables`` as in :func:`p_sample_loop`.
    """
    ts = ddim_timesteps(sched.num_timesteps, num_steps or sched.num_timesteps)
    x = noise
    batch = x.shape[0]
    if eta == 0.0 and not clip_denoised:
        c1, c2 = ddim_coefficients(sched, ts)
        for i, t_scalar in enumerate(ts):
            t = torch.full((batch,), int(t_scalar), dtype=torch.int64, device=x.device)
            eps = model(x, t) if model_aux is None else model(x, t, model_aux[i])
            x = float(c1[i]) * x + float(c2[i]) * eps.to(x.dtype)
        return x

    tabs = tables if tables is not None else sched.on(x.device)
    # index -1 (t_prev before 0) reads alpha_bar = 1
    ab_ext = torch.cat([tabs.alphas_cumprod, torch.ones_like(tabs.alphas_cumprod[:1])])
    ts_prev = np.append(ts[1:], -1)
    draw = _drawer(x, generator)
    for i, (t_scalar, t_prev) in enumerate(zip(ts, ts_prev)):
        t = torch.full((batch,), int(t_scalar), dtype=torch.int64, device=x.device)
        eps = model(x, t) if model_aux is None else model(x, t, model_aux[i])
        x0 = predict_xstart_from_eps(tabs, x, t, eps.to(x.dtype))
        if clip_denoised:
            x0 = x0.clamp(-1.0, 1.0)
        eps = predict_eps_from_xstart(tabs, x, t, x0)
        alpha_bar = _extract(tabs.alphas_cumprod, t, x.ndim)
        alpha_bar_prev = ab_ext[int(t_prev)].reshape((1,) * x.ndim)
        sigma = (eta * torch.sqrt((1 - alpha_bar_prev) / (1 - alpha_bar))
                 * torch.sqrt(1 - alpha_bar / alpha_bar_prev))
        mean = x0 * torch.sqrt(alpha_bar_prev) + torch.sqrt(1 - alpha_bar_prev - sigma ** 2) * eps
        z = step_noise(i) if step_noise is not None else draw(x.shape)
        x = mean + float(t_scalar != 0) * sigma * z
    return x


def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL between two diagonal Gaussians, in nats."""
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + ((mean1 - mean2) ** 2) * torch.exp(-logvar2))


def _approx_standard_normal_cdf(x):
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def discretized_gaussian_log_likelihood(x, means, log_scales):
    """Log-likelihood of a Gaussian discretized to [-1, 1] 8-bit bins."""
    centered_x = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = _approx_standard_normal_cdf(inv_stdv * (centered_x + 1.0 / 255.0))
    cdf_min = _approx_standard_normal_cdf(inv_stdv * (centered_x - 1.0 / 255.0))
    log_cdf_plus = torch.log(cdf_plus.clamp(min=1e-12))
    log_one_minus_cdf_min = torch.log((1.0 - cdf_min).clamp(min=1e-12))
    log_cdf_delta = torch.log((cdf_plus - cdf_min).clamp(min=1e-12))
    return torch.where(x < -0.999, log_cdf_plus,
                       torch.where(x > 0.999, log_one_minus_cdf_min, log_cdf_delta))


def _mean_bits(v: torch.Tensor) -> torch.Tensor:
    """Mean over every axis but the first, nats → bits."""
    return v.mean(dim=tuple(range(1, v.ndim))) / math.log(2.0)


def vb_terms_bpd(sched: DiffusionSchedule, model_output: torch.Tensor, x_start: torch.Tensor,
                 x_t: torch.Tensor, t: torch.Tensor, clip_denoised: bool = False):
    """The variational-bound term of timestep ``t`` (B,) in bits per
    dimension: the decoder NLL at t = 0, else KL(q(x_{t-1}|x_t, x_0) ‖
    p(x_{t-1}|x_t)). Returns (output (B,), pred_xstart)."""
    true_mean, _, true_log_var = q_posterior_mean_variance(sched, x_start, x_t, t)
    mean, log_var, pred_xstart = p_mean_variance(sched, model_output, x_t, t,
                                                 clip_denoised=clip_denoised)
    kl = _mean_bits(normal_kl(true_mean, true_log_var, mean, log_var))
    decoder_nll = _mean_bits(-discretized_gaussian_log_likelihood(x_start, mean, 0.5 * log_var))
    return torch.where(t == 0, decoder_nll, kl), pred_xstart


def prior_bpd(sched: DiffusionSchedule, x_start: torch.Tensor) -> torch.Tensor:
    """KL(q(x_T | x_0) ‖ N(0, I)) in bits per dimension, (B,)."""
    t = torch.full((x_start.shape[0],), sched.num_timesteps - 1, dtype=torch.int64,
                   device=x_start.device)
    mean = _extract(sched.sqrt_alphas_cumprod, t, x_start.ndim) * x_start
    log_var = _extract(sched.log_one_minus_alphas_cumprod, t, x_start.ndim)
    return _mean_bits(normal_kl(mean, log_var, torch.zeros_like(mean),
                                torch.zeros_like(log_var)))


def calc_bpd_loop(sched: DiffusionSchedule, model: Denoiser, x_start: torch.Tensor,
                  noise=None, generator: torch.Generator | None = None,
                  clip_denoised: bool = False, tables: DiffusionSchedule | None = None) -> dict:
    """The bound over every timestep, t = T − 1 down to 0, as JAX's scan
    runs it: step i noises x_0 to t = T − 1 − i with ``noise[i]`` (``noise``
    (T, *x_start.shape); drawn from ``generator`` when not given), calls ``model(x_t, t)`` once and takes its vb term and the
    MSE of the implied eps. Returns total_bpd (B,), prior_bpd (B,), vb (T,
    B) and mse (T, B). ``tables`` as in :func:`p_sample_loop`."""
    tabs = tables if tables is not None else sched.on(x_start.device)
    draw = _drawer(x_start, generator)
    batch, T = x_start.shape[0], tabs.num_timesteps
    vbs, mses = [], []
    for i in range(T):
        t = torch.full((batch,), T - 1 - i, dtype=torch.int64, device=x_start.device)
        z = draw(x_start.shape) if noise is None else noise[i]
        x_t = q_sample(tabs, x_start, t, z)
        out = model(x_t, t).to(x_start.dtype)
        vb, pred_xstart = vb_terms_bpd(tabs, out, x_start, x_t, t, clip_denoised)
        eps = predict_eps_from_xstart(tabs, x_t, t, pred_xstart)
        vbs.append(vb)
        mses.append(((eps - z) ** 2).mean(dim=tuple(range(1, z.ndim))))
    prior = prior_bpd(tabs, x_start)
    vb = torch.stack(vbs)
    return {"total_bpd": vb.sum(dim=0) + prior, "prior_bpd": prior, "vb": vb,
            "mse": torch.stack(mses)}
