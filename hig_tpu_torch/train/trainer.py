"""Sampling driver (counterpart of the sampling half of
``hig_tpu/train/trainer.py:402-562``).

Everything loop-invariant is hoisted out of the step loop: the text is
encoded once, each layer's text state is computed once (the KᵀV tensor of
the efficient model, the projected (k, v) pair of the quadratic one), and
every block's AdaLN (scale, shift) is computed for every step of the DDIM
grid in one batched pass. Unlike the JAX sampler, which turns the AdaLN hoist off
under ``fused_blocks``, the port hoists it for all four blocks and feeds the
fused-block kernel the hoisted (scale, shift): the function computed is the
same. Only DDIM with ``guidance_scale`` 1 is ported; training, DDPM, DPM++
and classifier-free guidance are still to be ported.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from hig_tpu_torch.diffusion import gaussian as g
from hig_tpu_torch.models.denoiser import BLOCKS
from hig_tpu_torch.models.embeddings import timestep_embedding
from hig_tpu_torch.models.interaction_model import InteractionModel


def eval_params(state: dict) -> dict:
    """Parameters to sample with: the EMA average when present, else the
    raw parameters (``state`` holds ``params`` and maybe ``ema_params``)."""
    ema = state.get("ema_params")
    return ema if ema is not None else state["params"]


@torch.no_grad()
def adaln_scale_shift_grid(model: InteractionModel, ts: np.ndarray, xf_proj: torch.Tensor):
    """Every StylizationBlock's (scale, shift) for every timestep in ``ts``.

    Returns a list over layers of {block: (scale, shift)}, each of shape
    (len(ts), B, 2, 1, D).
    """
    den = model.denoiser
    t = torch.as_tensor(np.ascontiguousarray(ts), device=xf_proj.device)
    h = timestep_embedding(t, den.latent_dim)
    temb = den.time_embed.fc2(F.silu(den.time_embed.fc1(h)))
    emb = temb[:, None, None, :] + xf_proj[None]  # (S, B, 2, E)
    return [
        {short: getattr(layer, full).proj_out.scale_shift(emb) for short, full in BLOCKS}
        for layer in den.layers
    ]


def make_sampler(model: InteractionModel, sched: g.DiffusionSchedule, T: int,
                 dim_pose: int, sampler: str = "ddim", ddim_steps: int = 50,
                 guidance_scale: float = 1.0) -> Callable:
    """Returns ``sample(tokens (B, 2, 77), lengths (B,), noise=None,
    generator=None) -> (B, 2, T, dim_pose)``.

    ``noise`` is the initial x_T; without it one is drawn from
    ``generator`` on the model's device.
    """
    if sampler != "ddim" or guidance_scale != 1.0:
        raise NotImplementedError(
            "hig_tpu_torch samples with DDIM and guidance_scale 1 only "
            f"(got sampler={sampler!r}, guidance_scale={guidance_scale})"
        )
    ts = g.ddim_timesteps(sched.num_timesteps, ddim_steps)

    @torch.no_grad()
    def sample(tokens, lengths, noise=None, generator=None):
        device = next(model.parameters()).device
        tokens = torch.as_tensor(tokens, device=device)
        lengths = torch.clamp(torch.as_tensor(lengths, device=device), max=T)
        B = tokens.shape[0]
        xf_proj, xf_out = model.encode_text(tokens)
        text_kv = model.text_kv(xf_out)
        grid = adaln_scale_shift_grid(model, ts, xf_proj)
        aux = [
            [{k: (s[i], sh[i]) for k, (s, sh) in layer.items()} for layer in grid]
            for i in range(len(ts))
        ]

        def denoiser(x, t, adaln):
            return model.denoise(x, t, lengths, xf_proj, text_kv=text_kv, adaln=adaln)

        shape = (B, 2, T, dim_pose)
        if noise is None:
            noise = torch.randn(shape, generator=generator, device=device)
        elif tuple(noise.shape) != shape:
            raise ValueError(f"noise has shape {tuple(noise.shape)}, expected {shape}")
        return g.ddim_sample_loop(sched, denoiser, noise.to(device, torch.float32),
                                  num_steps=ddim_steps, model_aux=aux)

    return sample
