"""Conditioning blocks shared by the denoiser (counterpart of
``hig_tpu/models/embeddings.py``): the cos-first sinusoidal timestep
embedding, its SiLU MLP, the AdaLN ``StylizationBlock`` gate and the length
mask. LayerNorms use flax's eps of 1e-6, not torch's 1e-5.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-6


def layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=LN_EPS)


def timestep_embedding(timesteps: torch.Tensor, dim: int, max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal embeddings, cos first: (...,) → (..., dim) float32."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half
    )
    args = timesteps.to(torch.float32)[..., None] * freqs
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[..., :1])], dim=-1)
    return emb


class TimeEmbedMLP(nn.Module):
    """latent_dim sinusoid → Linear → SiLU → Linear (time_embed_dim)."""

    def __init__(self, latent_dim: int, time_embed_dim: int):
        super().__init__()
        self.latent_dim = latent_dim
        self.fc1 = nn.Linear(latent_dim, time_embed_dim)
        self.fc2 = nn.Linear(time_embed_dim, time_embed_dim)

    def forward(self, timesteps: torch.Tensor) -> torch.Tensor:
        h = timestep_embedding(timesteps, self.latent_dim).to(self.fc1.weight.dtype)
        return self.fc2(F.silu(self.fc1(h)))


class StylizationBlock(nn.Module):
    """AdaLN gate: h ← out(SiLU(norm(h)·(1+scale)+shift)).

    :meth:`scale_shift` depends only on the conditioning, so a sampler with
    a known timestep grid evaluates it for every step up front and each step
    calls :meth:`from_scale_shift`.
    """

    def __init__(self, latent_dim: int, emb_dim: int):
        super().__init__()
        self.emb = nn.Linear(emb_dim, 2 * latent_dim)
        self.norm = layer_norm(latent_dim)
        self.out = nn.Linear(latent_dim, latent_dim)

    def scale_shift(self, emb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """emb (..., E) → (scale, shift), each (..., 1, latent_dim)."""
        emb_out = self.emb(F.silu(emb))[..., None, :]
        scale, shift = emb_out.chunk(2, dim=-1)
        return scale, shift

    def from_scale_shift(self, h, scale, shift):
        return self.out(F.silu(self.norm(h) * (1 + scale) + shift))

    def forward(self, h: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        return self.from_scale_shift(h, *self.scale_shift(emb))


def length_mask(lengths: torch.Tensor, T: int, dtype=torch.float32) -> torch.Tensor:
    """(B,) valid lengths → (B, T) 0/1 mask."""
    return (torch.arange(T, device=lengths.device) < lengths[..., None]).to(dtype)
