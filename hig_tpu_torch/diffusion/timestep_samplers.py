"""Timestep samplers for training (own copy of
``hig_tpu/diffusion/timestep_samplers.py:18-101``).

A sampler returns timesteps and their importance weights. The loss-aware
second-moment resampler keeps a fixed-shape history on the device: the last
``history_per_term`` per-sample losses of each timestep and how many it
holds. Each function that draws takes a ``torch.Generator`` and also accepts
the draw itself (``t=``), so a test can hand it the JAX package's draws.
"""

from __future__ import annotations

import dataclasses

import torch


def uniform_sample(batch: int, num_timesteps: int, generator=None, device=None,
                   t: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Uniform timesteps (the reference trainer's sampler) and weights of 1."""
    if t is None:
        t = torch.randint(0, num_timesteps, (batch,), generator=generator, device=device)
    return t, torch.ones((batch,), device=t.device)


@dataclasses.dataclass
class LossSecondMomentState:
    """History of the loss-aware resampler: ``losses`` (T, history) float32,
    each row the timestep's last losses left-aligned and zero-padded, and
    ``counts`` (T,) how many each row holds."""

    losses: torch.Tensor
    counts: torch.Tensor

    @classmethod
    def create(cls, num_timesteps: int, history_per_term: int = 10, device=None):
        return cls(losses=torch.zeros((num_timesteps, history_per_term), device=device),
                   counts=torch.zeros((num_timesteps,), dtype=torch.int64, device=device))


def loss_aware_weights(state: LossSecondMomentState, uniform_prob: float = 0.001) -> torch.Tensor:
    """Per-timestep sampling distribution ∝ sqrt(E[loss²]), mixed with
    ``uniform_prob`` of the uniform one; uniform until every row is full."""
    T, H = state.losses.shape
    w = state.losses.square().mean(dim=-1).sqrt()
    w = w / w.sum().clamp(min=1e-12)
    w = w * (1 - uniform_prob) + uniform_prob / T
    warmed = (state.counts == H).all()
    return torch.where(warmed, w, torch.full_like(w, 1.0 / T))


def loss_aware_sample(batch: int, state: LossSecondMomentState, generator=None,
                      t: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Timesteps drawn from :func:`loss_aware_weights` (or the given ``t``)
    and their importance weights 1 / (T · p[t])."""
    p = loss_aware_weights(state)
    if t is None:
        t = torch.multinomial(p, batch, replacement=True, generator=generator)
    return t, 1.0 / (p.shape[0] * p[t])


def loss_aware_update(state: LossSecondMomentState, t: torch.Tensor,
                      losses: torch.Tensor) -> LossSecondMomentState:
    """Fold a step's per-sample ``losses`` at timesteps ``t`` into the
    history, in batch order: a row appends until it is full, then shifts
    the oldest loss out. The JAX package folds one sample at a time; here
    every shape is fixed by the batch size (no ``unique``, nothing sized by
    the data, so a CUDA graph captures it): each sample rebuilds its
    timestep's row, the row's history followed by the batch's losses at
    that timestep in batch order, so samples that share a timestep build
    the same row and writing them all gives the rows of the sequential
    fold. Returns a new state; ``state`` is left as it was."""
    T, H = state.losses.shape
    B = t.shape[0]
    t = t.long()
    order = torch.arange(B, device=t.device)
    same = t[:, None] == t[None, :]  # (i, k): sample k's timestep is sample i's
    j = (same & (order[None, :] < order[:, None])).sum(dim=1)  # i's place among them
    count = state.counts[t]
    # row i: its history, then its timestep's new losses at count + j; the
    # other samples' losses land in a spare last column, dropped below
    ext = torch.zeros((B, H + B + 1), dtype=state.losses.dtype, device=state.losses.device)
    ext[:, :H] = state.losses[t]
    slot = torch.where(same, count[:, None] + j[None, :], H + B)
    ext.scatter_(1, slot, losses.detach().to(ext.dtype)[None, :].expand(B, B))
    total = count + same.sum(dim=1)
    start = (total - H).clamp(min=0)
    rows = ext.gather(1, start[:, None] + torch.arange(H, device=t.device))
    losses_out, counts_out = state.losses.clone(), state.counts.clone()
    losses_out[t] = rows
    counts_out[t] = total.clamp(max=H)
    return LossSecondMomentState(losses=losses_out, counts=counts_out)
