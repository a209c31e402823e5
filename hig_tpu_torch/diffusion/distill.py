"""Progressive distillation of the DDIM sampler (counterpart of
``hig_tpu/diffusion/distill.py``; Salimans & Ho, ICLR 2022).

Each stage trains a student, initialized from the teacher, so that one
student DDIM step from x_t reproduces two teacher DDIM steps, t → mid →
t_prev; the student then samples on ``ddim_timesteps(T, N)``, the grid the
production sampler uses at ``--ddim_steps N``, and teaches the next stage.

* :func:`distill_grids`: the student grid, each transition's target
  (t_prev = −1 is the final hop to x0, ᾱ = 1) and the teacher's midpoint,
  snapped to the teacher's own grid when its step count is given.
* :func:`distill_targets`: the teacher's two eta = 0 half-steps and the x0
  whose single student step lands on their endpoint, solved in closed form
  from the update's linearity, with the truncated-SNR weight max(SNR, 1).
* :func:`make_distill_loss`: the masked x-space loss of the student's x0
  against that target, sum(per_sample · weight) / (2 · sum(mask)), with the
  trainer's init-token and length conventions. A CFG teacher either
  distills both branches under one caption-dropout keep mask
  (``distill_w`` = 1) or, with ``distill_w`` = w ≠ 1, the guided blend
  ε_u + w·(ε_c − ε_u) in both half-steps, the student conditional only.
* :func:`make_distill_step`: the loss, gradients, clip and Adam of
  ``train.trainer.make_train_step`` (no EMA: JAX's step carries the EMA
  through unchanged), one CUDA graph per batch shape on the card.

The student is the train-mode model whose gradients the step takes: its
efficient blocks go through B2 (B4 under ``--no_eff``, the einsum route
through B3-bf16 in bfloat16). JAX differentiates the student's
deterministic apply, which under ``fused_blocks`` is the fused-block Pallas
call, whose JVP raises; a ``fused_blocks`` student is refused here likewise.
The teacher is a second model in eval mode, run under ``torch.no_grad``
(JAX's ``stop_gradient`` of the target): B1 when it is built ``fused``,
else B2. Its guided blend evaluates the conditional and the null pairs in
one denoiser call over 2B pairs, as the port's sampler does.

The step draws, in JAX's roles, the grid index ``i`` (B,), the ``noise``
and, for caption dropout, the ``keep`` mask (B,) from its generator, unless
they are handed in: a test feeds JAX's own draws.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from hig_tpu_torch.diffusion import gaussian as g
from hig_tpu_torch.models.embeddings import length_mask
from hig_tpu_torch.train.trainer import make_train_step, per_token_loss

DISTILL_METRICS = ("loss_distill", "grad_norm")
FUSED_STUDENT = (
    "the student's blocks are fused_blocks: the fused-block kernel (B1) has no backward, "
    "and JAX's distillation step cannot differentiate it either (its Pallas call's JVP "
    "raises); build the student unfused (train mode takes B2) and the teacher fused"
)


@dataclasses.dataclass(frozen=True)
class DistillGrids:
    """Per-student-step timesteps, each (N,) int64: ``ts`` the student's
    (descending) DDIM grid, ``ts_prev`` each transition's target (−1: x0),
    ``ts_mid`` the teacher's intermediate step."""

    ts: np.ndarray
    ts_prev: np.ndarray
    ts_mid: np.ndarray

    @property
    def num_steps(self) -> int:
        return len(self.ts)


def distill_grids(T: int, num_steps: int, teacher_steps: int | None = None) -> DistillGrids:
    """The nested grids of one stage. Every transition but the final 0 → −1
    hop must span ≥ 2 timesteps (else ``ValueError``); that hop's midpoint
    is clamped to t, an exact identity half-step. With ``teacher_steps``,
    each midpoint snaps to the nearest point of the teacher's own grid
    strictly inside its transition, so a distilled teacher is only queried
    where it was supervised (at the 2 → 1 rung, mid = 0)."""
    ts = g.ddim_timesteps(T, num_steps).astype(np.int64)
    ts_prev = np.append(ts[1:], -1).astype(np.int64)
    gaps = ts - ts_prev
    dense = (gaps < 2) & (ts != 0)
    if np.any(dense):
        raise ValueError(f"distill grid too dense: num_steps={num_steps} leaves a transition "
                         f"of {int(gaps[dense].min())} < 2 timesteps (T={T})")
    ts_mid = np.where(gaps >= 2, (ts + ts_prev) // 2, ts).astype(np.int64)
    if teacher_steps is not None:
        tgrid = g.ddim_timesteps(T, teacher_steps).astype(np.int64)
        for i in range(len(ts)):
            interior = tgrid[(tgrid < ts[i]) & (tgrid > ts_prev[i])]
            if len(interior):
                ts_mid[i] = interior[np.argmin(np.abs(interior - int(ts_mid[i])))]
    return DistillGrids(ts=ts, ts_prev=ts_prev, ts_mid=ts_mid)


def halving_stages(start_steps: int, min_steps: int = 4) -> list[int]:
    """The stage ladder: ceil-halve from ``start_steps`` down to
    ``min_steps`` (50 → 25 → 13 → 7 → 4)."""
    stages, n = [], start_steps
    while n > min_steps:
        n = (n + 1) // 2
        stages.append(n)
    return stages


def _ab_prev(sched: g.DiffusionSchedule, t_prev: torch.Tensor, ndim: int) -> torch.Tensor:
    """ᾱ at ``t_prev`` (B,), with −1 → 1 (the x0 state)."""
    ac = g._on_device(sched.alphas_cumprod, t_prev.device)
    ab_ext = torch.cat([ac, torch.ones_like(ac[:1])])
    idx = torch.where(t_prev < 0, torch.full_like(t_prev, sched.num_timesteps), t_prev)
    return g._extract(ab_ext, idx, ndim)


def ddim_step(sched: g.DiffusionSchedule, x: torch.Tensor, eps: torch.Tensor, t: torch.Tensor,
              t_prev: torch.Tensor) -> torch.Tensor:
    """One deterministic (eta = 0, unclipped) DDIM update with per-sample
    ``t`` and ``t_prev`` (B,); ``t_prev`` = −1 lands on x0."""
    eps = eps.to(x.dtype)
    x0 = g.predict_xstart_from_eps(sched, x, t, eps)
    abp = _ab_prev(sched, t_prev, x.ndim)
    return torch.sqrt(abp) * x0 + torch.sqrt(1.0 - abp) * eps


@torch.no_grad()
def distill_targets(sched: g.DiffusionSchedule, teacher: Callable, x_t: torch.Tensor,
                    t: torch.Tensor, t_mid: torch.Tensor, t_prev: torch.Tensor):
    """The teacher's two half-steps from ``x_t`` and the one-step target:
    (x0_target, weight (B,)), with ``frac`` = √(1 − ᾱ'')/√(1 − ᾱ),
    x0 = (x'' − frac·x_t) / (√ᾱ'' − frac·√ᾱ) and weight = max(SNR(t), 1)
    in float32 from the schedule's tables. ``teacher(x, t) -> eps``."""
    x_mid = ddim_step(sched, x_t, teacher(x_t, t), t, t_mid)
    x_pp = ddim_step(sched, x_mid, teacher(x_mid, t_mid), t_mid, t_prev)
    ab = g._extract(sched.alphas_cumprod, t, x_t.ndim)
    abp = _ab_prev(sched, t_prev, x_t.ndim)
    frac = torch.sqrt(1.0 - abp) / torch.sqrt(1.0 - ab)
    x0_target = (x_pp - frac * x_t) / (torch.sqrt(abp) - frac * torch.sqrt(ab))
    ac = g._on_device(sched.alphas_cumprod, t.device)[t]
    weight = torch.clamp(ac / (1.0 - ac), min=1.0)
    return x0_target, weight


def grid_tables(grids: DistillGrids, device) -> tuple[torch.Tensor, ...]:
    """(ts, ts_mid, ts_prev) as int64 tensors on ``device``."""
    return tuple(torch.as_tensor(np.ascontiguousarray(a), device=device)
                 for a in (grids.ts, grids.ts_mid, grids.ts_prev))


def make_distill_loss(student, teacher, sched: g.DiffusionSchedule, grids: DistillGrids,
                      distill_w: float = 1.0, tables: tuple | None = None) -> Callable:
    """``loss_fn(batch, generator=None, i=None, noise=None, keep=None,
    ts_state=None) -> (loss, aux)`` of JAX's ``make_distill_loss``.

    ``student`` and ``teacher`` are ``InteractionModel``s of one
    architecture; each encodes the conditioning with its own weights.
    batch: motion (B, 2, T, D), lengths (B,), and cap_ids, tokens with
    tower_feats, or tokens, as ``train.trainer.make_loss_fn`` reads them.
    ``i`` (B,) indexes the grid, ``noise`` is like motion, ``keep`` (B,)
    bool the pairs that keep their captions under a CFG teacher with
    ``distill_w`` = 1; each is drawn from ``generator`` (in that order)
    unless given. ``sched`` holds host or device tables; ``tables`` the
    grids' (:func:`grid_tables`), else copied per call. ``mask_total`` (a
    rank's share of a global batch) is the global batch's mask sum. aux
    holds t and the per-sample losses. ``ts_state`` is not read.
    """
    if student.cfg.fused_blocks:
        raise ValueError(FUSED_STUDENT)
    drop_prob = float(student.cfg.cond_drop_prob)
    distill_w = float(distill_w)
    if distill_w != 1.0 and drop_prob <= 0.0:
        raise ValueError(f"distill_w={distill_w} needs a CFG teacher (cond_drop_prob > 0): "
                         f"the guided blend queries the null branch")

    def encode(model, cond):
        if isinstance(cond, tuple):
            return model.encode_text_from_tower(*cond)
        return model.encode_text(cond)

    def loss_fn(batch, generator=None, i=None, noise=None, keep=None, ts_state=None,
                mask_total=None):
        motion = batch["motion"]
        B, _, T, _ = motion.shape
        device = motion.device
        lengths = batch["lengths"].clamp(max=T)
        mask = length_mask(lengths, T, motion.dtype)
        if "cap_ids" in batch:
            cond = batch["cap_ids"]
        elif "tower_feats" in batch:
            cond = (batch["tower_feats"], batch["tokens"])
        else:
            cond = batch["tokens"]
        ts, ts_mid, ts_prev = tables if tables is not None else grid_tables(grids, device)
        if i is None:
            i = torch.randint(0, grids.num_steps, (B,), generator=generator, device=device)
        t, t_mid, t_prev = ts[i], ts_mid[i], ts_prev[i]
        if noise is None:
            noise = torch.randn(motion.shape, generator=generator, device=device,
                                dtype=motion.dtype)
        x_t = g.q_sample(sched, motion, t, noise)

        with torch.no_grad():
            t_proj, t_out = encode(teacher, cond)
        s_proj, s_out = encode(student, cond)
        if distill_w != 1.0:
            # the teacher runs the guided trajectory: conditional and null
            # pairs in one call over 2B; the student sees conditional only
            n_proj, n_out = teacher.null_conditioning(B, t_out.shape[2])
            proj2, out2 = torch.cat([t_proj, n_proj]), torch.cat([t_out, n_out])
            lengths2 = torch.cat([lengths, lengths])

            def teacher_eps(x, tt):
                eps = teacher.denoise(torch.cat([x, x]), torch.cat([tt, tt]), lengths2,
                                      proj2, out2)
                e_c, e_u = eps[:B], eps[B:]
                return e_u + distill_w * (e_c - e_u)
        else:
            if drop_prob > 0.0:
                if keep is None:
                    keep = torch.rand((B,), generator=generator, device=device) >= drop_prob
                with torch.no_grad():
                    n_proj, n_out = teacher.null_conditioning(B, t_out.shape[2])
                    t_proj = torch.where(keep[:, None, None], t_proj, n_proj)
                    t_out = torch.where(keep[:, None, None, None], t_out, n_out)
                n_proj, n_out = student.null_conditioning(B, s_out.shape[2])
                s_proj = torch.where(keep[:, None, None], s_proj, n_proj)
                s_out = torch.where(keep[:, None, None, None], s_out, n_out)

            def teacher_eps(x, tt):
                return teacher.denoise(x, tt, lengths, t_proj, t_out)

        x0_target, weight = distill_targets(sched, teacher_eps, x_t, t, t_mid, t_prev)
        eps_hat = student.denoise(x_t, t, lengths, s_proj, s_out)
        x0_hat = g.predict_xstart_from_eps(sched, x_t, t, eps_hat)
        per_sample = (per_token_loss(x0_hat, x0_target) * mask[:, None, :]).sum(dim=(1, 2))
        total = mask.sum() if mask_total is None else mask_total
        loss = (per_sample * weight).sum() / (2.0 * total)
        return loss, {"t": t, "per_sample": per_sample}

    return loss_fn


def distill_draws(grids: DistillGrids, drop_prob: float, distill_w: float) -> Callable:
    """``draws(model, B, like, generator, ts_state) -> (i, noise, keep)`` of
    a global batch of B rows, in the loss's order (the grid index, the
    noise, and the keep mask where the loss draws one): what a one-rank
    step draws, for the ranks to keep their rows of."""
    def draws(model, B, like, generator, ts_state):
        device = like.device
        i = torch.randint(0, grids.num_steps, (B,), generator=generator, device=device)
        noise = torch.randn((B, *like.shape[1:]), generator=generator, device=device,
                            dtype=like.dtype)
        keep = None
        if drop_prob > 0.0 and distill_w == 1.0:
            keep = torch.rand((B,), generator=generator, device=device) >= drop_prob
        return i, noise, keep

    return draws


def make_distill_step(sched: g.DiffusionSchedule, grids: DistillGrids, teacher,
                      distill_w: float = 1.0, graph: bool = True, layout=None) -> Callable:
    """``step(state, batch, generator=None, i=None, noise=None, keep=None)
    -> {"loss_distill", "grad_norm"}``: :func:`make_distill_loss` of
    ``state.model`` (the student) against ``teacher``, its gradients, the
    clipped Adam update of ``state.optimizer``, no EMA. On the card with
    ``graph`` the whole step is one CUDA graph per batch shape
    (``train.trainer.make_train_step``'s replay rules). The graph reads the
    teacher's parameters, the grids and the optimizer's tensors where they
    lie when it is captured: a stage makes its own step (its grids and its
    fresh Adam moments are new tensors) and so captures anew, and the
    teacher module is updated in place between stages. ``step.graphs``
    holds the graphs by key. Over several ranks ``layout`` (the student's,
    ``parallel/layout.py``) shares the step as the train step's: each rank
    keeps its rows of the global batch's draws (:func:`distill_draws`), the
    teacher whole on every rank, and the step runs eagerly."""
    tables: dict = {}  # device → the grids there, made before any capture

    def make_loss(model, sched_on):
        return make_distill_loss(model, teacher, sched_on, grids, distill_w,
                                 tables[sched_on.betas.device])

    train_step = make_train_step(
        sched, pit=False, graph=graph, make_loss=make_loss, metric_names=DISTILL_METRICS,
        layout=layout, draws=distill_draws(grids, float(teacher.cfg.cond_drop_prob),
                                           float(distill_w)))

    def step(state, batch, generator=None, i=None, noise=None, keep=None):
        device = batch["motion"].device
        if device not in tables:
            tables[device] = grid_tables(grids, device)
        return train_step(state, batch, generator, t=i, noise=noise, keep=keep)

    step.graphs = train_step.graphs
    return step
