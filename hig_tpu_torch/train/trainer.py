"""Training runtime and the sampler (counterpart of
``hig_tpu/train/trainer.py``).

Training (``:52-394``, ``:639-1042``): the PIT min-assignment loss or, with a
label file, the supervised loss, on the epsilon target, conditioned on
caption tokens or (``cap_id``) caption ids; in the supervised stage,
optionally classifier-free-guidance caption dropout (``cond_drop_prob``);
timesteps uniform or from the loss-aware second-moment resampler; Adam
with optax's defaults behind a global-norm clip of the trainable partition
(the CLIP tower is frozen unless ``no_clip``), an optional warmup or
warmup+cosine schedule, gradient accumulation and an EMA of the
parameters; the epoch loop with ``metrics.jsonl``, checkpoints, resume,
rollback to ``latest`` on a non-finite loss, and the validation pass
(``eval_every_e``), over batches of the Python loader or, with
``use_native_loader``, of the native C++ one (``data/native_loader.py``,
``window_size`` frames). As in the JAX package, the PIT duplication is an
explicit assignment axis (the noised motions repeated, the captions flipped
on the actor axis) and the frozen CLIP tower runs once per run, over the 43
captions, instead of in every step. The model trains in train mode, where
its self-attention and interaction blocks go through kernel B2 (or B4 in
the ``--no_eff`` model), whose backwards recompute their plain versions. A
bfloat16 model (``compute_dtype``, with ``fast_ln`` or ``rms_norm``) trains
as JAX's mixed precision does: float32 parameters, Adam moments, EMA and
checkpoints, every module computing in bfloat16 from them; the efficient
blocks take JAX's einsum route through B3-bf16 (or the quadratic ones
B4-bf16), and the loss of the bfloat16 prediction against the float32
target is taken in float32. As JAX jits and donates its train step, the
port captures the whole step on the card (loss, backward, the
``grad_accum`` loop, clip, Adam, EMA, the loss-aware history) as one CUDA
graph per batch shape and replays it (``make_train_step``'s ``graph``);
the loop reads the step's two metrics back once a step, as JAX does.

The single-person model trains with :func:`make_single_train_step` (the
masked MSE over (B, T, D), the same optimizer and graphs) and samples with
:func:`make_single_sampler` (``python -m hig_tpu_torch.train_single``).

Sampling (``:402-562``), with DDPM, DDIM or DPM-Solver++(2M): everything
loop-invariant is hoisted out of the step loop: the text is encoded once,
each layer's text state is computed once (the KᵀV tensor of the efficient
model, the projected (k, v) pair of the quadratic one), and, for DDIM and
DPM, every block's AdaLN (scale, shift) is computed for every step of the
grid in one batched pass. Unlike the JAX sampler, which turns the AdaLN
hoist off under ``fused_blocks``, the port hoists it for all four blocks
and feeds the fused-block kernel the hoisted (scale, shift): the function
computed is the same. DDPM hoists no AdaLN grid, as in JAX. With
``guidance_scale`` w ≠ 1 (classifier-free guidance) each step evaluates
the conditional and the null conditioning in one denoiser call over 2B
pairs, where the JAX sampler makes two calls of B pairs. As JAX jits its
sampler, the port captures a whole sampling call on the card as one CUDA
graph per shape and replays it (``make_sampler``'s ``graph``).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from os.path import join as pjoin
from typing import Callable

import numpy as np
import torch

from hig_tpu_torch import resolve_device
from hig_tpu_torch.config import (
    CFG_UNDER_PIT,
    SAMPLERS,
    ExperimentConfig,
    model_config,
)
from hig_tpu_torch.data.dataset import PairDataset, collate, epoch_batches
from hig_tpu_torch.data.native_loader import store_from_dataset
from hig_tpu_torch.data.vocab import CAPS
from hig_tpu_torch.diffusion import gaussian as g
from hig_tpu_torch.diffusion import timestep_samplers as tss
from hig_tpu_torch.diffusion.solvers import dpmpp_2m_sample_loop
from hig_tpu_torch.models import attention
from hig_tpu_torch.models.denoiser import BLOCKS, actor_mean
from hig_tpu_torch.models.embeddings import length_mask
from hig_tpu_torch.models.interaction_model import InteractionModel
from hig_tpu_torch.models.text_encoder import ClipTextConfig
from hig_tpu_torch.models.tokenizer import tokenize
from hig_tpu_torch.parallel import distributed as dist
from hig_tpu_torch.parallel.layout import TrainLayout
from hig_tpu_torch.parallel.mesh import make_mesh, shard_batch
from hig_tpu_torch.train import checkpoint as ckpt
from hig_tpu_torch.utils.graphs import GraphedCall
from hig_tpu_torch.utils.profiling import DeviceTrace, StepTimer
from hig_tpu_torch.weights import (
    cast_floating,
    load_flax_tree,
    random_flax_tree,
    reduce_bf16_in_float32,
)

MAX_FAILURE_RETRIES = 2  # rollbacks a run may take before a non-finite loss raises
VAL_MAX_BATCHES = 8  # validation batches per pass


@dataclasses.dataclass
class TrainState:
    """The model (its parameters), the optimizer (Adam's moments), the
    optimizer steps taken, and the EMA of the parameters (None when the run
    keeps none), keyed by parameter name."""

    model: InteractionModel
    optimizer: "Optimizer"
    step: int = 0
    ema: dict[str, torch.Tensor] | None = None


def param_labels(model: InteractionModel, freeze_clip: bool = True) -> dict[str, str]:
    """"freeze" for the CLIP tower's parameters, "train" for the rest; with
    ``freeze_clip=False`` (``--no_clip``) everything trains."""
    frozen = model.clip_parameters() if freeze_clip else set()
    return {name: "freeze" if name in frozen else "train"
            for name, _ in model.named_parameters()}


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    if steps <= 0:
        return lambda count: init
    return lambda count: (init - end) * (1 - min(max(count, 0), steps) / steps) + end


def lr_schedule(cfg: ExperimentConfig) -> Callable[[int], float]:
    """The learning rate at each optimizer step count (0 for the first step),
    as optax's schedules give it: constant (the reference), with a linear
    warmup from 0 over ``warmup_steps``, or warmup then cosine decay to 0
    at ``lr_decay_steps`` (``--lr_schedule cosine``)."""
    warmup = cfg.warmup_steps
    if cfg.lr_schedule == "cosine":
        if cfg.lr_decay_steps <= 0:
            raise ValueError("--lr_schedule cosine requires --lr_decay_steps > 0")
        decay = cfg.lr_decay_steps - warmup
        if decay <= 0:
            raise ValueError(f"--lr_decay_steps ({cfg.lr_decay_steps}) must exceed "
                             f"--warmup_steps ({warmup})")

        def after(count):
            return cfg.lr * 0.5 * (1 + math.cos(math.pi * min(count, decay) / decay))
    elif cfg.lr_schedule == "constant":
        if warmup <= 0:
            return lambda count: cfg.lr

        def after(count):
            return cfg.lr
    else:
        raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")
    ramp = _linear(0.0, cfg.lr, warmup)
    return lambda count: ramp(count) if count < warmup else after(count - warmup)


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (a 0-dim tensor)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


class Optimizer:
    """optax's ``chain(clip_by_global_norm(grad_clip), adam(schedule))`` on
    the trainable parameters; the frozen ones are left out, as
    ``multi_transform`` sets their updates to zero. The clip's norm is over
    the trainable gradients only. Adam keeps optax's defaults (b1 0.9, b2
    0.999, eps 1e-8).

    Adam is written in ``torch._foreach_*`` ops over device tensors, the
    same code on the CPU and the card: the moments (``exp_avg``,
    ``exp_avg_sq``) and two 0-dim tensors that :meth:`prepare` fills from
    the host before each update, −lr / (1 − b1ⁿ) and √(1 − b2ⁿ) of update
    n. :meth:`update` reads no host value, so one CUDA graph of it serves
    every step count. The state dict has ``torch.optim.Adam``'s layout, so
    checkpoints of either load."""

    BETAS, EPS = (0.9, 0.999), 1e-8

    def __init__(self, params: list[torch.nn.Parameter], lr: Callable[[int], float],
                 grad_clip: float):
        self.params = params
        self.lr = lr
        self.grad_clip = grad_clip
        # the clip's norm of the gradients: the global one over several
        # ranks (parallel/layout.py)
        self.norm = global_norm
        self.exp_avg = [torch.zeros_like(p) for p in params]
        self.exp_avg_sq = [torch.zeros_like(p) for p in params]
        device = params[0].device if params else None
        self.step_size = torch.zeros((), device=device)
        self.bias_correction2_sqrt = torch.ones((), device=device)
        self.count = 0  # updates prepared

    def prepare(self, count: int) -> None:
        """Fill the device scalars of the update at optimizer step ``count``
        (0 for the first): the host's only part of a step."""
        n = count + 1
        b1, b2 = self.BETAS
        self.step_size.fill_(-self.lr(count) / (1 - b1 ** n))
        self.bias_correction2_sqrt.fill_(math.sqrt(1 - b2 ** n))
        self.count = n

    @torch.no_grad()
    def update(self) -> None:
        """One update from the parameters' ``.grad`` (clipped in place) at
        the prepared step count; a trainable parameter without a gradient
        counts as 0."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        norm = self.norm(grads)
        scale = torch.where(norm < self.grad_clip, torch.ones_like(norm),
                            self.grad_clip / norm)
        torch._foreach_mul_(grads, scale)
        b1, b2 = self.BETAS
        torch._foreach_lerp_(self.exp_avg, grads, 1 - b1)
        torch._foreach_mul_(self.exp_avg_sq, b2)
        torch._foreach_addcmul_(self.exp_avg_sq, grads, grads, value=1 - b2)
        # p += step_size · m / (√v / √(1 − b2ⁿ) + eps), with one temporary
        denom = torch._foreach_sqrt(self.exp_avg_sq)
        torch._foreach_div_(denom, self.bias_correction2_sqrt)
        torch._foreach_add_(denom, self.EPS)
        torch._foreach_div_(denom, self.step_size)
        torch._foreach_addcdiv_(self.params, self.exp_avg, denom)

    def step(self, count: int) -> None:
        """:meth:`prepare` then :meth:`update`."""
        self.prepare(count)
        self.update()

    def state_dict(self) -> dict:
        """``torch.optim.Adam``'s layout: per parameter index its step count
        and moments (CPU copies), and the hyperparameters."""
        state = {i: {"step": torch.tensor(float(self.count)), "exp_avg": m.detach().cpu(),
                     "exp_avg_sq": v.detach().cpu()}
                 for i, (m, v) in enumerate(zip(self.exp_avg, self.exp_avg_sq))} \
            if self.count else {}
        return {"state": state, "param_groups": [{
            "lr": self.lr(max(self.count - 1, 0)), "betas": self.BETAS, "eps": self.EPS,
            "weight_decay": 0, "amsgrad": False, "maximize": False,
            "params": list(range(len(self.params)))}]}

    def load_state_dict(self, state: dict) -> None:
        """Copy a state dict's moments and step count in place (a graph
        replays on these tensors); a parameter without state starts from
        zero moments, as Adam does."""
        if len(state["param_groups"][0]["params"]) != len(self.params):
            raise ValueError(f"the optimizer state holds "
                             f"{len(state['param_groups'][0]['params'])} parameters, this "
                             f"optimizer {len(self.params)}")
        self.count = 0
        for i, (m, v) in enumerate(zip(self.exp_avg, self.exp_avg_sq)):
            entry = state["state"].get(i)
            if entry is None:
                m.zero_()
                v.zero_()
                continue
            m.copy_(entry["exp_avg"])
            v.copy_(entry["exp_avg_sq"])
            self.count = int(entry["step"])


def make_optimizer(cfg: ExperimentConfig, model: InteractionModel) -> Optimizer:
    """Adam + global-norm clip (ref: lr 2e-4, clip 0.5) over the trainable
    partition of :func:`param_labels`; the CLIP tower is marked frozen
    unless ``no_clip``."""
    if not cfg.no_clip:
        model.freeze_clip()
    labels = param_labels(model, freeze_clip=not cfg.no_clip)
    params = [p for name, p in model.named_parameters() if labels[name] == "train"]
    return Optimizer(params, lr_schedule(cfg), cfg.grad_clip)


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------


def per_token_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """(N, 2, T, D) → per-token squared error (N, 2, T); the init token on
    channels 0:4 only. A bfloat16 prediction against the float32 target
    promotes to float32, as JAX's difference does."""
    init = ((pred[:, :, 0, :4] - target[:, :, 0, :4]) ** 2).mean(dim=-1)
    move = ((pred[:, :, 1:] - target[:, :, 1:]) ** 2).mean(dim=-1)
    return torch.cat([init[:, :, None], move], dim=-1)


def _weighted(per_sample, mask, sample_weights, mask_total=None):
    w = per_sample if sample_weights is None else per_sample * sample_weights
    return w.sum() / (2.0 * (mask.sum() if mask_total is None else mask_total))


def supervised_loss(pred, target, mask, sample_weights=None, mask_total=None):
    """Masked MSE with known roles; mask (N, T); ``sample_weights`` (N,)
    importance-weight each pair (the loss-aware sampler); ``mask_total``
    the global batch's mask sum when these rows are a rank's share (their
    loss is then the share of the global loss). Returns (loss, per-sample
    summed losses)."""
    per_sample = (per_token_loss(pred, target) * mask[:, None, :]).sum(dim=(1, 2))
    return _weighted(per_sample, mask, sample_weights, mask_total), per_sample


def pit_loss(pred, target, mask, sample_weights=None, mask_total=None):
    """Min-assignment PIT loss: pred/target (B, 2 assignments, 2 actors, T,
    D), mask (B, T). Per assignment the masked loss summed over both actors,
    per pair the smaller of the two assignments, normalized by 2·Σmask;
    ``sample_weights`` and ``mask_total`` as in :func:`supervised_loss`.
    Returns (loss, per-pair losses)."""
    B = pred.shape[0]
    per_tok = per_token_loss(pred.reshape(B * 2, *pred.shape[2:]),
                             target.reshape(B * 2, *target.shape[2:]))
    mask2 = mask.repeat_interleave(2, dim=0)[:, None, :]
    per_sample = (per_tok * mask2).sum(dim=(1, 2)).reshape(B, 2).min(dim=1).values
    return _weighted(per_sample, mask, sample_weights, mask_total), per_sample


# --------------------------------------------------------------------------
# train steps
# --------------------------------------------------------------------------


def make_loss_fn(model: InteractionModel, sched: g.DiffusionSchedule, pit: bool,
                 loss_aware: bool = False) -> Callable:
    """``loss_fn(batch, generator=None, t=None, noise=None, keep=None,
    ts_state=None, mask_total=None) -> (loss, aux)``. ``sched`` holds host
    tables (copied to the device per call) or the device's own
    (:meth:`DiffusionSchedule.on`).

    batch: motion (B, 2, T, D), lengths (B,), and the conditioning: cap_ids
    (B, 2) for a ``cap_id`` model, else tokens (B, 2, 77) and, when the
    frozen tower was precomputed, tower_feats (B, 2, 77, W); without them
    the tower runs in the step (``--no_clip``). ``t`` (B,) and ``noise``
    (like motion) are drawn from ``generator`` unless given; with
    ``loss_aware`` t comes from the resampler's history ``ts_state`` and the
    loss is importance-weighted. When the model has ``cond_drop_prob`` > 0
    (supervised stage only), ``keep`` (B,) bool says which pairs keep their
    captions; the others, both actors together, take the null conditioning.
    It is drawn from ``generator`` after t and noise unless given. With
    ``mask_total`` (a rank's share of a global batch: the global mask sum)
    the loss is the rows' share of the global loss. aux holds t and the
    per-sample losses.
    """
    drop_prob = model.cfg.cond_drop_prob
    if pit and drop_prob > 0.0:
        raise ValueError(CFG_UNDER_PIT)

    def encode(cond):
        if isinstance(cond, tuple):
            return model.encode_text_from_tower(*cond)
        return model.encode_text(cond)

    def loss_fn(batch, generator=None, t=None, noise=None, keep=None, ts_state=None,
                mask_total=None):
        motion = batch["motion"]
        B, _, T, _ = motion.shape
        lengths = batch["lengths"].clamp(max=T)
        weights = None
        if loss_aware:
            t, weights = tss.loss_aware_sample(B, ts_state, generator, t)
        else:
            t, _ = tss.uniform_sample(B, sched.num_timesteps, generator, motion.device, t)
        if noise is None:
            noise = torch.randn(motion.shape, generator=generator, device=motion.device,
                                dtype=motion.dtype)
        x_t, target = g.training_targets(sched, motion, t, noise)
        mask = length_mask(lengths, T, motion.dtype)
        if "cap_ids" in batch:
            cond = batch["cap_ids"]
        elif "tower_feats" in batch:
            cond = (batch["tower_feats"], batch["tokens"])
        else:
            cond = batch["tokens"]
        if not pit:
            xf_proj, xf_out = encode(cond)
            if drop_prob > 0.0:
                if keep is None:
                    u = torch.rand((B,), generator=generator, device=motion.device)
                    keep = u >= drop_prob
                n_proj, n_out = model.null_conditioning(B, xf_out.shape[2])
                xf_proj = torch.where(keep[:, None, None], xf_proj, n_proj)
                xf_out = torch.where(keep[:, None, None, None], xf_out, n_out)
            pred = model.denoise(x_t, t, lengths, xf_proj, xf_out)
            loss, per_sample = supervised_loss(pred, target, mask, weights, mask_total)
        else:
            # assignment axis: (c1, c2) as given, then (c2, c1), encoded in
            # one pass and denoised over 2B pairs
            if isinstance(cond, tuple):
                cond = tuple(torch.cat([c, c.flip(1)]) for c in cond)
            else:
                cond = torch.cat([cond, cond.flip(1)])
            xf_proj, xf_out = encode(cond)
            pred2 = model.denoise(torch.cat([x_t, x_t]), torch.cat([t, t]),
                                  torch.cat([lengths, lengths]), xf_proj, xf_out)
            pred = torch.stack([pred2[:B], pred2[B:]], dim=1)
            loss, per_sample = pit_loss(pred, torch.stack([target, target], dim=1), mask,
                                        weights, mask_total)
        return loss, {"t": t, "per_sample": per_sample}

    return loss_fn


def compute_grads(model: InteractionModel, loss_fn: Callable, batch: dict, grad_accum: int = 1,
                  generator=None, t=None, noise=None, keep=None,
                  ts_state=None, mask_totals=None) -> tuple[torch.Tensor, dict]:
    """Write into each trainable parameter's ``.grad`` the mean of its
    gradient over ``grad_accum`` equal microbatches (activation memory of
    one), and return the mean loss and the aux of every microbatch (t and
    per-sample losses, concatenated in batch order). The gradients keep
    their storage: a parameter's first step makes it, each step zeroes it
    in place and accumulates into it, so a CUDA graph of the step replays
    into the tensors ``.grad`` holds. Each microbatch draws its own t,
    noise and keep from ``generator``, or takes its slice of ``t``,
    ``noise`` and ``keep``; ``mask_totals`` (one a microbatch) are the
    global batch's mask sums when the batch is a rank's share."""
    params = [p for p in model.parameters() if p.requires_grad]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    torch._foreach_zero_(grads)
    size = batch["motion"].shape[0] // grad_accum
    total = torch.zeros((), device=batch["motion"].device)
    auxs = []

    def part_of(x, part):
        return None if x is None else x[part]

    for i in range(grad_accum):
        part = slice(i * size, (i + 1) * size)
        micro = {key: value[part] for key, value in batch.items()}
        shared = {} if mask_totals is None else {"mask_total": mask_totals[i]}
        loss, aux = loss_fn(micro, generator, part_of(t, part), part_of(noise, part),
                            part_of(keep, part), ts_state, **shared)
        loss.backward()
        total = total + loss.detach()
        auxs.append({k: v.detach() for k, v in aux.items()})
    if grad_accum > 1:
        torch._foreach_div_(grads, float(grad_accum))
    return total / grad_accum, {k: torch.cat([a[k] for a in auxs]) for k in auxs[0]}


@torch.no_grad()
def update_ema(state: TrainState, ema_decay: float, masters: list | None = None) -> None:
    """e ← e·decay + (1 − decay)·p over every parameter, in place; ``masters``
    are the tensors averaged in the EMA's order (FSDP's shards), by default
    the model's parameters."""
    if ema_decay > 0.0 and state.ema is not None:
        ema = list(state.ema.values())
        if masters is None:
            masters = [p for _, p in state.model.named_parameters()]
        torch._foreach_mul_(ema, ema_decay)
        torch._foreach_add_(ema, [p.detach() for p in masters], alpha=1.0 - ema_decay)


def apply_update(state: TrainState, ema_decay: float = 0.0) -> None:
    """One optimizer update from the parameters' ``.grad``, then the EMA
    (:func:`update_ema`)."""
    state.optimizer.step(state.step)
    update_ema(state, ema_decay)
    state.step += 1


TRAIN_METRICS = ("loss_mot_rec", "grad_norm")


def global_draws(B: int, like: torch.Tensor, sched, generator, loss_aware: bool,
                 ts_state=None, drop_prob: float = 0.0):
    """t (B,), noise (B, ...like's trailing shape) and, with ``drop_prob``,
    the caption-keep mask (B,) of a global batch of B rows, drawn from
    ``generator`` in the order the loss draws them: what a one-rank step
    draws, for the ranks to keep their rows of."""
    device = like.device
    if loss_aware:
        t, _ = tss.loss_aware_sample(B, ts_state, generator)
    else:
        t, _ = tss.uniform_sample(B, sched.num_timesteps, generator, device)
    noise = torch.randn((B, *like.shape[1:]), generator=generator, device=device,
                        dtype=like.dtype)
    keep = None
    if drop_prob > 0.0:
        keep = torch.rand((B,), generator=generator, device=device) >= drop_prob
    return t, noise, keep


def graph_key(*parts) -> tuple:
    """A CUDA graph's cache key: ``parts`` (the call's shapes and dtypes)
    and the model flags a capture bakes in
    (:data:`~hig_tpu_torch.models.attention.LAZY_KNORM`)."""
    return (*parts, attention.LAZY_KNORM)


def make_train_step(sched: g.DiffusionSchedule, pit: bool, grad_accum: int = 1,
                    ema_decay: float = 0.0, loss_aware: bool = False,
                    graph: bool = True, make_loss: Callable | None = None,
                    metric_names: tuple = TRAIN_METRICS, layout=None,
                    draws: Callable | None = None) -> Callable:
    """``train_step(state, batch, generator=None, t=None, noise=None,
    keep=None) -> metrics``: the loss (``make_loss(model, sched)``, default
    :func:`make_loss_fn` with ``pit`` and ``loss_aware``), gradients
    (:func:`compute_grads`), the
    optimizer update, the EMA, and the loss and the gradient norm under
    ``metric_names`` (default :data:`TRAIN_METRICS`) as 0-dim tensors
    (views of one (2,) tensor, read back in one copy); the logged norm is
    over every gradient, before the clip. With ``loss_aware``: ``train_step(state, batch, generator,
    ..., ts_state=) -> (metrics, ts_state)``, a new history with the step's
    t and per-sample losses (every microbatch's) folded in.

    On a CUDA batch with ``graph`` (the default) the whole step is one CUDA
    graph per key: the inputs' names, shapes and dtypes (the batch, which
    carries the conditioning: tokens with tower features, tokens alone or
    caption ids; t, noise and keep where given; the history): the
    counterpart of JAX's jitted, donated step. A key's first call runs the
    step eagerly on the capture stream, as the real step (the trajectory
    is the eager one), then captures it (``hig_tpu_torch.utils.graphs``);
    later calls copy their inputs into the graph's buffers and replay. A
    replay draws t, noise and keep from the caller's ``generator`` state
    (required) and hands the advanced state back; the host only fills the
    optimizer's step scalars (:meth:`Optimizer.prepare`) before it and
    counts the step after. The graphs replay on the TrainState they
    captured (its parameters, gradients, moments and EMA, updated in
    place; restore a checkpoint into it in place); another state raises. A
    capture that fails raises. ``graph=False``, and any CPU batch, run the
    eager step. ``train_step.graphs`` holds the graphs by key.

    ``layout`` (``parallel/layout.py``; default the one-rank layout, whose
    collectives are the identity) says how the ranks share the step. Over
    several ranks the batch is this rank's rows of the global batch: the
    step draws the global batch's t, noise and keep from ``generator``
    (unless given) and keeps its rows, normalizes each microbatch's loss by
    the global mask, sums the ranks' gradient shares (and gathers or
    reduce-scatters FSDP's shards), clips by the global norm, and folds
    every rank's (t, loss) into the loss-aware history: an R-rank step is
    the one-rank step at the same global batch, up to the order of sums.
    ``draws(model, B, like, generator, ts_state) -> (t, noise, keep)`` draws
    a global batch's B rows in the loss's order (default
    :func:`global_draws` with the model's caption dropout). It runs
    eagerly: gloo's collectives are host calls a CUDA graph cannot capture,
    and a capture of NCCL's is not checked without several cards.

    The graphs are keyed on the flags a capture bakes in too
    (:func:`graph_key`).
    """
    layout = layout if layout is not None else TrainLayout.one_rank()
    if layout.ranks > 1:
        graph = False
    if make_loss is None:
        def make_loss(model, sched):
            return make_loss_fn(model, sched, pit, loss_aware)
    if draws is None:
        def draws(model, B, like, generator, ts_state):
            drop = model.cfg.cond_drop_prob if not pit else 0.0
            return global_draws(B, like, sched, generator, loss_aware, ts_state, drop)
    tables: dict = {}  # device → the schedule's tables there, made at the first step
    graphs: dict = {}
    captured: dict = {}  # the TrainState the graphs replay on, and what they share

    def run(state, generator, t=None, noise=None, keep=None, ts_losses=None, ts_counts=None,
            **batch):
        """The step's device work: no host value is read, nothing is copied
        from the host."""
        model = state.model
        loss_fn = make_loss(model, tables[batch["motion"].device])
        ts_state = None
        if loss_aware:
            ts_state = tss.LossSecondMomentState(losses=ts_losses, counts=ts_counts)
        layout.gather_params(state)
        totals = None  # one batch rank: each microbatch's own mask sum
        if layout.batch_count > 1:
            T = batch["motion"].shape[-2]
            lengths = batch["lengths"].clamp(max=T).reshape(grad_accum, -1)
            totals = layout.global_sum(torch.stack(
                [length_mask(part, T, batch["motion"].dtype).sum() for part in lengths]))
        loss, aux = compute_grads(model, loss_fn, batch, grad_accum, generator, t, noise,
                                  keep, ts_state, mask_totals=totals)
        layout.reduce_grads(state)
        loss = layout.global_sum(loss)
        gnorm = layout.grad_norm(layout.grads(state))
        aux = {k: layout.gather_rows(v) for k, v in aux.items()}
        state.optimizer.update()
        update_ema(state, ema_decay, layout.masters(state))
        metrics = torch.stack([loss, gnorm])
        if loss_aware:
            new = tss.loss_aware_update(ts_state, aux["t"], aux["per_sample"])
            return metrics, new.losses, new.counts
        return metrics

    def replay(state, inputs, generator):
        if generator is None:
            raise ValueError("the graphed train step draws t, noise and keep from a "
                             "torch.Generator: pass generator= (or make the step with "
                             "graph=False)")
        bound = (state.model, state.optimizer, state.ema)
        if not captured:
            device = inputs["motion"].device
            captured.update(bound=bound, pool=torch.cuda.graph_pool_handle(),
                            stream=torch.cuda.Stream(device),
                            rng=torch.Generator(device=device))
        elif any(a is not b for a, b in zip(bound, captured["bound"])):
            raise ValueError("a graphed train step replays on the TrainState it captured; "
                             "make another step for another state")
        key = graph_key(tuple((name, tuple(x.shape), x.dtype)
                              for name, x in sorted(inputs.items())))
        if key not in graphs:
            rng = captured["rng"]
            graphs[key] = GraphedCall(lambda **i: run(state, rng, **i), inputs,
                                      captured["pool"], captured["stream"],
                                      warmup=lambda **i: run(state, generator, **i),
                                      generator=rng)
            return graphs[key].warmup_output
        return graphs[key](generator, **inputs)

    def train_step(state: TrainState, batch: dict, generator=None, t=None, noise=None,
                   keep=None, ts_state=None):
        device = batch["motion"].device
        if device not in tables:
            tables[device] = sched.on(device)
        inputs = dict(batch)
        if layout.batch_count > 1 and t is None:
            # the global batch's draws, this rank's rows kept
            i, n = layout.batch_index, layout.batch_count
            drawn = draws(state.model, batch["motion"].shape[0] * n, batch["motion"], generator,
                          ts_state)
            t, noise, keep = (None if x is None else shard_batch(x, i, n) for x in drawn)
        for name, x in (("t", t), ("noise", noise), ("keep", keep)):
            if x is not None:
                inputs[name] = x
        if loss_aware:
            inputs.update(ts_losses=ts_state.losses, ts_counts=ts_state.counts)
        # Adam's own count (optax's): the step count, except after
        # add_cfg_branch, whose fresh Adam restarts it while the step is kept
        state.optimizer.prepare(state.optimizer.count)
        if graph and device.type == "cuda":
            out = replay(state, inputs, generator)
        else:
            out = run(state, generator, **inputs)
        state.step += 1
        values = out[0] if loss_aware else out
        metrics = dict(zip(metric_names, values))
        if loss_aware:
            return metrics, tss.LossSecondMomentState(losses=out[1], counts=out[2])
        return metrics

    train_step.graphs = graphs
    return train_step


def make_single_loss_fn(model, sched: g.DiffusionSchedule) -> Callable:
    """The single-person model's loss (``make_single_train_step`` of
    ``hig_tpu/train/trainer.py:572-600``): ``loss_fn(batch, generator=None,
    t=None, noise=None, keep=None, ts_state=None) -> (loss, aux)``, the
    masked MSE of the epsilon prediction over (B, T, D), each valid frame's
    squared error averaged over the features. batch: motion (B, T, D),
    lengths (B,), tokens (B, 77) (the frozen CLIP tower runs in the step,
    as in JAX). ``t`` (B,) and ``noise`` (like motion) are drawn from
    ``generator`` unless given; ``keep`` and ``ts_state`` are not read;
    ``mask_total`` as in :func:`make_loss_fn`. aux holds t."""

    def loss_fn(batch, generator=None, t=None, noise=None, keep=None, ts_state=None,
                mask_total=None):
        motion = batch["motion"]
        B, T, _ = motion.shape
        lengths = batch["lengths"].clamp(max=T)
        t, _ = tss.uniform_sample(B, sched.num_timesteps, generator, motion.device, t)
        if noise is None:
            noise = torch.randn(motion.shape, generator=generator, device=motion.device,
                                dtype=motion.dtype)
        x_t, target = g.training_targets(sched, motion, t, noise)
        mask = length_mask(lengths, T, motion.dtype)
        pred = model(x_t, t, lengths, batch["tokens"])
        per_tok = ((pred - target) ** 2).mean(dim=-1)
        total = mask.sum() if mask_total is None else mask_total
        return (per_tok * mask).sum() / total, {"t": t}

    return loss_fn


def make_single_train_step(sched: g.DiffusionSchedule, graph: bool = True,
                           layout=None) -> Callable:
    """The single-person model's train step: :func:`make_train_step` (the
    optimizer update, metrics, one CUDA graph per batch shape on the card)
    over :func:`make_single_loss_fn`; over several ranks ``layout``
    (``TrainLayout.data_parallel``: JAX's ``tools/train_single.py``
    replicates the state and shards the batch over the data axis)."""
    def draws(model, B, like, generator, ts_state):
        return global_draws(B, like, sched, generator, False)

    return make_train_step(sched, pit=False, graph=graph, make_loss=make_single_loss_fn,
                           layout=layout, draws=draws)


def eval_params(state: dict) -> dict:
    """Parameters to sample with: the EMA average when present, else the
    raw parameters (``state`` holds ``params`` and maybe ``ema_params``)."""
    ema = state.get("ema_params")
    return ema if ema is not None else state["params"]


@torch.no_grad()
def adaln_scale_shift_grid(model: InteractionModel, ts, xf_proj: torch.Tensor):
    """Every StylizationBlock's (scale, shift) for every timestep in ``ts``
    (a host array, or an int64 tensor on xf_proj's device).

    Returns a list over layers of {block: (scale, shift)} for the blocks
    the layer has (a ``--no_cross_attn`` or ``--single_transformer`` layer
    has no "int"), each of shape (len(ts), B, 2, 1, D), or (len(ts), B, 1,
    D) under ``single_transformer``, whose conditioning is the actors' mean.
    """
    den = model.denoiser
    t = ts if torch.is_tensor(ts) else torch.as_tensor(np.ascontiguousarray(ts),
                                                       device=xf_proj.device)
    # in the model's compute dtype, as JAX's grid takes every Dense
    emb = den.time_embed(t)[:, None, None, :] + xf_proj[None]  # (S, B, 2, E)
    if den.single_transformer:
        emb = actor_mean(emb, 2)
    return [
        {short: getattr(layer, full).proj_out.scale_shift(emb) for short, full in BLOCKS
         if hasattr(layer, full)}
        for layer in den.layers
    ]


def _to_device(a, device) -> torch.Tensor:
    """``a`` (a tensor, array or list) on ``device``; a copy from the host
    happens here, before any graph replays."""
    return (a if torch.is_tensor(a) else torch.from_numpy(np.ascontiguousarray(a))).to(device)


def make_sampler(model: InteractionModel, sched: g.DiffusionSchedule, T: int,
                 dim_pose: int, sampler: str = "ddim", ddim_steps: int = 50,
                 guidance_scale: float = 1.0, graph: bool = True) -> Callable:
    """Returns ``sample(cond, lengths (B,), noise=None, generator=None,
    step_noise=None) -> (B, 2, T, dim_pose)``; cond is (B, 2, 77) caption
    tokens or, for a ``cap_id`` model, (B, 2) caption ids.

    ``sampler``: "ddpm" (ancestral, every timestep of ``sched``), "ddim" or
    "dpm" (DPM-Solver++(2M)), the last two over ``ddim_steps`` of the
    stride grid. ``noise`` is the initial x_T and ``step_noise(i)`` the
    DDPM step noise of step i (see ``g.p_sample_loop``); what is not given
    is drawn from ``generator`` on the model's device. With
    ``guidance_scale`` w ≠ 1 each step predicts e_u + w·(e_c − e_u) from
    the conditional and the null conditioning (a model trained with
    ``cond_drop_prob`` > 0) in one denoiser call over 2B pairs. DDIM and DPM
    hoist every block's AdaLN (scale, shift) over their grid (the null
    pairs' beside the conditional ones); DDPM does not, as the JAX sampler
    does not: over 1000 steps the grid would take 1000 × 2B sequences × 32
    blocks × 2·latent floats (13.6 GB at 52 pairs), so its denoiser computes
    the gates each step.

    A bfloat16 model (``compute_dtype``) has its floating parameters cast
    once, here and in place (``cast_floating``, as JAX's sampler casts its
    parameter tree), and computes the gates, the text state and ε in
    bfloat16; the state x stays float32 and each ε is upcast before its
    update. The schedule's tables and the grid's timesteps are moved to the
    model's device once, here: the model stays on that device.

    On a CUDA model with ``graph`` (the default) the whole call — the text
    tower and suffix, the text state, the AdaLN grid, every step and, for
    DDPM, its draws — is one CUDA graph per (cond shape, cond dtype) and
    flags (:func:`graph_key`), captured at the first call of that shape and
    replayed after
    (``hig_tpu_torch.utils.graphs``): the counterpart of the JAX sampler's
    ``jax.jit``. cond, lengths and x_T are copied into the graph's buffers,
    and DDPM's step noise is drawn from the caller's generator state, which
    ends where the eager loop leaves it. A callable ``step_noise`` cannot be
    replayed and raises there. ``graph=False``, and any CPU model, run the
    eager loop, every op launched from the host. ``sample.graphs`` holds
    the graphs by key (capture seconds, pool bytes, launches a replay).
    """
    if sampler not in SAMPLERS:
        raise ValueError(f"unknown sampler {sampler!r} (one of {SAMPLERS})")
    guided = guidance_scale != 1.0
    if guided and model.cfg.cond_drop_prob <= 0.0:
        raise ValueError(
            "--guidance_scale != 1 requires a checkpoint trained with --cond_drop_prob > 0 "
            "(no null conditioning in this model)"
        )
    ts = g.ddim_timesteps(sched.num_timesteps, ddim_steps)
    if model.cfg.dtype != torch.float32:
        cast_floating(model, model.cfg.dtype)
    device = next(model.parameters()).device
    tables = sched.on(device)
    grid_ts = torch.as_tensor(np.ascontiguousarray(ts), device=device)

    def run(cond, lengths, noise, generator=None, step_noise=None, warmup=False):
        """One sampling call on device tensors from x_T = ``noise``; with
        ``warmup``, only its first denoiser call."""
        lengths = torch.clamp(lengths, max=T)
        B = cond.shape[0]
        xf_proj, xf_out = model.encode_text(cond)
        if guided:
            # the null pairs follow the B conditional ones: one denoiser
            # call over 2B pairs a step
            n_proj, n_out = model.null_conditioning(B, xf_out.shape[2])
            xf_proj, xf_out = torch.cat([xf_proj, n_proj]), torch.cat([xf_out, n_out])
            lengths = torch.cat([lengths, lengths])
        text_kv = model.text_kv(xf_out)
        aux = None
        if sampler != "ddpm":
            grid = adaln_scale_shift_grid(model, grid_ts, xf_proj)
            aux = [
                [{k: (s[i], sh[i]) for k, (s, sh) in layer.items()} for layer in grid]
                for i in range(len(ts))
            ]

        def denoiser(x, t, adaln=None):
            if not guided:
                return model.denoise(x, t, lengths, xf_proj, text_kv=text_kv, adaln=adaln)
            eps = model.denoise(torch.cat([x, x]), torch.cat([t, t]), lengths, xf_proj,
                                text_kv=text_kv, adaln=adaln)
            e_c, e_u = eps[:B], eps[B:]
            return e_u + guidance_scale * (e_c - e_u)

        return _sampling_loop(sched, tables, sampler, ts, ddim_steps, denoiser, noise, aux,
                              generator, step_noise, warmup)

    return _sampling_call(run, device, lambda cond: (cond.shape[0], 2, T, dim_pose), sampler,
                          graph)


def make_single_sampler(model, sched: g.DiffusionSchedule, T: int, dim_pose: int,
                        sampler: str = "ddim", ddim_steps: int = 50,
                        graph: bool = True) -> Callable:
    """The single-person model's sampler (counterpart of
    ``hig_tpu/train/trainer.py:603-631``): ``sample(tokens (B, 77), lengths
    (B,), noise=None, generator=None, step_noise=None) -> (B, T,
    dim_pose)``, with DDPM, DDIM or DPM as :func:`make_sampler`. The text is
    encoded once and each layer's text state computed once; as in JAX, no
    AdaLN grid is hoisted. A bfloat16 model's parameters are cast once,
    here, and on the card the whole call is one CUDA graph per shape, as in
    :func:`make_sampler`."""
    if sampler not in SAMPLERS:
        raise ValueError(f"unknown sampler {sampler!r} (one of {SAMPLERS})")
    ts = g.ddim_timesteps(sched.num_timesteps, ddim_steps)
    if model.cfg.dtype != torch.float32:
        cast_floating(model, model.cfg.dtype)
    device = next(model.parameters()).device
    tables = sched.on(device)

    def run(cond, lengths, noise, generator=None, step_noise=None, warmup=False):
        lengths = torch.clamp(lengths, max=T)
        xf_proj, xf_out = model.encode_text(cond)
        text_kv = model.text_kv(xf_out)

        def denoiser(x, t):
            return model.denoise(x, t, lengths, xf_proj, text_kv=text_kv)

        return _sampling_loop(sched, tables, sampler, ts, ddim_steps, denoiser, noise, None,
                              generator, step_noise, warmup)

    return _sampling_call(run, device, lambda cond: (cond.shape[0], T, dim_pose), sampler,
                          graph)


def _sampling_loop(sched, tables, sampler: str, ts, ddim_steps: int, denoiser, noise,
                   aux=None, generator=None, step_noise=None, warmup: bool = False):
    """The step loop of one sampling call of ``denoiser(x, t[, aux_i])``
    from x_T = ``noise``; with ``warmup``, only its first denoiser call."""
    if warmup:
        t0 = sched.num_timesteps - 1 if sampler == "ddpm" else int(ts[0])
        t = torch.full((noise.shape[0],), t0, dtype=torch.int64, device=noise.device)
        return denoiser(noise, t) if aux is None else denoiser(noise, t, aux[0])
    if sampler == "ddpm":
        return g.p_sample_loop(sched, denoiser, noise, generator=generator,
                               step_noise=step_noise, tables=tables)
    if sampler == "dpm":
        return dpmpp_2m_sample_loop(sched, denoiser, noise, num_steps=ddim_steps,
                                    model_aux=aux, tables=tables)
    return g.ddim_sample_loop(sched, denoiser, noise, num_steps=ddim_steps, model_aux=aux,
                              tables=tables)


def _sampling_call(run: Callable, device, shape_of: Callable, sampler: str,
                   graph: bool) -> Callable:
    """``sample(cond, lengths, noise=None, generator=None, step_noise=None)``
    around ``run(cond, lengths, noise, generator=None, step_noise=None,
    warmup=False)`` on ``device``: x_T of ``shape_of(cond)`` from
    ``generator`` unless given, and on the card with ``graph`` one CUDA
    graph per (cond shape, cond dtype) (:func:`make_sampler`'s doc)."""
    graphs: dict = {}
    graphed = graph and device.type == "cuda"
    if graphed:  # what every graph of this sampler shares; DDPM's draws come from rng
        pool, stream = torch.cuda.graph_pool_handle(), torch.cuda.Stream(device)
        rng = torch.Generator(device=device) if sampler == "ddpm" else None

    def replay(cond, lengths, noise, generator):
        if rng is not None and generator is None:
            raise ValueError("the graphed DDPM sampler draws its step noise from a "
                             "torch.Generator: pass generator=")
        key = graph_key(tuple(cond.shape), cond.dtype)
        if key not in graphs:
            graphs[key] = GraphedCall(
                lambda **inputs: run(**inputs, generator=rng),
                {"cond": cond, "lengths": lengths, "noise": noise}, pool, stream,
                warmup=lambda **inputs: run(**inputs, warmup=True), generator=rng)
        return graphs[key](generator if rng is not None else None, cond=cond,
                           lengths=lengths, noise=noise)

    @torch.no_grad()
    def sample(cond, lengths, noise=None, generator=None, step_noise=None):
        cond, lengths = _to_device(cond, device), _to_device(lengths, device)
        shape = shape_of(cond)
        if noise is None:
            if generator is None:
                raise ValueError("sample needs the initial noise or a torch.Generator")
            noise = torch.randn(shape, generator=generator, device=device)
        elif tuple(noise.shape) != shape:
            raise ValueError(f"noise has shape {tuple(noise.shape)}, expected {shape}")
        noise = noise.to(device, torch.float32)
        if not graphed:
            return run(cond, lengths, noise, generator, step_noise)
        if step_noise is not None:
            raise ValueError("step_noise= cannot be replayed by a CUDA graph: make the "
                             "sampler with graph=False to pass it")
        return replay(cond, lengths, noise, generator)

    sample.graphs = graphs
    return sample


# --------------------------------------------------------------------------
# host-side orchestration
# --------------------------------------------------------------------------


def render_loss_curve(metrics_path: str, save_root: str) -> None:
    """``<save_root>/result/result_loss.png``: loss_mot_rec over the
    iterations of ``metrics.jsonl`` (counterpart of JAX's
    ``Trainer._render_loss_curve``). Best-effort, as there: any failure,
    matplotlib missing included, writes nothing."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        its, losses = [], []
        with open(metrics_path) as f:
            for line in f:
                rec = json.loads(line)
                if "loss_mot_rec" in rec:
                    its.append(rec["it"])
                    losses.append(rec["loss_mot_rec"])
        if not its:
            return
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.plot(its, losses)
        ax.set_xlabel("iteration")
        ax.set_ylabel("loss_mot_rec")
        fig.tight_layout()
        os.makedirs(pjoin(save_root, "result"), exist_ok=True)
        fig.savefig(pjoin(save_root, "result", "result_loss.png"), dpi=100)
        plt.close(fig)
    except Exception:  # an observability aid: training's result stands without it
        pass


def step_generator(seed: int, it: int, generation: int, device) -> torch.Generator:
    """The generator of one step's t and noise: a function of (seed, it,
    rollback generation), so a resumed run draws what an unbroken one would
    and a retry after a rollback does not replay the failed draw."""
    key = np.random.SeedSequence([seed, it, generation]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(key >> np.uint64(1)))


class Trainer:
    """Epoch loop, logging and checkpoints of one training run. On the card
    each step is a replay of :func:`make_train_step`'s CUDA graph of its
    batch shape (``graph=False``: the eager step).

    Over several ranks (``torch.distributed`` initialized, e.g. by
    ``python -m hig_tpu_torch.train --distributed``) the run lays its state
    out on ``cfg.mesh`` (``parallel/layout.py``: DP, FSDP, TP or the GPipe
    schedule), each rank reads its rows of every global batch, the steps
    run eagerly, and only the primary writes logs, metrics and
    checkpoints (the one-rank format, gathered from every rank)."""

    def __init__(self, cfg: ExperimentConfig, device=None,
                 clip_config: ClipTextConfig | None = None, graph: bool = True):
        self.cfg = cfg
        self.mesh = make_mesh(cfg.mesh)
        self.graph = graph and self.mesh.world_group.size == 1
        self.graphs: dict = {}  # the last run's step graphs by key
        self.device = resolve_device(device)
        self.model_config = model_config(cfg, clip_config)
        self.layout = TrainLayout(cfg, self.mesh, self.model_config)
        self.primary = dist.is_primary()
        if self.model_config.dtype != torch.float32:
            reduce_bf16_in_float32()
        self.sched = g.make_schedule(g.linear_betas(cfg.diffusion_steps))
        self.pit = cfg.label_path is None
        self.step_seconds: list[float] = []  # host time of each step, metrics read back
        self._native_store = None  # the native loader's clips, built per run

    def init_state(self, weights: dict | None = None) -> TrainState:
        """Seeded random weights (``random_flax_tree``, every leaf nonzero),
        or a copy of ``weights`` (a state dict of this model), on the
        trainer's device, in train mode, laid out by the run's layout; the
        EMA starts as a copy. The weights, Adam's moments and the EMA are
        float32 whatever the compute dtype (mixed precision: the modules
        cast per op)."""
        if weights is None:
            model = InteractionModel(self.model_config)
            load_flax_tree(model, random_flax_tree(self.model_config, self.cfg.seed)["params"])
        else:  # no initializer runs: every parameter is assigned
            with torch.device("meta"):
                model = InteractionModel(self.model_config)
            model.load_state_dict({k: v.detach().clone() for k, v in weights.items()},
                                  strict=True, assign=True)
        model.to(self.device).train()
        self.layout.place_model(model)
        optimizer = make_optimizer(self.cfg, model)
        ema = None
        if self.cfg.ema_decay > 0.0:
            ema = {name: p.detach().clone() for name, p in model.named_parameters()}
        state = TrainState(model=model, optimizer=optimizer, step=0, ema=ema)
        return self.place_state(state)

    def place_state(self, state: TrainState) -> TrainState:
        """Lay ``state`` (its model placed by the layout's ``place_model``,
        its optimizer fresh) out by the run's layout: FSDP's shards of the
        trainable parameters, the global clip norm (JAX's ``place_state``)."""
        labels = param_labels(state.model, freeze_clip=not self.cfg.no_clip)
        self.layout.place_state(state, [n for n, _ in state.model.named_parameters()
                                        if labels[n] == "train"])
        state.optimizer.norm = self.layout.grad_norm
        return state

    def save(self, path: str, state: TrainState, epoch: int, total_it: int) -> None:
        """Write a checkpoint in the one-rank format: every rank takes part
        in gathering the shards, the primary writes."""
        self.layout.gather_params(state)
        payload = self.layout.full_payload(ckpt.payload_of(state, epoch, total_it))
        if self.primary:
            ckpt.write_payload(path, payload)
        dist.barrier()

    def restore(self, path: str, state: TrainState) -> tuple:
        """Restore a one-rank checkpoint into this rank's state (its shards
        cut from the whole tensors); returns (state, epoch, total_it)."""
        out = ckpt.restore_state(path, state, self.layout.local_payload)
        self.layout.restore_shards(state)
        return out

    @torch.no_grad()
    def precompute_tower(self, model: InteractionModel) -> torch.Tensor | None:
        """Frozen CLIP features of the 43 captions (43, 77, width), row
        ``CAP2KEY[caption]``, computed once per run; None where the tower
        runs in the step (``--no_clip``, where it trains) or there is none
        (``cap_id``)."""
        if self.cfg.no_clip or self.cfg.cap_id:
            return None
        tokens = torch.from_numpy(tokenize(CAPS).astype(np.int64)).to(self.device)
        return model.clip_tower(tokens)

    def _device_batch(self, batch: dict, tower_feats) -> dict:
        out = {
            "motion": torch.from_numpy(batch["motion"]).to(self.device),
            "lengths": torch.from_numpy(batch["lengths"]).long().to(self.device),
        }
        cap_ids = torch.from_numpy(batch["cap_ids"]).long().to(self.device)
        if self.cfg.cap_id:
            out["cap_ids"] = cap_ids
            return out
        out["tokens"] = torch.from_numpy(batch["tokens"]).long().to(self.device)
        if tower_feats is not None:
            out["tower_feats"] = tower_feats[cap_ids]
        return out

    def new_loss_history(self) -> tss.LossSecondMomentState | None:
        """A fresh loss-aware history (``--loss_aware_sampler``), else None."""
        if not self.cfg.loss_aware_sampler:
            return None
        return tss.LossSecondMomentState.create(self.sched.num_timesteps, device=self.device)

    def _native_epoch_batches(self, dataset: PairDataset, batch_size: int, epoch: int,
                              seed: int, token_cache: dict | None = None):
        """One epoch's batches from the native loader (``data/native_loader.py``,
        as ``hig_tpu/train/trainer.py:744-778``): the order of (seed, epoch)
        truncated to whole batches, each clip windowed to ``window_size`` + 1
        rows, normalized and role-swapped natively, its captions those of
        ``dataset.__getitem__(i, epoch=0)``. The store is built on the first
        call of a run."""
        if self._native_store is None:
            self._native_store, self._native_swaps = store_from_dataset(dataset)
            self._native_caps = [dataset.__getitem__(i, epoch=0)
                                 for i in range(dataset.real_len())]
        n = len(dataset)
        order = np.arange(n)
        np.random.default_rng((seed, epoch)).shuffle(order)
        order = order[: (n // batch_size) * batch_size]
        real = dataset.real_len()
        # this rank's contiguous slice of each global batch
        pid, pcount = self.layout.batch_index, self.layout.batch_count
        if batch_size % pcount:
            raise ValueError(f"global batch {batch_size} not divisible by {pcount} processes")
        local_bs = batch_size // pcount
        for lo in range(0, len(order), batch_size):
            idx = order[lo + pid * local_bs : lo + (pid + 1) * local_bs] % real
            motion, lengths = self._native_store.sample_batch(
                idx, window=self.cfg.window_size, seed=seed, epoch=epoch,
                swap_flags=self._native_swaps[idx])
            samples = []
            for j, i in enumerate(idx):
                sample = dict(self._native_caps[int(i)])
                sample["motion"] = motion[j]
                sample["length"] = int(lengths[j])
                samples.append(sample)
            yield collate(samples, token_cache)

    def epoch_batches_fn(self, dataset: PairDataset, token_cache: dict, log=print):
        """``epoch → batches`` of the run: the Python loader, or under
        ``use_native_loader`` the native one, unless a clip has several
        caption lines (JAX's rule: the native store keeps one caption pair
        a clip)."""
        cfg = self.cfg
        if cfg.use_native_loader:
            if all(len(c.texts) == 1 for c in dataset.clips):
                self._native_store = None
                log("using native C++ batch loader")
                return lambda epoch: self._native_epoch_batches(
                    dataset, cfg.batch_size, epoch, cfg.seed, token_cache)
            log("--use_native_loader: a clip has several captions; using the Python loader")
        return lambda epoch: epoch_batches(dataset, cfg.batch_size, epoch, seed=cfg.seed,
                                           token_cache=token_cache,
                                           process_index=self.layout.batch_index,
                                           process_count=self.layout.batch_count)

    @torch.no_grad()
    def val_loss(self, val_dataset: PairDataset, state: TrainState, tower_feats,
                 epoch: int) -> float:
        """Mean loss of up to VAL_MAX_BATCHES validation batches under the
        raw parameters (uniform t, and caption dropout as in training); each
        batch's t, noise and keep come from a generator seeded by (seed + 2,
        epoch, batch). It runs eagerly, a forward per batch: no graph."""
        loss_fn = make_loss_fn(state.model, self.sched, self.pit)
        losses = []
        for i, batch in enumerate(epoch_batches(val_dataset, self.cfg.batch_size, 0,
                                                seed=self.cfg.seed)):
            if i >= VAL_MAX_BATCHES:
                break
            generator = step_generator(self.cfg.seed + 2, epoch, i, self.device)
            loss, _ = loss_fn(self._device_batch(batch, tower_feats), generator)
            losses.append(float(loss))
        return float(np.mean(losses)) if losses else float("nan")

    def train(self, dataset: PairDataset, state: TrainState, num_epochs: int | None = None,
              log=print, start_epoch: int = 0,
              val_dataset: PairDataset | None = None) -> TrainState:
        """The epoch loop. Each step's two metrics come back to the host in
        one copy, which the non-finite check (a rollback to ``latest``,
        restored in place) and the log read. With ``profile``: a
        ``torch.profiler`` trace of steps [5, 10) of this run in
        ``<save_root>/profile``, and each step's host time (metrics read
        back) summarized in ``step_times.jsonl`` and a "step latency" line."""
        cfg = self.cfg
        num_epochs = num_epochs or cfg.num_epochs
        if self.primary:
            os.makedirs(cfg.model_dir, exist_ok=True)
        if not self.primary:
            def log(*args, **kwargs):  # only the primary writes the run's log
                pass
        train_step = make_train_step(self.sched, self.pit, cfg.grad_accum, cfg.ema_decay,
                                     cfg.loss_aware_sampler, graph=self.graph,
                                     layout=self.layout)
        self.graphs = train_step.graphs
        step_timer = trace = None
        steps_run, tracing = 0, False
        if cfg.profile and self.primary:
            step_timer = StepTimer(items_per_step=cfg.batch_size)
            trace = DeviceTrace(pjoin(cfg.save_root, "profile"), self.device)
        state.model.train()
        tower_feats = self.precompute_tower(state.model)
        ts_state = self.new_loss_history()  # per run; not checkpointed
        metrics_path = pjoin(cfg.save_root, "metrics.jsonl")
        latest = pjoin(cfg.model_dir, "latest.pt")
        token_cache: dict = {}
        batches = self.epoch_batches_fn(dataset, token_cache, log)
        it, generation, retries_left = state.step, 0, MAX_FAILURE_RETRIES
        logs: dict[str, float] = {}
        start = time.time()
        # a `latest` that --is_continue restored is a rollback target too
        ckpt_exists = cfg.is_continue and os.path.exists(latest)
        for epoch in range(start_epoch, num_epochs):
            for batch in batches(epoch):
                generator = step_generator(cfg.seed + 1, it, generation, self.device)
                if trace is not None and steps_run == 5 and not tracing:
                    trace.start()
                    tracing = True
                dev_batch = self._device_batch(batch, tower_feats)
                graphs_before = len(self.graphs)
                t_step = time.perf_counter()
                if ts_state is None:
                    metrics = train_step(state, dev_batch, generator)
                else:
                    metrics, ts_state = train_step(state, dev_batch, generator,
                                                   ts_state=ts_state)
                values = torch.stack([metrics[k] for k in TRAIN_METRICS]).tolist()
                metrics = dict(zip(TRAIN_METRICS, values))
                self.step_seconds.append(time.perf_counter() - t_step)
                if step_timer is not None:
                    step_timer.times.append(self.step_seconds[-1])
                if len(self.graphs) > graphs_before:
                    captured = list(self.graphs.values())[-1]
                    log(f"train step graph {len(self.graphs)} captured: "
                        f"{captured.capture_s:.2f}s after a {captured.warmup_s:.2f}s eager "
                        f"first step, pool {captured.pool_bytes / 1e9:.3f} GB")
                if not all(math.isfinite(v) for v in metrics.values()):
                    if retries_left <= 0 or not ckpt_exists:
                        raise FloatingPointError(f"non-finite training loss at it {it}: {metrics}")
                    retries_left -= 1
                    generation += 1
                    log(f"non-finite loss at it {it} ({metrics}); rolling back to the latest "
                        f"checkpoint ({retries_left} retries left)")
                    state, _, it = self.restore(latest, state)
                    # the history may hold the failed step's losses
                    ts_state = self.new_loss_history()
                    continue
                it += 1
                steps_run += 1
                if tracing and steps_run == 10:
                    log(f"device trace written to {trace.stop()}")
                    tracing = False
                for k, v in metrics.items():
                    logs[k] = logs.get(k, 0.0) + v
                if it % cfg.log_every == 0:
                    mean = {k: v / cfg.log_every for k, v in logs.items()}
                    logs = {}
                    log(f"epoch {epoch} it {it} "
                        + " ".join(f"{k}: {v:.5f}" for k, v in mean.items())
                        + f" ({time.time() - start:.0f}s)")
                    if self.primary:
                        with open(metrics_path, "a") as f:
                            f.write(json.dumps({"it": it, "epoch": epoch, **mean}) + "\n")
                if it % cfg.save_latest == 0:
                    # mid-epoch: a resume redoes this (partial) epoch
                    self.save(latest, state, epoch, it)
                    ckpt_exists = True
            # the stored epoch is the next one to run
            self.save(latest, state, epoch + 1, it)
            ckpt_exists = True
            if epoch % cfg.save_every_e == 0 and self.primary:
                ckpt.save_copy(latest, pjoin(cfg.model_dir, f"ckpt_e{epoch:03d}.pt"))
            if val_dataset is not None and cfg.eval_every_e > 0 \
                    and (epoch + 1) % cfg.eval_every_e == 0:
                val = self.val_loss(val_dataset, state, tower_feats, epoch)
                log(f"epoch {epoch} val_loss: {val:.5f}")
                if self.primary:
                    with open(metrics_path, "a") as f:
                        f.write(json.dumps({"it": it, "epoch": epoch, "val_loss": val}) + "\n")
        if tracing:
            log(f"device trace written to {trace.stop()}")
        if step_timer is not None and step_timer.times:
            step_timer.dump(pjoin(cfg.save_root, "step_times.jsonl"))
            log(f"step latency: {step_timer.summary()}")
        if self.primary:
            render_loss_curve(metrics_path, cfg.save_root)
        return state
