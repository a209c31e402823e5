"""Progressively distill a trained interaction model to few-step DDIM
sampling (counterpart of ``tools/distill.py``).

Each stage N halves the teacher's DDIM grid: a student, started as a copy
of the teacher, is trained for --epochs_per_stage epochs so that one of its
DDIM steps reproduces two of the teacher's (``diffusion/distill.py``), then
teaches the next stage. The first teacher is the run's checkpoint
(``<run>/model/<--model_name>.pt``, its EMA parameters when present); its
grid is the run's --ddim_steps. Each stage writes a run directory
``<checkpoints_dir>/<dataset>/<name>_distill<N>/`` (opt.txt with sampler
ddim and ddim_steps N, and guidance_scale 1 under --distill_w ≠ 1,
model/latest.pt, meta/{mean,std}.npy, metrics.jsonl) that ``python -m
hig_tpu_torch.serve --opt_path`` and ``python -m hig_tpu_torch.evaluate
--opt_path`` read as they read a training run.

The student trains in train mode (its efficient blocks through B2; Adam
fresh each stage, no EMA); the teacher runs in eval mode without gradients,
its efficient blocks through B1 (B2 for an rms_norm run, which has no fused
block; a --no_eff run's quadratic blocks through B4). On the card every step after a batch shape's first replays that
shape's CUDA graph. --distill_w w ≠ 1 (a CFG teacher only) distills the
guided blend at w: the student samples unguided.

    python -m hig_tpu_torch.distill --opt_path checkpoints/ntu_mul/interaction/opt.txt \
        --epochs_per_stage 6 --lr 5e-5
    python -m hig_tpu_torch.distill ... --stages 25 --distill_w 2.5 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import shutil
import time
from os.path import join as pjoin

import numpy as np
import torch

from hig_tpu_torch import resolve_device
from hig_tpu_torch.config import load_opt_txt, model_config, save_opt_txt
from hig_tpu_torch.data.dataset import PairDataset, epoch_batches
from hig_tpu_torch.diffusion import distill as pd
from hig_tpu_torch.models.interaction_model import InteractionModel
from hig_tpu_torch.models.text_encoder import ClipTextConfig
from hig_tpu_torch.parallel import distributed as dist
from hig_tpu_torch.train import checkpoint as ckpt
from hig_tpu_torch.train.trainer import (
    Trainer,
    TrainState,
    eval_params,
    make_optimizer,
    step_generator,
)


def main(argv=None, clip_config: ClipTextConfig | None = None, graph: bool = True) -> list[str]:
    """Parse ``argv`` and distill; returns the stage directories written.
    ``clip_config`` (tests) gives a small CLIP tower; ``graph=False`` runs
    the eager step."""
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--opt_path", required=True, help="the teacher run's opt.txt")
    parser.add_argument("--model_name", default="latest")
    parser.add_argument("--stages", default=None,
                        help="comma-separated student step counts (default: the halving "
                             "ladder from the teacher's ddim_steps)")
    parser.add_argument("--min_steps", type=int, default=4,
                        help="where the default halving ladder stops")
    parser.add_argument("--epochs_per_stage", type=int, default=6)
    parser.add_argument("--lr", type=float, default=5e-5)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--times", type=int, default=1,
                        help="epoch inflation of the distillation data pass")
    parser.add_argument("--log_every", type=int, default=None)
    parser.add_argument("--distill_w", type=float, default=1.0,
                        help="fixed-w guided distillation (CFG teacher only)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    dist.require_one_process("python -m hig_tpu_torch.distill")

    cfg = load_opt_txt(args.opt_path)
    cfg.lr = args.lr
    cfg.is_continue = False
    if args.batch_size:
        cfg.batch_size = args.batch_size
    if args.log_every:
        cfg.log_every = args.log_every
    try:
        student_cfg = model_config(cfg, clip_config)
        # an RMSNorm model has no fused block (its kernel computes LayerNorm)
        teacher_cfg = dataclasses.replace(student_cfg,
                                          fused_blocks=not cfg.no_eff and not cfg.rms_norm)
    except ValueError as e:
        parser.error(str(e))
    if args.distill_w != 1.0 and cfg.cond_drop_prob <= 0.0:
        parser.error(f"--distill_w {args.distill_w} needs a CFG teacher (a run trained with "
                     f"--cond_drop_prob > 0)")
    if cfg.sampler != "ddim":
        print(f"note: teacher opt.txt has sampler={cfg.sampler}; distillation targets the "
              f"DDIM grid (teacher steps = {cfg.ddim_steps})")
    stages = ([int(s) for s in args.stages.split(",")] if args.stages
              else pd.halving_stages(cfg.ddim_steps, args.min_steps))
    print(f"distillation ladder: {cfg.ddim_steps} -> {stages}")
    device = resolve_device(args.device)

    mean = np.load(pjoin(cfg.meta_dir, "mean.npy"))
    std = np.load(pjoin(cfg.meta_dir, "std.npy"))
    dataset = PairDataset(cfg, mean, std, "train_sub.txt", times=args.times,
                          label_path=cfg.label_path, seed=cfg.seed)
    print(f"dataset: {dataset.real_len()} clips x times={args.times}")

    trainer = Trainer(cfg, device, clip_config=clip_config, graph=graph)
    weights = eval_params(ckpt.load(pjoin(cfg.model_dir, f"{args.model_name}.pt")))
    with torch.device(device):  # initialized where they run, then loaded
        teacher, student = InteractionModel(teacher_cfg), InteractionModel(student_cfg)
    teacher.load_state_dict(weights, strict=True)
    teacher.to(device).eval().requires_grad_(False)
    student.load_state_dict(weights, strict=True)
    student.to(device).train()
    tower_feats = trainer.precompute_tower(teacher)
    token_cache: dict = {}
    it, written = 0, []

    for stage_idx, n_steps in enumerate(stages):
        prev_steps = cfg.ddim_steps if stage_idx == 0 else stages[stage_idx - 1]
        grids = pd.distill_grids(trainer.sched.num_timesteps, n_steps,
                                 teacher_steps=prev_steps)
        state = TrainState(model=student, optimizer=make_optimizer(cfg, student))
        step = pd.make_distill_step(trainer.sched, grids, teacher, args.distill_w,
                                    graph=graph)
        print(f"=== stage {stage_idx}: teacher DDIM-{prev_steps} -> student DDIM-{n_steps} ===")
        stage_cfg = dataclasses.replace(cfg, name=f"{cfg.name}_distill{n_steps}",
                                        sampler="ddim", ddim_steps=n_steps)
        if args.distill_w != 1.0:
            # the student internalized w: its run samples unguided
            stage_cfg = dataclasses.replace(stage_cfg, guidance_scale=1.0)
        os.makedirs(stage_cfg.model_dir, exist_ok=True)
        os.makedirs(stage_cfg.meta_dir, exist_ok=True)
        for stat in ("mean.npy", "std.npy"):
            shutil.copyfile(pjoin(cfg.meta_dir, stat), pjoin(stage_cfg.meta_dir, stat))
        save_opt_txt(stage_cfg, pjoin(stage_cfg.save_root, "opt.txt"))
        metrics_path = pjoin(stage_cfg.save_root, "metrics.jsonl")
        start, logs = time.time(), {}
        for epoch in range(args.epochs_per_stage):
            for batch in epoch_batches(dataset, cfg.batch_size, epoch, seed=cfg.seed,
                                       token_cache=token_cache):
                generator = step_generator(cfg.seed + 3, it, stage_idx, device)
                graphs_before = len(step.graphs)
                metrics = step(state, trainer._device_batch(batch, tower_feats), generator)
                values = torch.stack([metrics[k] for k in pd.DISTILL_METRICS]).tolist()
                metrics = dict(zip(pd.DISTILL_METRICS, values))
                if len(step.graphs) > graphs_before:
                    captured = list(step.graphs.values())[-1]
                    print(f"distill step graph captured: {captured.capture_s:.2f}s after a "
                          f"{captured.warmup_s:.2f}s eager first step, pool "
                          f"{captured.pool_bytes / 1e9:.3f} GB")
                if not all(math.isfinite(v) for v in values):
                    raise FloatingPointError(f"non-finite distillation loss at stage {n_steps} "
                                             f"it {it}: {metrics}")
                it += 1
                for k, v in metrics.items():
                    logs[k] = logs.get(k, 0.0) + v
                if it % cfg.log_every == 0:
                    mn = {k: v / cfg.log_every for k, v in logs.items()}
                    logs = {}
                    print(f"stage {n_steps} epoch {epoch} it {it} "
                          + " ".join(f"{k}: {v:.5f}" for k, v in mn.items())
                          + f" ({time.time() - start:.0f}s)")
                    with open(metrics_path, "a") as f:
                        f.write(json.dumps({"stage": n_steps, "it": it, "epoch": epoch,
                                            **mn}) + "\n")
        ckpt.save_state(pjoin(stage_cfg.model_dir, "latest.pt"), state,
                        args.epochs_per_stage, it)
        print(f"stage {n_steps}: wrote {stage_cfg.save_root} (serve or evaluate with "
              f"--opt_path {pjoin(stage_cfg.save_root, 'opt.txt')})")
        written.append(stage_cfg.save_root)
        # the student becomes the next stage's teacher, copied in place
        teacher.load_state_dict(student.state_dict(), strict=True)
    return written


if __name__ == "__main__":
    main()
