"""Train the single-person (MotionDiffuse) model on HumanML3D or KIT-ML
(counterpart of ``tools/train_single.py``): the paper's baseline and the
weight donor of ``--pretrained``.

    python -m hig_tpu_torch.train_single --name kit_single --dataset_name kit \\
        --data_root data/KIT-ML --batch_size 128 --num_epochs 50
    python -m hig_tpu_torch.train_single ... --device cpu  # plain PyTorch, no kernels

Several ranks (one process each, as ``python -m hig_tpu_torch.train``):

    HIG_COORDINATOR=localhost:29500 HIG_NUM_PROCESSES=2 HIG_PROCESS_ID=<r> \
        python -m hig_tpu_torch.train_single --distributed ... [--mesh_data 2]

As JAX's ``tools/train_single.py`` does on its mesh, every rank holds the
whole state (--fsdp, --tp and --pp_micro do not apply) and reads its rows
of each global --batch_size batch over the data axis; the gradients are
summed over the ranks (``parallel/layout.py``'s DP mode) and the steps run
eagerly. Only the primary (rank 0) writes.

The data root holds new_joint_vecs/<name>.npy ((rows, D) clips, the init
row last), texts/<name>.txt (``caption#tokens#f_tag#to_tag`` lines),
train.txt, Mean.npy and Std.npy (D + 3 entries: the 3 trailing ones are the
init row's). Each step takes a --window-frame window of each clip (60 by
default) with the init row at the end; the model's widths and --no_eff come
from the training options, and its weights start from seeded random values
(--seed). The masked MSE of the epsilon prediction trains with Adam behind
the global-norm clip, the CLIP tower frozen; on the card each step replays
the CUDA graph of its batch shape. A run writes opt.txt, metrics.jsonl
(loss_mot_rec every --log_every steps), meta/{mean,std}.npy (Std.npy with
the --feat_bias rescale) and model/latest.pt under
<checkpoints_dir>/<dataset_name>/<name>; --is_continue resumes from
model/latest.pt. ``trainer.make_single_sampler`` samples the result.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from os.path import join as pjoin

import torch

from hig_tpu_torch import resolve_device
from hig_tpu_torch.config import (
    add_config_args,
    config_from_args,
    save_opt_txt,
    single_model_config,
)
from hig_tpu_torch.data.dataset import (
    SINGLE_WINDOW,
    SingleMotionDataset,
    epoch_batches,
    load_training_stats,
)
from hig_tpu_torch.diffusion import gaussian as g
from hig_tpu_torch.models.interaction_model import SingleMotionModel
from hig_tpu_torch.models.text_encoder import ClipTextConfig
from hig_tpu_torch.parallel import distributed as dist
from hig_tpu_torch.parallel.layout import TrainLayout
from hig_tpu_torch.parallel.mesh import make_mesh
from hig_tpu_torch.train import checkpoint as ckpt
from hig_tpu_torch.train.trainer import (
    TrainState,
    make_optimizer,
    make_single_train_step,
    step_generator,
)
from hig_tpu_torch.weights import load_flax_tree, random_flax_tree, reduce_bf16_in_float32


def init_state(cfg, device, clip_config: ClipTextConfig | None = None) -> TrainState:
    """Seeded random weights (every leaf nonzero) on ``device`` in train
    mode, and the optimizer over the trainable partition."""
    mcfg = single_model_config(cfg, clip_config)
    if mcfg.dtype != torch.float32:
        reduce_bf16_in_float32()
    model = SingleMotionModel(mcfg)
    load_flax_tree(model, random_flax_tree(mcfg, cfg.seed)["params"])
    model.to(device).train()
    return TrainState(model=model, optimizer=make_optimizer(cfg, model))


def main(argv=None, graph: bool = True, clip_config: ClipTextConfig | None = None):
    """Parse ``argv``, train, and return the final TrainState. On the card
    each step replays the CUDA graph of its batch shape; ``graph=False``
    runs the eager step. ``clip_config`` (no flag) shrinks the CLIP tower
    for tests; the CLI's tower is ViT-B/32."""
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    add_config_args(parser)
    parser.add_argument("--window", type=int, default=SINGLE_WINDOW,
                        help="training window in frames")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    try:
        cfg = config_from_args(args)
        single_model_config(cfg)
    except (ValueError, KeyError) as e:
        parser.error(str(e))
    device = resolve_device(args.device)
    if cfg.distributed:
        device = dist.initialize(device=device)
    layout = TrainLayout.data_parallel(make_mesh(cfg.mesh))
    primary = dist.is_primary()

    def log(text: str) -> None:
        if primary:
            print(text)

    if primary:
        os.makedirs(cfg.model_dir, exist_ok=True)
        save_opt_txt(cfg, pjoin(cfg.save_root, "opt.txt"))
    mean, std = load_training_stats(cfg, write=primary)
    dataset = SingleMotionDataset(cfg, mean, std, "train.txt", times=cfg.times, seed=cfg.seed,
                                  window=args.window)
    log(f"dataset: {dataset.real_len()} clips (caption segments included) "
        f"x times={cfg.times}")
    state = init_state(cfg, device, clip_config)
    latest = pjoin(cfg.model_dir, "latest.pt")
    start_epoch = 0
    if cfg.is_continue:
        state, start_epoch, it = ckpt.restore_state(latest, state)
        log(f"resumed from epoch {start_epoch}, it {it}")

    def save(epoch: int, it: int) -> None:
        if primary:  # the state is whole on every rank
            ckpt.save_state(latest, state, epoch, it)
        dist.barrier()

    sched = g.make_schedule(g.linear_betas(cfg.diffusion_steps))
    train_step = make_single_train_step(sched, graph=graph, layout=layout)
    metrics_path = pjoin(cfg.save_root, "metrics.jsonl")
    it, t0 = state.step, time.time()
    for epoch in range(start_epoch, cfg.num_epochs):
        for batch in epoch_batches(dataset, cfg.batch_size, epoch, seed=cfg.seed,
                                   process_index=layout.batch_index,
                                   process_count=layout.batch_count):
            dev = {"motion": torch.from_numpy(batch["motion"]).to(device),
                   "lengths": torch.from_numpy(batch["lengths"]).long().to(device),
                   "tokens": torch.from_numpy(batch["tokens"]).long().to(device)}
            metrics = train_step(state, dev, step_generator(cfg.seed + 1, it, 0, device))
            it += 1
            if it % cfg.log_every == 0:
                loss = float(metrics["loss_mot_rec"])
                log(f"epoch {epoch} it {it} loss: {loss:.5f} ({time.time() - t0:.0f}s)")
                if primary:
                    with open(metrics_path, "a") as f:
                        f.write(json.dumps({"it": it, "epoch": epoch,
                                            "loss_mot_rec": loss}) + "\n")
            if it % cfg.save_latest == 0:
                # mid-epoch: a resume redoes this (partial) epoch
                save(epoch, it)
        # the stored epoch is the next one to run
        save(epoch + 1, it)
    log(f"done: {it} steps")
    return state


if __name__ == "__main__":
    main()
