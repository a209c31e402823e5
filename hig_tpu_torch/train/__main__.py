"""Train the two-person interaction model (counterpart of ``tools/train.py``).

Stage 1-1 (PIT): run without --label_path; the loss takes the better of the
two caption assignments of each pair. The reference's PIT model conditions
on caption ids (--cap_id). Stage 1-2: ``python -m hig_tpu_torch.label``
discovers the roles and writes <data_root>/pseudo_labels.json. Stage 1-3
(supervised): run with --label_path, a JSON object of clip name → 0/1;
clips labeled 1 have their actors swapped. --cond_drop_prob trains the
supervised model for classifier-free guidance.

    python -m hig_tpu_torch.train --name pit --cap_id --data_root data/NTURGBD_multi \
        --batch_size 32 --times 30 --num_epochs 50
    python -m hig_tpu_torch.train --name interaction \
        --label_path data/NTURGBD_multi/pseudo_labels.json --cond_drop_prob 0.1 ...
    python -m hig_tpu_torch.train ... --loss_aware_sampler  # timesteps by loss
    python -m hig_tpu_torch.train ... --no_eff         # quadratic attention model
    python -m hig_tpu_torch.train ... --no_cross_attn  # ablation: no interaction block
    python -m hig_tpu_torch.train ... --single_transformer  # ablation: one 2T timeline
    python -m hig_tpu_torch.train ... --compute_dtype bfloat16 [--fast_ln] [--rms_norm]
    python -m hig_tpu_torch.train ... --device cpu     # plain PyTorch, no kernels
    python -m hig_tpu_torch.train ... --profile        # trace of steps [5, 10), step latency

The data root holds the reference's layout: new_joint_vecs/*.npy,
texts/*.txt, train_sub.txt, Mean.npy and Std.npy; with val_sub.txt there the
validation loss is logged every --eval_every_e epochs. Weights start from
seeded random values (--seed). Runs write opt.txt, metrics.jsonl,
meta/{mean,std}.npy and model/{latest,ckpt_eNNN}.pt under
<checkpoints_dir>/<dataset_name>/<name> (with --profile also profile/trace.json
and step_times.jsonl); --is_continue resumes from
model/latest.pt. ``python -m hig_tpu_torch.serve --opt_path <...>/opt.txt``
serves the result.
"""

from __future__ import annotations

import argparse
import os
from os.path import join as pjoin

from hig_tpu_torch import resolve_device
from hig_tpu_torch.config import (
    add_config_args,
    config_from_args,
    model_config,
    save_opt_txt,
)
from hig_tpu_torch.data.dataset import PairDataset, load_training_stats
from hig_tpu_torch.train import checkpoint as ckpt
from hig_tpu_torch.train.trainer import Trainer


def main(argv=None, graph: bool = True):
    """Parse ``argv``, train, and return (trainer, final state). On the card
    each step replays the CUDA graph of its batch shape; ``graph=False``
    (no flag: JAX has none) runs the eager step."""
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    add_config_args(parser)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    try:
        cfg = config_from_args(args)
        model_config(cfg)  # refuses the block options the port has no blocks for
    except (ValueError, KeyError) as e:
        parser.error(str(e))
    device = resolve_device(args.device)

    save_opt_txt(cfg, pjoin(cfg.save_root, "opt.txt"))
    mean, std = load_training_stats(cfg)
    dataset = PairDataset(cfg, mean, std, "train_sub.txt", times=cfg.times,
                          label_path=cfg.label_path, seed=cfg.seed)
    print(f"dataset: {dataset.real_len()} clips x times={cfg.times}")
    trainer = Trainer(cfg, device, graph=graph)
    state = trainer.init_state()
    start_epoch = 0
    if cfg.is_continue:
        state, start_epoch, it = ckpt.restore_state(pjoin(cfg.model_dir, "latest.pt"), state)
        print(f"resumed from epoch {start_epoch}, it {it}")
    val_dataset = None
    if cfg.eval_every_e > 0 and os.path.exists(pjoin(cfg.data_root, "val_sub.txt")):
        val_dataset = PairDataset(cfg, mean, std, "val_sub.txt", times=1,
                                  label_path=cfg.label_path, seed=cfg.seed)
    state = trainer.train(dataset, state, start_epoch=start_epoch, val_dataset=val_dataset)
    return trainer, state


if __name__ == "__main__":
    main()
