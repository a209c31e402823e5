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
    python -m hig_tpu_torch.train ... --causal         # causal attention (either family)
    python -m hig_tpu_torch.train ... --use_native_loader [--window_size 60]  # C++ batches
    python -m hig_tpu_torch.train ... --pretrained [--pretrained_path P] \
        [--only_language | --only_motion]  # warm start from a reference checkpoint

Several ranks (one process each; torch.distributed, NCCL when each rank has
a card of its own, gloo on the CPU or on a shared card):

    HIG_COORDINATOR=localhost:29500 HIG_NUM_PROCESSES=2 HIG_PROCESS_ID=<r> \
        python -m hig_tpu_torch.train --distributed ... \
        [--mesh_data 2 | --mesh_model 2 (--fsdp | --tp | --pp_micro 2)]

--batch_size is the global batch; each rank reads its rows of it. The mesh
is (data, model), data × model = the processes; --fsdp shards the state over
the model axis, --tp runs the blocks tensor-parallel on it, --pp_micro M
pipelines the layer stack over it in M microbatches (parallel/). Only the
primary (rank 0) writes opt.txt, logs, metrics and checkpoints, which are
in the one-rank format.

The data root holds the reference's layout: new_joint_vecs/*.npy,
texts/*.txt, train_sub.txt, Mean.npy and Std.npy; with val_sub.txt there the
validation loss is logged every --eval_every_e epochs. Weights start from
seeded random values (--seed), or with --pretrained from the reference's
torch checkpoint (``train/torch_port.py``: its text stack and motion
denoiser, or one of them; every other parameter and, as in JAX, the EMA
keep their seeded values). --use_native_loader fills batches with the
native C++ loader (built with g++ at first use), whose windows are
--window_size frames; the Python loader always takes 90. Runs write opt.txt, metrics.jsonl,
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
from hig_tpu_torch.parallel import distributed as dist
from hig_tpu_torch.train import torch_port
from hig_tpu_torch.train.trainer import Trainer

DEFAULT_PRETRAINED = "checkpoints/t2m/t2m_motiondiffuse/model/latest.tar"


def load_pretrained(trainer: Trainer, state, path: str) -> None:
    """--pretrained (``tools/train.py:69-86``): the reference checkpoint's
    subtree (``only_language`` / ``only_motion``) into the model's
    parameters in place. Every rank converts the whole checkpoint and takes
    its cut, as a restore does (``TrainLayout.model_local``: TP's shards;
    FSDP's optimizer shards recut after). Adam's moments and the EMA keep
    their seeded values, as JAX replaces only ``params``."""
    cfg = trainer.cfg
    converted = torch_port.convert_interaction_model(
        torch_port.load_torch_state_dict(path), num_layers=cfg.num_layers,
        num_text_layers=cfg.num_text_layers, clip_layers=trainer.model_config.clip.layers,
        interaction=not cfg.no_cross_attn, cap_id=cfg.cap_id,
        only_language=cfg.only_language, only_motion=cfg.only_motion)
    torch_port.load_into(state.model, converted, trainer.layout.model_local)
    trainer.layout.restore_shards(state)


def main(argv=None, graph: bool = True):
    """Parse ``argv``, train, and return (trainer, final state). On the card
    each step replays the CUDA graph of its batch shape; ``graph=False``
    (no flag: JAX has none) runs the eager step."""
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    add_config_args(parser)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--pretrained_path", type=str, default=DEFAULT_PRETRAINED,
                        help="reference torch checkpoint for --pretrained transfer "
                             "(ref tools/train.py:48-50)")
    args = parser.parse_args(argv)
    try:
        cfg = config_from_args(args)
        model_config(cfg)  # refuses the block options the port has no blocks for
    except (ValueError, KeyError) as e:
        parser.error(str(e))
    device = resolve_device(args.device)
    if cfg.distributed:
        device = dist.initialize(device=device)

    if dist.is_primary():
        save_opt_txt(cfg, pjoin(cfg.save_root, "opt.txt"))
    mean, std = load_training_stats(cfg, write=dist.is_primary())
    dataset = PairDataset(cfg, mean, std, "train_sub.txt", times=cfg.times,
                          label_path=cfg.label_path, seed=cfg.seed)
    if dist.is_primary():
        print(f"dataset: {dataset.real_len()} clips x times={cfg.times}")
    trainer = Trainer(cfg, device, graph=graph)
    state = trainer.init_state()
    if cfg.pretrained:
        load_pretrained(trainer, state, args.pretrained_path)
        if dist.is_primary():
            print(f"loaded pretrained weights from {args.pretrained_path}")
    start_epoch = 0
    if cfg.is_continue:
        state, start_epoch, it = trainer.restore(pjoin(cfg.model_dir, "latest.pt"), state)
        print(f"resumed from epoch {start_epoch}, it {it}")
    val_dataset = None
    if cfg.eval_every_e > 0 and os.path.exists(pjoin(cfg.data_root, "val_sub.txt")):
        val_dataset = PairDataset(cfg, mean, std, "val_sub.txt", times=1,
                                  label_path=cfg.label_path, seed=cfg.seed)
    state = trainer.train(dataset, state, start_epoch=start_epoch, val_dataset=val_dataset)
    return trainer, state


if __name__ == "__main__":
    main()
