"""Train an evaluator model (counterpart of ``tools/train_evaluation_model.py``
and ``tools/train_consistency_evaluation_model.py``).

  --kind classifier    the 26-way interaction classifier (MotionEncoder)
                       on train_sub.txt, validated on val_sub.txt
  --kind consistency   the genuine/mismatched pair model, on the mismatch
                       dataset of the same splits (Adam at lr / 5)

The evaluator takes the run's widths (--num_layers, --latent_dim, --ff_size,
--num_heads) and trains for epochs 1 .. --num_epochs − 1. The run writes
opt.txt, meta/{mean,std}.npy and model/best_eval_model.pt under
<checkpoints_dir>/<dataset_name>/<name>; ``python -m
hig_tpu_torch.evaluate`` reads the classifier from eval_model/model and the
consistency model from consistency_eval_model/model by default:

    python -m hig_tpu_torch.eval.train --kind classifier --name eval_model
    python -m hig_tpu_torch.eval.train --kind consistency \\
        --name consistency_eval_model
"""

from __future__ import annotations

import argparse
from os.path import join as pjoin

from hig_tpu_torch.config import add_config_args, config_from_args, save_opt_txt
from hig_tpu_torch.data.dataset import PairDataset, PairMismatchDataset, load_training_stats
from hig_tpu_torch.eval.trainer import EvalModelTrainer
from hig_tpu_torch.models.eval_models import KINDS


def main(argv=None):
    """Parse ``argv``, train, and return (trainer, model, best validation
    accuracy, history)."""
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--kind", choices=KINDS, required=True)
    add_config_args(parser)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    try:
        cfg = config_from_args(args)
    except (ValueError, KeyError) as e:
        parser.error(str(e))
    trainer = EvalModelTrainer(cfg, args.kind, args.device)

    save_opt_txt(cfg, pjoin(cfg.save_root, "opt.txt"))
    mean, std = load_training_stats(cfg)
    if args.kind == "classifier":
        train_ds = PairDataset(cfg, mean, std, "train_sub.txt", train_eval=True)
        val_ds = PairDataset(cfg, mean, std, "val_sub.txt", train_eval=True)
    else:
        train_ds = PairMismatchDataset(cfg, mean, std, "train_sub.txt")
        val_ds = PairMismatchDataset(cfg, mean, std, "val_sub.txt")
    model, best_acc, history = trainer.train(train_ds, val_ds)
    print(f"best val accuracy: {best_acc:.4f}")
    return trainer, model, best_acc, history


if __name__ == "__main__":
    main()
