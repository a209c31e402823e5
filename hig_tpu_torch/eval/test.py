"""Test a trained evaluator model (counterpart of
``tools/test_evaluation_model.py`` and
``tools/test_consistency_evaluation_model.py``).

  --kind classifier    accuracy over --split_file and the confusion matrix,
                       <save_root>/confusion_matrix_test.npy (and .png when
                       matplotlib is installed)
  --kind consistency   accuracy overall and per class on the mismatch
                       dataset of --split_file

    python -m hig_tpu_torch.eval.test --kind classifier \\
        --opt_path checkpoints/ntu_mul/eval_model/opt.txt
"""

from __future__ import annotations

import argparse
from collections import defaultdict
from os.path import join as pjoin

import numpy as np
import torch

from hig_tpu_torch import resolve_device
from hig_tpu_torch.config import load_opt_txt
from hig_tpu_torch.data.dataset import PairDataset, PairMismatchDataset, epoch_batches
from hig_tpu_torch.eval.evaluator import confusion
from hig_tpu_torch.eval.trainer import BEST, eval_model_config, load_eval_model, logits_of
from hig_tpu_torch.models.eval_models import KINDS
from hig_tpu_torch.serve import load_stats


def save_confusion_png(cm: np.ndarray, path: str) -> bool:
    """Draw the confusion matrix when matplotlib is installed; returns
    whether it did."""
    try:
        import matplotlib
    except ImportError:
        return False
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 6))
    im = ax.imshow(cm, cmap="viridis")
    ax.set_xlabel("predicted class")
    ax.set_ylabel("true class")
    fig.colorbar(im, ax=ax)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return True


def predictions(model, dataset, cfg, device, keep_wrapped: bool = False):
    """(predicted classes, labels, class ids) over one in-order pass; the
    last batch wraps round and the wrapped entries are dropped unless
    ``keep_wrapped``."""
    preds, labels, class_ids = [], [], []
    for batch in epoch_batches(dataset, cfg.batch_size, 0, shuffle=False, drop_last=False):
        motion = torch.from_numpy(batch["motion"][..., :-4].copy()).to(device)
        lengths = torch.from_numpy(batch["lengths"]).long().to(device)
        with torch.no_grad():
            preds.extend(logits_of(model, motion, lengths).argmax(-1).cpu().tolist())
        labels.extend(batch.get("dummy_label", batch["class_id"]).tolist())
        class_ids.extend(batch["class_id"].tolist())
    n = len(preds) if keep_wrapped else len(dataset)
    return np.asarray(preds[:n]), np.asarray(labels[:n]), np.asarray(class_ids[:n])


def main(argv=None):
    """Parse ``argv``, test, and return the accuracy (and, for the
    classifier, the confusion matrix)."""
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--kind", choices=KINDS, required=True)
    parser.add_argument("--opt_path", required=True, help="the evaluator run's opt.txt")
    parser.add_argument("--split_file", default="test_sub.txt")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    cfg = load_opt_txt(args.opt_path)
    device = resolve_device(args.device)
    mean, std = load_stats(cfg.meta_dir, cfg.dim_pose)
    model = load_eval_model(eval_model_config(cfg, args.kind), pjoin(cfg.model_dir, BEST),
                            device)
    if args.kind == "classifier":
        ds = PairDataset(cfg, mean, std, args.split_file, train_eval=True)
        preds, gts, _ = predictions(model, ds, cfg, device)
        acc = float((preds == gts).mean())
        print(f"test accuracy: {acc:.4f} over {len(gts)} samples")
        cm = confusion(preds, gts)
        out = pjoin(cfg.save_root, "confusion_matrix_test.npy")
        np.save(out, cm)
        png = save_confusion_png(cm, pjoin(cfg.save_root, "confusion_matrix_test.png"))
        print(f"wrote {out}" + (" (+ .png)" if png else ""))
        return acc, cm

    ds = PairMismatchDataset(cfg, mean, std, args.split_file)
    # the JAX tool counts the wrapped entries of the last batch too
    preds, labels, class_ids = predictions(model, ds, cfg, device, keep_wrapped=True)
    per_class = defaultdict(lambda: [0, 0])
    for p, label, c in zip(preds, labels, class_ids):
        per_class[int(c)][0] += int(p == label)
        per_class[int(c)][1] += 1
    acc = float((preds == labels).mean())
    print(f"overall accuracy: {acc:.4f} ({len(labels)} samples)")
    for c in sorted(per_class):
        hit, n = per_class[c]
        print(f"class {c:2d}: {hit / n:.4f} ({n})")
    return acc, None


if __name__ == "__main__":
    main()
