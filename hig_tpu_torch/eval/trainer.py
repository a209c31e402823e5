"""Trainers of the evaluator models (counterpart of
``hig_tpu/train/eval_trainer.py``): the 26-way classifier
(``MotionEncoder``, Adam at ``lr``) and the consistency model
(``MotionConsistencyEvalModel``, Adam at ``lr / 5``), both on softmax
cross-entropy, with optax's Adam defaults (b1 0.9, b2 0.999, eps 1e-8) and
no clip. The epoch loop is the reference's: epochs 1 .. num_epochs − 1, a
training pass (shuffled, last batch dropped), a validation pass (in order,
the last batch wrapped round), and ``<model_dir>/best_eval_model.pt``
written whenever the validation accuracy improves (and after the first
epoch in any case). Weights start from the seeded random tree of the
weight bridge (every leaf nonzero).
"""

from __future__ import annotations

import os
import time
from os.path import join as pjoin
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from hig_tpu_torch import resolve_device
from hig_tpu_torch.config import ExperimentConfig
from hig_tpu_torch.data.dataset import epoch_batches
from hig_tpu_torch.data.vocab import NUM_CLASSES
from hig_tpu_torch.models.eval_models import EvalModelConfig, eval_model
from hig_tpu_torch.weights import load_flax_tree, random_flax_tree

BEST = "best_eval_model.pt"


def eval_model_config(cfg: ExperimentConfig, kind: str) -> EvalModelConfig:
    """The evaluator of ``kind`` at the run's widths; it reads motions
    without the 4 foot-contact channels."""
    return EvalModelConfig(kind=kind, input_feats=cfg.dim_pose - 4,
                           num_frames=cfg.max_motion_length, latent_dim=cfg.latent_dim,
                           ff_size=cfg.ff_size, num_layers=cfg.num_layers,
                           num_heads=cfg.num_heads,
                           class_num=NUM_CLASSES if kind == "classifier" else 2)


def logits_of(model: torch.nn.Module, motion: torch.Tensor, lengths: torch.Tensor):
    """Class logits of either evaluator model."""
    out = model(motion, lengths)
    return out[0] if isinstance(out, tuple) else out


def load_eval_model(cfg: EvalModelConfig, path: str, device) -> torch.nn.Module:
    """An evaluator model from its ``best_eval_model.pt``, in eval mode."""
    model = eval_model(cfg)
    model.load_state_dict(torch.load(path, map_location="cpu", weights_only=True)["params"],
                          strict=True)
    return model.to(device).eval()


def make_eval_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer) -> Callable:
    """``step(motion, lengths, labels) -> {"loss", "acc"}``: one Adam update
    on the mean softmax cross-entropy."""

    def step(motion, lengths, labels):
        optimizer.zero_grad(set_to_none=True)
        logits = logits_of(model, motion, lengths)
        loss = F.cross_entropy(logits, labels)
        loss.backward()
        optimizer.step()
        acc = (logits.argmax(-1) == labels).float().mean()
        return {"loss": loss.detach(), "acc": acc}

    return step


class EvalModelTrainer:
    """The epoch loop with best-validation-accuracy selection."""

    def __init__(self, cfg: ExperimentConfig, kind: str = "classifier", device=None):
        self.cfg = cfg
        self.kind = kind
        self.device = resolve_device(device)
        self.model_config = eval_model_config(cfg, kind)
        self.lr = cfg.lr if kind == "classifier" else cfg.lr / 5
        self.step_seconds: list[float] = []  # host time of each step, metrics read back

    def init_model(self) -> torch.nn.Module:
        model = eval_model(self.model_config)
        load_flax_tree(model, random_flax_tree(self.model_config, self.cfg.seed)["params"])
        return model.to(self.device)

    def _labels(self, batch) -> np.ndarray:
        return batch["dummy_label"] if self.kind == "consistency" else batch["class_id"]

    def _tensors(self, batch):
        motion = torch.from_numpy(batch["motion"][..., :-4].copy()).to(self.device)
        lengths = torch.from_numpy(batch["lengths"]).long().to(self.device)
        labels = torch.from_numpy(self._labels(batch)).long().to(self.device)
        return motion, lengths, labels

    def _epoch(self, model, step, dataset, epoch: int, train: bool) -> tuple[float, float]:
        """(mean accuracy, mean loss) over the epoch's batches."""
        model.train(train)
        accs, losses = [], []
        for batch in epoch_batches(dataset, self.cfg.batch_size, epoch, shuffle=train,
                                   drop_last=train, seed=self.cfg.seed):
            motion, lengths, labels = self._tensors(batch)
            if train:
                t0 = time.perf_counter()
                metrics = {k: float(v) for k, v in step(motion, lengths, labels).items()}
                self.step_seconds.append(time.perf_counter() - t0)
            else:
                with torch.no_grad():
                    logits = logits_of(model, motion, lengths)
                metrics = {"acc": float((logits.argmax(-1) == labels).float().mean()),
                           "loss": float(F.cross_entropy(logits, labels))}
            accs.append(metrics["acc"])
            losses.append(metrics["loss"])
        if not accs:
            return 0.0, float("nan")
        return float(np.mean(accs)), float(np.mean(losses))

    def train(self, train_dataset, val_dataset, model=None, num_epochs=None, log=print):
        """Train for epochs 1 .. num_epochs − 1; returns (model, best
        validation accuracy, per-epoch history)."""
        model = model if model is not None else self.init_model()
        num_epochs = num_epochs or self.cfg.num_epochs
        optimizer = torch.optim.Adam(model.parameters(), lr=self.lr, betas=(0.9, 0.999),
                                     eps=1e-8)
        step = make_eval_train_step(model, optimizer)
        best_acc, best_path, saved_once = 0.0, pjoin(self.cfg.model_dir, BEST), False
        history = []
        for epoch in range(1, num_epochs):
            train_acc, train_loss = self._epoch(model, step, train_dataset, epoch, True)
            val_acc, val_loss = self._epoch(model, step, val_dataset, epoch, False)
            history.append({"epoch": epoch, "train_acc": train_acc, "train_loss": train_loss,
                            "val_acc": val_acc, "val_loss": val_loss})
            log(f"[{self.kind}] epoch {epoch} train_acc {train_acc:.3f} train_loss "
                f"{train_loss:.4f} val_acc {val_acc:.3f}")
            if val_acc > best_acc or not saved_once:
                best_acc = max(best_acc, val_acc)
                save_eval_model(best_path, model)
                saved_once = True
                log(f"[{self.kind}] best acc {best_acc:.3f}: model saved")
        return model, best_acc, history


def save_eval_model(path: str, model: torch.nn.Module) -> None:
    """The model's parameters as {"params": state dict}, written beside
    ``path`` and renamed over it."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({"params": {k: v.detach().cpu() for k, v in model.state_dict().items()}},
               f"{path}.tmp")
    os.replace(f"{path}.tmp", path)
