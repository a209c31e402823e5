"""Training checkpoints (counterpart of ``hig_tpu/train/checkpoint.py``).

One ``torch.save`` file per checkpoint, ``<model_dir>/latest.pt`` and
``<model_dir>/ckpt_eNNN.pt``, holding plain tensors, numbers and dicts only
(``torch.load(..., weights_only=True)`` reads it back):

  params      the model's state dict (torch layout, CPU tensors)
  opt_state   the Adam optimizer's state dict (moments and step count)
  step        optimizer steps taken
  epoch       the next epoch to run
  total_it    training iterations done
  ema_params  the exponential moving average of ``params``, when the run
              keeps one

A file is written beside its target and renamed over it, so a crash while
saving leaves the previous checkpoint whole. An epoch's ``ckpt_eNNN.pt``
holds what ``latest.pt`` was just given: :func:`save_copy` links it to
that file (a copy where the file system takes no hard link) instead of
writing the same bytes twice.
"""

from __future__ import annotations

import os
import shutil

import torch


def _cpu(state: dict) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in state.items()}


def payload_of(state, epoch: int, total_it: int) -> dict:
    """The checkpoint of ``state`` (a
    :class:`~hig_tpu_torch.train.trainer.TrainState`), CPU tensors."""
    payload = {
        "params": _cpu(state.model.state_dict()),
        "opt_state": state.optimizer.state_dict(),
        "step": int(state.step),
        "epoch": int(epoch),
        "total_it": int(total_it),
    }
    if state.ema is not None:
        payload["ema_params"] = _cpu(state.ema)
    return payload


def save_state(path: str, state, epoch: int, total_it: int) -> None:
    """Write ``state`` (a :class:`~hig_tpu_torch.train.trainer.TrainState`)."""
    write_payload(path, payload_of(state, epoch, total_it))


def write_payload(path: str, payload: dict) -> None:
    """Write a checkpoint payload beside ``path``, then rename it over."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def save_copy(src: str, dst: str) -> None:
    """``dst`` holding the checkpoint ``src`` holds: a hard link where the
    file system takes one, else a copy. A later save of ``src`` replaces
    that file rather than writing into it, so ``dst`` keeps these bytes."""
    tmp = f"{dst}.tmp"
    if os.path.exists(tmp):
        os.remove(tmp)
    try:
        os.link(src, tmp)
    except OSError:
        shutil.copyfile(src, tmp)
    os.replace(tmp, dst)


def load(path: str) -> dict:
    """The checkpoint's payload, tensors on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_state(path: str, state, local=None) -> tuple[object, int, int]:
    """Load the checkpoint into ``state`` (a TrainState of the same model)
    and return (state, epoch, total_it). Parameters, Adam's moments and the
    EMA are copied into the tensors ``state`` holds, so a CUDA graph of the
    train step (which replays on those tensors) goes on after a rollback.

    The EMA follows the run, not the file: a run with ``ema_decay`` that
    resumes from a checkpoint without EMA seeds it from the parameters; a run
    without it drops a stored EMA (and says so), since nothing would update
    it and serving would prefer the stale average. ``local`` maps the file's
    payload onto this rank's tensors (a sharded run's
    ``TrainLayout.local_payload``)."""
    payload = load(path)
    if local is not None:
        payload = local(payload)
    state.model.load_state_dict(payload["params"], strict=True)
    state.optimizer.load_state_dict(payload["opt_state"])
    state.step = int(payload["step"])
    ema = payload.get("ema_params")
    if state.ema is not None:
        source = ema if ema is not None else payload["params"]
        with torch.no_grad():
            for k, e in state.ema.items():
                e.copy_(source[k])
    elif ema is not None:
        print("checkpoint has ema_params but this run has no --ema_decay; "
              "discarding the stored EMA (serving will use the live params)")
    return state, int(payload["epoch"]), int(payload["total_it"])
