"""Graft a classifier-free-guidance null branch onto a trained checkpoint
(counterpart of ``tools/add_cfg_branch.py``).

Copies a trained run without caption dropout into a new run whose model
carries the zero-initialized ``null_xf_proj`` and ``null_xf_token`` and
whose opt.txt sets ``--cond_drop_prob``, so that a short ``--is_continue``
finetune teaches the null branch while the conditional model starts at the
donor's weights: every donor parameter lands by name, the two null
parameters are the only new ones, and unguided (w = 1) sampling of the
grafted checkpoint is the donor's, bit for bit. The EMA comes from the
donor's EMA when it has one, else from the grafted parameters (with
``--ema_decay``); Adam starts fresh, and the step, epoch and iteration are
kept. The run's mean.npy and std.npy are copied beside the new opt.txt.
The donor must be a supervised run (``--label_path``): caption dropout
belongs to that stage.

    python -m hig_tpu_torch.add_cfg_branch \\
        --opt_path checkpoints/ntu_mul/interaction/opt.txt \\
        --name interaction_cfg --cond_drop_prob 0.1
    python -m hig_tpu_torch.train --name interaction_cfg ... --cond_drop_prob 0.1 \\
        --num_epochs <donor + K> --is_continue
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
from os.path import join as pjoin

import torch

from hig_tpu_torch.config import load_opt_txt, model_config, save_opt_txt
from hig_tpu_torch.models.interaction_model import InteractionModel
from hig_tpu_torch.train import checkpoint as ckpt
from hig_tpu_torch.train.trainer import TrainState, make_optimizer

NULL_PARAMS = ("null_xf_proj", "null_xf_token")


def graft(donor: dict, fresh: dict) -> tuple[dict, list[str]]:
    """Every entry of ``fresh`` (a new model's state dict) from ``donor`` by
    name, shapes equal; returns (grafted, the names the donor lacks), which
    must be exactly the null parameters, zero. Raises SystemExit on a shape
    mismatch, a donor entry left over or other new entries."""
    left = dict(donor)
    grafted, added = {}, []
    for name, leaf in fresh.items():
        if name in left:
            d = left.pop(name)
            if d.shape != leaf.shape:
                raise SystemExit(f"shape mismatch at {name}: {tuple(d.shape)} vs "
                                 f"{tuple(leaf.shape)}")
            grafted[name] = d.clone()
        else:
            added.append(name)
            grafted[name] = torch.zeros(leaf.shape, dtype=leaf.dtype)
    if left:
        raise SystemExit(f"donor leaves not consumed: {sorted(left)[:4]}")
    if sorted(added) != sorted(NULL_PARAMS):
        raise SystemExit(f"unexpected new leaves: {added}")
    return grafted, added


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--opt_path", required=True,
                        help="donor run's opt.txt (trained WITHOUT cond_drop_prob)")
    parser.add_argument("--model_name", default="latest",
                        help="the donor's checkpoint under model/ (latest, ckpt_e004, ...)")
    parser.add_argument("--name", required=True, help="new run's name")
    parser.add_argument("--cond_drop_prob", type=float, default=0.1)
    args = parser.parse_args(argv)

    cfg = load_opt_txt(args.opt_path)
    if cfg.cond_drop_prob > 0:
        raise SystemExit("donor already has cond_drop_prob > 0 — nothing to add")
    payload = ckpt.load(pjoin(cfg.model_dir, f"{args.model_name}.pt"))
    try:
        cfg_new = dataclasses.replace(cfg, name=args.name, cond_drop_prob=args.cond_drop_prob,
                                      is_continue=False)
    except ValueError as e:
        raise SystemExit(str(e)) from e
    # the graft is a host-side edit of state dicts: the new model is built on
    # the meta device (no init of its own) and takes the grafted tensors
    with torch.device("meta"):
        model = InteractionModel(model_config(cfg_new))
    params, added = graft(payload["params"], model.state_dict())
    model.load_state_dict(params, strict=True, assign=True)
    ema = None
    if cfg_new.ema_decay > 0:
        source = payload.get("ema_params")
        ema = graft(source, params)[0] if source is not None else \
            {k: v.clone() for k, v in params.items()}
    out = TrainState(model=model, optimizer=make_optimizer(cfg_new, model),
                     step=payload["step"], ema=ema)
    os.makedirs(cfg_new.meta_dir, exist_ok=True)
    for stat in ("mean.npy", "std.npy"):
        src = pjoin(cfg.meta_dir, stat)
        if os.path.exists(src):
            shutil.copyfile(src, pjoin(cfg_new.meta_dir, stat))
    save_opt_txt(cfg_new, pjoin(cfg_new.save_root, "opt.txt"))
    ckpt.save_state(pjoin(cfg_new.model_dir, "latest.pt"), out, epoch=payload["epoch"],
                    total_it=payload["total_it"])
    print(f"grafted {len(params) - len(added)} leaves from {cfg.name}@{args.model_name} "
          f"(epoch {payload['epoch']}, it {payload['total_it']}); added {sorted(added)}")
    print(f"new experiment: {cfg_new.save_root} — finetune with python -m "
          f"hig_tpu_torch.train --name {args.name} --cond_drop_prob {args.cond_drop_prob} "
          f"--is_continue")
    return cfg_new


if __name__ == "__main__":
    main()
