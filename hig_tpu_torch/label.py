"""Role discovery and pseudo-labels, pipeline stage 1-2 (counterpart of
``tools/label_data.py``), with a PIT run of ``python -m hig_tpu_torch.train``.

  --label_model  discover each class's role orientation on the annotated
                 clips (--ann_split, default test_ann_ids.txt, oriented by
                 --label_path, default <data_root>/test_active_anns.json)
                 → <save_root>/pit_labels.json
  --save_label   pseudo-label every clip of train_sub.txt with that
                 orientation → <data_root>/pseudo_labels.json, the
                 --label_path of the supervised stage

    python -m hig_tpu_torch.label --opt_path checkpoints/ntu_mul/pit/opt.txt \\
        --label_model --save_label

The run's model (widths, --cap_id, --no_eff) comes from its opt.txt, its
raw (not EMA) parameters from model/<which_epoch>.pt and the feature
statistics from meta/. The denoiser runs in eval mode: --blocks fused (the
default) puts the efficient model's self-attention and interaction blocks
through the fused-block kernel, --blocks projected through the
projected-attention kernel; a --no_eff run goes through the flash-attention
kernel. A bfloat16 run (compute_dtype, fast_ln, rms_norm) labels in
bfloat16 on its float32 parameters, as JAX's scorer does; an rms_norm run
has no fused block, so its default is --blocks projected and --blocks
fused is refused. A --no_cross_attn run has no interaction block (B1 runs
its self-attention blocks only), and a --single_transformer run's layers
never fuse, as in JAX: its merged timeline takes the projected-attention
kernel whatever --blocks says.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from os.path import join as pjoin

from hig_tpu_torch import resolve_device
from hig_tpu_torch.config import load_opt_txt, model_config
from hig_tpu_torch.data.dataset import PairDataset
from hig_tpu_torch.diffusion import gaussian as g
from hig_tpu_torch.models.interaction_model import InteractionModel
from hig_tpu_torch.parallel import distributed as dist
from hig_tpu_torch.serve import load_stats
from hig_tpu_torch.train import checkpoint as ckpt
from hig_tpu_torch.train import labeling


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--opt_path", required=True, help="the PIT run's opt.txt")
    parser.add_argument("--which_epoch", default="latest",
                        help="checkpoint under model/ (latest, ckpt_e004, ...)")
    parser.add_argument("--label_path", default=None,
                        help="human role annotations (default <data_root>/test_active_anns.json)")
    parser.add_argument("--ann_split", default="test_ann_ids.txt")
    parser.add_argument("--label_model", action="store_true")
    parser.add_argument("--save_label", action="store_true")
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--blocks", choices=("fused", "projected"), default=None,
                        help="kernel of the efficient blocks (default fused; "
                             "projected for an rms_norm run)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    dist.require_one_process("python -m hig_tpu_torch.label")

    cfg = load_opt_txt(args.opt_path)
    if cfg.no_eff and args.blocks is not None:
        parser.error("--blocks picks the kernel of the efficient blocks; the run's "
                     "quadratic (--no_eff) model has none to pick")
    # an RMSNorm model has no fused block (its kernel computes LayerNorm)
    blocks = args.blocks or ("projected" if cfg.rms_norm else "fused")
    try:
        mcfg = dataclasses.replace(model_config(cfg),
                                   fused_blocks=not cfg.no_eff and blocks == "fused")
    except ValueError as e:
        parser.error(str(e))
    device = resolve_device(args.device)
    model = InteractionModel(mcfg)
    model.load_state_dict(ckpt.load(pjoin(cfg.model_dir, f"{args.which_epoch}.pt"))["params"],
                          strict=True)
    model.to(device)
    mean, std = load_stats(cfg.meta_dir, cfg.dim_pose)
    sched = g.make_schedule(g.linear_betas(cfg.diffusion_steps))
    scorer = labeling.make_assignment_scorer(model, sched)

    if args.label_model:
        label_path = args.label_path or pjoin(cfg.data_root, "test_active_anns.json")
        annotated = PairDataset(cfg, mean, std, args.ann_split, label_path=label_path)
        roles = labeling.discover_roles(scorer, annotated, args.batch_size, device,
                                        cap_id=cfg.cap_id)
        out = pjoin(cfg.save_root, "pit_labels.json")
        labeling.save_json(roles, out)
        print(f"wrote {out}")

    if args.save_label:
        with open(pjoin(cfg.save_root, "pit_labels.json")) as f:
            roles = json.load(f)
        train_ds = PairDataset(cfg, mean, std, "train_sub.txt")
        labels = labeling.pseudo_label(scorer, train_ds, args.batch_size, roles, device,
                                       cap_id=cfg.cap_id)
        out = pjoin(cfg.data_root, "pseudo_labels.json")
        labeling.save_json(labels, out)
        print(f"wrote {out} ({len(labels)} clips)")


if __name__ == "__main__":
    main()
