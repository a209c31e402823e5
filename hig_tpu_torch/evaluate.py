"""The five-metric evaluation: Accuracy, FID, Consistency, Diversity and
MultiModality of a trained generator (counterpart of ``tools/evaluation.py``).

For each replication the test clips (--split_file) are shuffled and each
draws one of its caption pairs, one motion pair is generated per clip at
the clip's length (up to --gen_T, default max_motion_length) in chunks of
--gen_batch pairs, and the generated and ground-truth pairs are embedded by
the two evaluator models (``python -m hig_tpu_torch.eval.train``; by
default <checkpoints_dir>/<dataset_name>/{eval_model,
consistency_eval_model}/model/best_eval_model.pt). Outputs under
<result_path>/<name>/<model_name>: t2m_fin_evaluation<file_id>.log, per
replication confusion_matrix<file_id>_rep<r>.npy (and .png when matplotlib
is installed), and summary<file_id>.json, {metric: {"ground truth" |
"text2motion": [mean, 1.96·σ/√n]}}.

The generator is the run's --opt_path, its model/<model_name>.pt (the EMA
parameters when the run kept them), sampled with the run's sampler and
ddim_steps unless --sampler / --ddim_steps say otherwise, and with
--guidance_scale (default the run's). --blocks fused (the default) runs
the efficient model's self-attention and interaction blocks through the
fused-block kernel, --blocks projected through the projected-attention
kernel (the default of an rms_norm run); a --no_eff run goes through the
flash-attention kernel. The ablations come from the run's opt.txt: a
--no_cross_attn run has no interaction block, and a --single_transformer
run's merged 2T-token timeline never fuses (the projected-attention kernel
over 2T rows, 392 at the default --gen_T). A run with
``compute_dtype: bfloat16`` (``rms_norm`` too) samples in bfloat16 through
the kernels' bfloat16 forms; --fast_ln keeps the generator's efficient-block
LayerNorm statistics in bfloat16, as ``tools/evaluation.py --fast_ln``
does for an existing checkpoint. The evaluator models are plain PyTorch
in float32. On the card the sampler is one CUDA graph per chunk shape
(``make_sampler``), captured at the first chunk of that shape; each chunk's
generator, seeded by (seed, replication, chunk), hands its state to the
graph and back.

    python -m hig_tpu_torch.evaluate --opt_path checkpoints/ntu_mul/interaction/opt.txt \\
        --replication_times 20 --sampler ddim
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pickle
import zlib
from os.path import join as pjoin

import numpy as np

from hig_tpu_torch import resolve_device
from hig_tpu_torch.config import SAMPLERS, load_opt_txt, model_config
from hig_tpu_torch.data.dataset import PairDataset
from hig_tpu_torch.data.vocab import CAP2KEY
from hig_tpu_torch.diffusion import gaussian as g
from hig_tpu_torch.eval.evaluator import (
    evaluate_once,
    generate_test_set,
    make_embedder,
    summarize,
)
from hig_tpu_torch.eval.test import save_confusion_png
from hig_tpu_torch.eval.trainer import BEST, eval_model_config, load_eval_model
from hig_tpu_torch.models.tokenizer import tokenize
from hig_tpu_torch.parallel import distributed as dist
from hig_tpu_torch.serve import build_model, load_stats
from hig_tpu_torch.train.trainer import make_sampler


def draw_captions(sample: dict, rep: int, seed: int, cap_same: bool) -> dict:
    """The caption pair of one clip in replication ``rep``: drawn from a
    generator seeded by (seed, rep, crc32 of the clip's name), so each
    replication draws anew."""
    rng_cap = np.random.default_rng((seed, rep, zlib.crc32(sample["name"].encode())))
    caption1, caption2 = sample["texts"][int(rng_cap.integers(len(sample["texts"])))]
    if cap_same:
        caption2 = caption1
    return dict(motion=sample["motion"], length=sample["length"], class_id=sample["class_id"],
                caption1=caption1, caption2=caption2)


def eval_samples(dataset: PairDataset, mean: np.ndarray, std: np.ndarray) -> list[dict]:
    """Every test clip whole, normalized, init row first, with its true
    length: generation is conditioned on it and a random 90-frame window
    is taken afterwards."""
    out = []
    for clip in dataset.clips:
        full = clip.motion.copy()  # (2, T, D), init row last
        full[:, :-1] = (full[:, :-1] - mean[:-4]) / std[:-4]
        full[:, -1, :4] = (full[:, -1, :4] - mean[-4:]) / std[-4:]
        init_first = np.concatenate([full[:, -1:], full[:, :-1]], axis=1)
        out.append(dict(motion=init_first.astype(np.float32), length=int(clip.length),
                        class_id=int(clip.class_id), texts=clip.texts, name=clip.name))
    return out


def main(argv=None) -> dict:
    """Parse ``argv`` and evaluate; returns {"summary", "replications",
    "save_dir"}."""
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--opt_path", required=True)
    parser.add_argument("--model_name", default="latest")
    parser.add_argument("--split_file", default="test_sub.txt")
    parser.add_argument("--file_id", default="0")
    parser.add_argument("--eval_model_dir", default=None)
    parser.add_argument("--consistency_model_dir", default=None)
    parser.add_argument("--replication_times", type=int, default=1)
    parser.add_argument("--sampler", choices=SAMPLERS, default=None)
    parser.add_argument("--gen_T", type=int, default=None,
                        help="generation length (default: max_motion_length)")
    parser.add_argument("--ddim_steps", type=int, default=None)
    parser.add_argument("--guidance_scale", type=float, default=None)
    parser.add_argument("--fast_ln", action="store_true",
                        help="LayerNorm statistics in the compute dtype (the run's fast_ln)")
    parser.add_argument("--mm_num_times", type=int, default=None,
                        help="MultiModality comparisons (default 15)")
    parser.add_argument("--mm_num_repeats", type=int, default=None,
                        help="per-class MultiModality subset size cap (default 20)")
    parser.add_argument("--gen_batch", type=int, default=512,
                        help="pairs per sampler call")
    parser.add_argument("--cache_generations", action="store_true",
                        help="pickle each replication's generated set")
    parser.add_argument("--use_cache", action="store_true",
                        help="reuse the pickled generations when present")
    parser.add_argument("--blocks", choices=("fused", "projected"), default=None,
                        help="kernel of the efficient blocks (default fused)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    dist.require_one_process("python -m hig_tpu_torch.evaluate")

    cfg = load_opt_txt(args.opt_path)
    if args.fast_ln:
        cfg.fast_ln = True
    if cfg.no_eff and args.blocks is not None:
        parser.error("--blocks picks the kernel of the efficient blocks; the run's "
                     "quadratic (--no_eff) model has none to pick")
    cfg.sampler = args.sampler or cfg.sampler
    cfg.ddim_steps = args.ddim_steps or cfg.ddim_steps
    if args.guidance_scale is not None:
        cfg.guidance_scale = args.guidance_scale
    device = resolve_device(args.device)
    mean, std = load_stats(cfg.meta_dir, cfg.dim_pose)
    # an RMSNorm model has no fused block (its kernel computes LayerNorm)
    fused = not cfg.no_eff and (args.blocks or ("projected" if cfg.rms_norm else "fused")) \
        == "fused"
    try:
        mcfg = dataclasses.replace(model_config(cfg), fused_blocks=fused)
    except ValueError as e:
        parser.error(str(e))
    model = build_model(mcfg, device, params=pjoin(cfg.model_dir, f"{args.model_name}.pt"))

    root = pjoin(cfg.checkpoints_dir, cfg.dataset_name)
    eval_dir = args.eval_model_dir or pjoin(root, "eval_model", "model")
    cons_dir = args.consistency_model_dir or pjoin(root, "consistency_eval_model", "model")
    embed = make_embedder(
        load_eval_model(eval_model_config(cfg, "classifier"), pjoin(eval_dir, BEST), device),
        load_eval_model(eval_model_config(cfg, "consistency"), pjoin(cons_dir, BEST), device))

    samples = eval_samples(PairDataset(cfg, mean, std, args.split_file, eval_mode=True),
                           mean, std)
    T_gen = args.gen_T or cfg.max_motion_length
    try:
        sample_fn = make_sampler(model, g.make_schedule(g.linear_betas(cfg.diffusion_steps)),
                                 T=T_gen, dim_pose=cfg.dim_pose, sampler=cfg.sampler,
                                 ddim_steps=cfg.ddim_steps, guidance_scale=cfg.guidance_scale)
    except ValueError as e:
        parser.error(str(e))
    if cfg.cap_id:
        def tokens_of(s):
            return np.asarray([CAP2KEY[s["caption1"]], CAP2KEY[s["caption2"]]], np.int64)
    else:
        def tokens_of(s):
            return np.stack([tokenize(s["caption1"])[0], tokenize(s["caption2"])[0]])

    save_dir = pjoin(cfg.result_path, cfg.name, args.model_name)
    os.makedirs(save_dir, exist_ok=True)
    log_file = pjoin(save_dir, f"t2m_fin_evaluation{args.file_id}.log")
    gen_kwargs = {} if args.mm_num_repeats is None else {"mm_num_repeats": args.mm_num_repeats}
    eval_kwargs = {} if args.mm_num_times is None else {"mm_num_times": args.mm_num_times}
    replications = []
    with open(log_file, "w") as f:
        def report(line):
            print(line)
            print(line, file=f, flush=True)

        for rep in range(args.replication_times):
            # each replication shuffles the clips (which ones land in a
            # class's MultiModality subset) and draws their captions anew
            perm = np.random.default_rng((cfg.seed, rep)).permutation(len(samples))
            rep_samples = [draw_captions(samples[int(i)], rep, cfg.seed, cfg.cap_same)
                           for i in perm]
            gt_items = [dict(motion=s["motion"], length=s["length"], class_id=s["class_id"])
                        for s in rep_samples]
            cache_path = pjoin(save_dir, f"generations{args.file_id}_rep{rep}.pkl")
            if args.use_cache and os.path.exists(cache_path):
                with open(cache_path, "rb") as cf:  # written by this tool
                    gen = pickle.load(cf)
                print(f"loaded cached generations from {cache_path}")
            else:
                graphs_before = set(sample_fn.graphs)
                gen = generate_test_set(sample_fn, rep_samples, tokens_of, T_gen, device,
                                        seed=cfg.seed, rep=rep, batch_size=args.gen_batch,
                                        **gen_kwargs)
                for key in set(sample_fn.graphs) - graphs_before:
                    print(f"captured the sampler for chunks of shape {key[0]}: "
                          f"{json.dumps(sample_fn.graphs[key].summary())}")
                if args.cache_generations or args.use_cache:
                    with open(cache_path, "wb") as cf:
                        pickle.dump(gen, cf)
            res = evaluate_once(embed, gt_items, gen, np.random.default_rng(rep), **eval_kwargs)
            replications.append(res)
            for metric, vals in res.items():
                if not metric.startswith("_"):
                    for model_name, v in vals.items():
                        report(f"---> [{model_name}] {metric}: {v:.4f}")
            cm = res["_confusion"]["text2motion"]
            np.save(pjoin(save_dir, f"confusion_matrix{args.file_id}_rep{rep}.npy"), cm)
            save_confusion_png(cm, pjoin(save_dir, f"confusion_matrix{args.file_id}_rep{rep}.png"))

        summary = summarize(replications, args.replication_times)
        for metric, models in summary.items():
            report(f"========== {metric} Summary ==========")
            for model_name, (m, ci) in models.items():
                report(f"---> [{model_name}] Mean: {m:.4f} CInterval: {ci:.4f}")
    with open(pjoin(save_dir, f"summary{args.file_id}.json"), "w") as jf:
        json.dump({m: {k: list(v) for k, v in d.items()} for m, d in summary.items()}, jf)
    print(f"wrote {log_file}")
    return {"summary": summary, "replications": replications, "save_dir": save_dir,
            "graphs": {key: call.summary() for key, call in sample_fn.graphs.items()}}


if __name__ == "__main__":
    main()
