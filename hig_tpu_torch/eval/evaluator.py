"""The evaluation harness: generate → window → embed → five metrics
(counterpart of ``hig_tpu/eval/evaluator.py``).

For every test clip a motion pair is generated from its captions at the
clip's length, generated and ground-truth pairs are windowed to the
91-token layout, both are embedded by the trained classifier
(``MotionEncoder``) and consistency model, and Accuracy, FID, Consistency,
Diversity and MultiModality are computed; :func:`summarize` gives mean ±
1.96·σ/√n over replications. The numpy ``rng`` of one replication is
consumed in the JAX package's order (windows of the generated set, of the
ground truth twice, the diversity draws, then the MultiModality windows and
draws), so the same seed gives the same windows and draws.

Protocol constants of the reference: 20 MultiModality repeats per class, 15
comparisons, 300 diversity pairs, evaluator batches of 32.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Callable

import numpy as np
import torch

from hig_tpu_torch.eval import metrics as M
from hig_tpu_torch.train.trainer import step_generator

MM_NUM_REPEATS = 20
MM_NUM_TIMES = 15
DIVERSITY_TIMES = 300
EVAL_BATCH = 32


def window_rows(motion: np.ndarray, m_length: int, rng: np.random.Generator,
                num_frames: int = 90) -> np.ndarray:
    """Window a (2, T, D) clip whose row 0 is the init token to (2, 91, D):
    truncate to ``m_length`` rows, roll the init row last, then take the
    training window (init row first, a random ``num_frames`` window, short
    clips padded with their last frame)."""
    clip = motion[:, :m_length]
    rolled = np.concatenate([clip[:, 1:], clip[:, :1]], axis=1)
    nframes = m_length - 1
    if nframes < num_frames:
        padding = (nframes - 1) * np.ones(num_frames - nframes, dtype=int)
        ix = np.concatenate(([nframes], np.arange(nframes), padding))
    else:
        shift_max = nframes - num_frames
        shift = int(rng.integers(0, shift_max if shift_max > 0 else 1))
        ix = np.concatenate(([nframes], shift + np.arange(num_frames)))
    return rolled[:, ix]


@dataclasses.dataclass
class GeneratedSet:
    """The generated test set and the MultiModality groups."""

    motions: list  # per test clip: dict(motion (2, T_gen, D), length, class_id)
    mm_groups: dict  # class_id → generated items (at most MM_NUM_REPEATS + 1)
    gt_mm_groups: dict  # class_id → the same clips' ground truth


def generate_test_set(sample_fn: Callable, eval_samples: list[dict], tokens_of: Callable,
                      T_gen: int, device, seed: int = 0, rep: int = 0, batch_size: int = 512,
                      mm_num_repeats: int = MM_NUM_REPEATS,
                      draws: Callable | None = None) -> GeneratedSet:
    """One generated pair per test clip, in chunks of ``batch_size`` pairs a
    sampler call, and the per-class MultiModality subsets. Chunk ``c``
    samples with ``**draws(c, b)`` (the sampler's ``noise=`` and
    ``step_noise=`` of its b pairs; a graphed sampler refuses a callable
    ``step_noise``) when given, else with a generator seeded by (seed, rep,
    c), whose state a graphed sampler hands to its graph and back."""
    motions: list = []
    mm_groups: dict[int, list] = {}
    gt_mm_groups: dict[int, list] = {}
    mm_count: dict[int, int] = {}
    for c, lo in enumerate(range(0, len(eval_samples), batch_size)):
        chunk = eval_samples[lo: lo + batch_size]
        cond = torch.from_numpy(np.stack([tokens_of(s) for s in chunk]).astype(np.int64))
        lengths = torch.tensor([s["length"] for s in chunk], dtype=torch.int64)
        kwargs = (draws(c, len(chunk)) if draws is not None
                  else {"generator": step_generator(seed, rep, c, device)})
        out = sample_fn(cond.to(device), lengths.to(device), **kwargs).cpu().numpy()
        for i, s in enumerate(chunk):
            item = dict(motion=out[i], length=min(int(s["length"]), T_gen),
                        class_id=int(s["class_id"]))
            motions.append(item)
            cid = item["class_id"]
            if mm_count.get(cid, 0) <= mm_num_repeats:
                mm_count[cid] = mm_count.get(cid, 0) + 1
                mm_groups.setdefault(cid, []).append(item)
                gt_mm_groups.setdefault(cid, []).append(dict(
                    motion=s["motion"], length=min(int(s["length"]), s["motion"].shape[1]),
                    class_id=cid))
    return GeneratedSet(motions=motions, mm_groups=mm_groups, gt_mm_groups=gt_mm_groups)


def make_embedder(encoder: torch.nn.Module, consistency: torch.nn.Module) -> Callable:
    """``embed(motion (B, 2, 91, D) numpy, lengths (B,)) -> (logits, pooled
    embedding, consistency logits)`` as numpy: the foot-contact channels
    are stripped and both models run in eval mode under no_grad on their
    device."""
    encoder.eval()
    consistency.eval()
    device = next(encoder.parameters()).device

    @torch.no_grad()
    def embed(motion: np.ndarray, lengths: np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(motion[..., :-4], np.float32)).to(device)
        lens = torch.from_numpy(np.asarray(lengths, np.int64)).to(device)
        logits, emb = encoder(x, lens)
        cons = consistency(x, lens)
        return logits.cpu().numpy(), emb.cpu().numpy(), cons.cpu().numpy()

    return embed


def _batched_embeddings(embed_fn: Callable, items: list[dict], rng: np.random.Generator):
    """Window each item and embed in batches of EVAL_BATCH, the last padded
    with copies of its last item."""
    windows = np.stack([window_rows(it["motion"], it["length"], rng) for it in items])
    lengths = np.asarray([min(it["length"], 91) for it in items], np.int32)
    logits_all, emb_all, cons_all = [], [], []
    for lo in range(0, len(items), EVAL_BATCH):
        w, lens = windows[lo: lo + EVAL_BATCH], lengths[lo: lo + EVAL_BATCH]
        pad = EVAL_BATCH - len(w)
        if pad:
            w = np.concatenate([w, np.repeat(w[-1:], pad, axis=0)])
            lens = np.concatenate([lens, np.repeat(lens[-1:], pad)])
        logits, emb, cons = embed_fn(w, lens)
        logits_all.append(logits[: EVAL_BATCH - pad])
        emb_all.append(emb[: EVAL_BATCH - pad])
        cons_all.append(cons[: EVAL_BATCH - pad])
    return np.concatenate(logits_all), np.concatenate(emb_all), np.concatenate(cons_all)


def evaluate_once(embed_fn: Callable, gt_items: list[dict], gen: GeneratedSet,
                  rng: np.random.Generator, diversity_times: int = DIVERSITY_TIMES,
                  mm_num_times: int = MM_NUM_TIMES) -> OrderedDict:
    """One replication of the metric suite: {metric: {"ground truth": v,
    "text2motion": v}} and the generated set's confusion matrix under
    ``"_confusion"``."""
    results = OrderedDict()

    def acc_and_embeds(items):
        logits, emb, cons = _batched_embeddings(embed_fn, items, rng)
        class_ids = np.asarray([it["class_id"] for it in items])
        acc = float((logits.argmax(-1) == class_ids).mean())
        consistency = float((cons.argmax(-1) == 0).mean())
        return acc, emb, consistency, logits, class_ids

    gt_acc, gt_emb, gt_cons, _, _ = acc_and_embeds(gt_items)
    gen_acc, gen_emb, gen_cons, gen_logits, gen_cids = acc_and_embeds(gen.motions)
    results["Acc"] = {"ground truth": gt_acc, "text2motion": gen_acc}
    results["Consistency"] = {"ground truth": gt_cons, "text2motion": gen_cons}
    gt_mu, gt_cov = M.calculate_activation_statistics(gt_emb)
    # the ground truth's FID is against a second, independently windowed
    # embedding of the same clips: a small nonzero sanity value
    _, gt_emb2, _ = _batched_embeddings(embed_fn, gt_items, rng)
    results["FID"] = {
        "ground truth": M.calculate_frechet_distance(
            gt_mu, gt_cov, *M.calculate_activation_statistics(gt_emb2)),
        "text2motion": M.calculate_frechet_distance(
            gt_mu, gt_cov, *M.calculate_activation_statistics(gen_emb)),
    }
    div_times = min(diversity_times, len(gt_items) - 1)
    results["Diversity"] = {
        "ground truth": M.calculate_diversity(gt_emb, div_times, rng),
        "text2motion": M.calculate_diversity(gen_emb, div_times, rng),
    }

    def multimodality(groups):
        per_class = []
        for items in groups.values():
            if len(items) <= mm_num_times:
                continue
            per_class.append(_batched_embeddings(embed_fn, items, rng)[1])
        if not per_class:
            return 0.0
        k = min(len(e) for e in per_class)
        stacked = np.stack([e[:k] for e in per_class])
        return M.calculate_multimodality(stacked, min(mm_num_times, k - 1), rng)

    results["MultiModality"] = {"ground truth": multimodality(gen.gt_mm_groups),
                                "text2motion": multimodality(gen.mm_groups)}
    results["_confusion"] = {"text2motion": confusion(gen_logits.argmax(-1), gen_cids)}
    return results


def confusion(pred: np.ndarray, gt: np.ndarray, n: int = 26) -> np.ndarray:
    """(n, n) counts, row = true class, column = predicted."""
    cm = np.zeros((n, n), np.int64)
    for p, g in zip(pred, gt):
        cm[g, p] += 1
    return cm


def summarize(replications: list[OrderedDict], replication_times: int) -> OrderedDict:
    """{metric: {model: (mean, 1.96·σ/√n)}} over the replications."""
    out = OrderedDict()
    for metric in replications[0]:
        if metric.startswith("_"):
            continue
        out[metric] = OrderedDict()
        for model_name in replications[0][metric]:
            vals = np.asarray([r[metric][model_name] for r in replications])
            mean, conf = M.get_metric_statistics(vals, replication_times)
            out[metric][model_name] = (float(mean), float(conf))
    return out
