"""NTU two-person motion dataset pipeline, host side, for a single process
(own numpy copy of ``hig_tpu/data/dataset.py``): the caption-pair dataset
of training, labeling and evaluation, the mismatched-pair dataset of the
consistency evaluator, and the single-person (HumanML3D / KIT-ML) dataset
of ``train_single`` (:class:`SingleMotionDataset`).

Every batch is a dict of fixed-shape numpy arrays with the captions already
tokenized, and every random choice comes from an ``np.random.Generator``
seeded by (seed, epoch, item), so the batches are those of the JAX package,
bit for bit.

On-disk format (the reference's):
  new_joint_vecs/<name>.npy  — (2, T+1, 263) float32, last row = init token
  texts/<name>.txt           — 'caption1_caption2#tokens#f_tag#to_tag' lines
  <split>.txt                — clip names
  Mean.npy / Std.npy         — (267,) = 263 feature stats + 4 init stats
"""

from __future__ import annotations

import dataclasses
import json
import os
from os.path import join as pjoin

import numpy as np

from hig_tpu_torch.config import ExperimentConfig
from hig_tpu_torch.data.vocab import CAP2CLASSID, CAP2KEY
from hig_tpu_torch.models.tokenizer import tokenize

WINDOW_FRAMES = 90  # fixed training window (ref: mul_dataset.py:186)


@dataclasses.dataclass
class Clip:
    name: str
    motion: np.ndarray  # (2, T, D) — T rows include the trailing init token
    length: int  # row count (features + init)
    texts: list  # list of (caption1, caption2) pairs
    class_id: int


def parse_caption_file(path: str) -> list[tuple[str, str]]:
    """(caption1, caption2) per non-empty line; a single caption serves both."""
    out = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            captions = line.split("#")[0].split("_")
            if len(captions) == 1:
                captions = captions * 2
            out.append((captions[0], captions[1]))
    return out


def load_clips(cfg: ExperimentConfig, split_file: str, min_motion_len: int = 20,
               max_motion_len: int = 200, limit: int = -1) -> list[Clip]:
    """All clips of a split in memory, 20 ≤ rows < 200, sorted by length;
    ``limit`` keeps a seeded random subset."""
    with open(pjoin(cfg.data_root, split_file)) as f:
        names = [line.strip() for line in f if line.strip()]
    clips = []
    for name in names:
        npy = pjoin(cfg.motion_dir, name + ".npy")
        txt = pjoin(cfg.text_dir, name + ".txt")
        if not (os.path.exists(npy) and os.path.exists(txt)):
            continue
        motion = np.load(npy).astype(np.float32)
        rows = len(motion) if motion.ndim == 2 else len(motion[1])
        if rows < min_motion_len or rows >= max_motion_len:
            continue
        texts = parse_caption_file(txt)
        if not texts:
            continue
        clips.append(Clip(name=name, motion=motion, length=rows, texts=texts,
                          class_id=CAP2CLASSID.get(texts[0][0], 0)))
    clips.sort(key=lambda c: c.length)
    if limit != -1:
        idx = np.random.RandomState(0).permutation(len(clips))[:limit]
        clips = [clips[i] for i in sorted(idx)]
    return clips


def compute_mean_std(clips: list[Clip]) -> tuple[np.ndarray, np.ndarray]:
    """(267,) mean/std: 263 feature stats over all frame rows of both actors
    + 4 init-token stats; a std below 1e-6 becomes 1."""
    frames = np.concatenate([c.motion[:, :-1].reshape(-1, c.motion.shape[-1]) for c in clips])
    inits = np.concatenate([c.motion[:, -1, :4] for c in clips])
    mean = np.concatenate([frames.mean(0), inits.mean(0)])
    std = np.concatenate([frames.std(0), inits.std(0)])
    std[std < 1e-6] = 1.0
    return mean.astype(np.float32), std.astype(np.float32)


def rescale_std_train(std: np.ndarray, joints_num: int, feat_bias: float) -> np.ndarray:
    """Train-time std rescale (the reference's ntu_mul branch)."""
    std = std.copy()
    std[0:4] = std[0:4] / feat_bias
    fc0 = 4 + (joints_num - 1) * 9 + joints_num * 3
    std[fc0 : fc0 + 4] = std[fc0 : fc0 + 4].mean() / feat_bias
    return std


def load_training_stats(cfg: ExperimentConfig,
                        write: bool = True) -> tuple[np.ndarray, np.ndarray]:
    """Mean.npy / Std.npy of the data root with the train-time rescale, also
    written to the run's meta/ (where serving reads them) unless ``write``
    is False (a rank other than the primary)."""
    mean = np.load(pjoin(cfg.data_root, "Mean.npy"))
    std = rescale_std_train(np.load(pjoin(cfg.data_root, "Std.npy")), cfg.joints_num,
                            cfg.feat_bias)
    if not write:
        return mean, std
    os.makedirs(cfg.meta_dir, exist_ok=True)
    np.save(pjoin(cfg.meta_dir, "mean.npy"), mean)
    np.save(pjoin(cfg.meta_dir, "std.npy"), std)
    return mean, std


def window_indices(nframes: int, rng: np.random.Generator, num_frames: int = WINDOW_FRAMES):
    """Frame indices of one sample: the init row (index nframes) first, then
    a random window of ``num_frames``; short clips repeat their last frame."""
    if num_frames > nframes:
        padding = (nframes - 1) * np.ones(num_frames - nframes, dtype=int)
        return np.concatenate(([nframes], np.arange(nframes), padding))
    shift_max = nframes - num_frames
    shift = int(rng.integers(0, shift_max if shift_max > 0 else 1))
    return np.concatenate(([nframes], shift + np.arange(num_frames)))


def normalize_pair(motion: np.ndarray, mean: np.ndarray, std: np.ndarray) -> np.ndarray:
    """Z-normalize a windowed (2, W+1, D) sample: frames against
    mean/std[:-4], init channels 0:4 against the trailing init stats."""
    out = motion.copy()
    out[:, 1:] = (out[:, 1:] - mean[:-4]) / std[:-4]
    out[:, 0, :4] = (out[:, 0, :4] - mean[-4:]) / std[-4:]
    return out


class PairDataset:
    """Dataset of caption-pair clips. ``__getitem__(item, epoch)`` is a
    function of (seed, epoch, item). With ``label_path`` (a JSON object clip
    name → 0/1 from role discovery) the actors of a clip labeled 1 are
    swapped, the supervised stage's input, unless ``eval_mode`` (the test
    split of evaluation) or ``train_eval`` (the evaluator models' data)."""

    def __init__(self, cfg: ExperimentConfig, mean: np.ndarray, std: np.ndarray,
                 split_file: str, times: int = 1, label_path: str | None = None,
                 seed: int = 0, eval_mode: bool = False, train_eval: bool = False):
        self.cfg = cfg
        self.times = times
        self.seed = seed
        self.eval_mode = eval_mode
        self.train_eval = train_eval
        self.mean, self.std = mean, std
        self.clips = load_clips(cfg, split_file, limit=cfg.limit_data_num)
        self.labels = None
        if label_path:
            with open(label_path) as f:
                self.labels = json.load(f)

    def real_len(self) -> int:
        return len(self.clips)

    def __len__(self) -> int:
        return self.real_len() * self.times

    def __getitem__(self, item: int, epoch: int = 0) -> dict:
        clip = self.clips[item % self.real_len()]
        rng = np.random.default_rng((self.seed, epoch, item))
        nframes = clip.motion.shape[1] - 1
        sample = normalize_pair(clip.motion[:, window_indices(nframes, rng)], self.mean,
                                self.std)
        caption1, caption2 = clip.texts[int(rng.integers(len(clip.texts)))]
        if self.cfg.cap_same:
            caption2 = caption1
        swapped = False
        if (self.labels is not None and not (self.eval_mode or self.train_eval)
                and self.labels.get(clip.name, 0) == 1):
            sample = sample[::-1].copy()  # actor swap
            swapped = True
        return dict(motion=sample, length=min(sample.shape[1], clip.length),
                    caption1=caption1, caption2=caption2, cap_key1=CAP2KEY[caption1],
                    cap_key2=CAP2KEY[caption2], class_id=clip.class_id, name=clip.name,
                    swapped=swapped)


class PairMismatchDataset(PairDataset):
    """The consistency evaluator's data: with probability 0.5 (dummy_label
    1) a pair of actors from two different clips of the same class, each
    trimmed to the shorter length at a random start; else the clip as it
    is (dummy_label 0). Draws come from (seed, 7, epoch, item)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.class2indices: dict[int, list[int]] = {}
        for i, c in enumerate(self.clips):
            self.class2indices.setdefault(c.class_id, []).append(i)

    def __getitem__(self, item: int, epoch: int = 0) -> dict:
        clip = self.clips[item % self.real_len()]
        rng = np.random.default_rng((self.seed, 7, epoch, item))
        dummy_label = int(rng.random() > 0.5)
        motion, length = clip.motion, clip.length
        if dummy_label == 1 and len(self.class2indices[clip.class_id]) > 1:
            while True:
                other_idx = int(rng.choice(self.class2indices[clip.class_id]))
                if self.clips[other_idx].name != clip.name:
                    break
            other = self.clips[other_idx]
            rows = min(length, other.length)

            def trim(m):
                start = int(rng.integers(0, m.shape[0] - rows + 1))
                return m[start : start + rows]

            a, b = int(rng.integers(2)), int(rng.integers(2))
            motion = np.stack([trim(clip.motion[a]), trim(other.motion[b])])
            length = rows
        else:
            dummy_label = 0
        nframes = motion.shape[1] - 1
        sample = normalize_pair(motion[:, window_indices(nframes, rng)], self.mean, self.std)
        return dict(motion=sample, length=min(sample.shape[1], length),
                    class_id=clip.class_id, dummy_label=dummy_label, name=clip.name)


SINGLE_WINDOW = 60  # the single-person training window (ref: dataset.py single-person)
SINGLE_MIN_LEN = {"t2m": 40, "kit": 24}  # rows (ref dataset.py:21-27), fps 20


class SingleMotionDataset:
    """The single-person dataset (counterpart of
    ``hig_tpu/data/dataset.py:291-383``). Its conventions are not the pair
    dataset's: a ``window``-frame window with the init row at the END, the
    init channels 0:3 against the 3 trailing mean/std entries, one caption
    per line. A clip is a (rows, D) npy whose last row is the init row,
    kept when SINGLE_MIN_LEN ≤ rows < 200 (24 for other dataset names).
    Caption lines are ``caption#tokens#f_tag#to_tag``: zero tags caption
    the whole clip, nonzero ones the frames [f_tag·20, to_tag·20) clamped
    to rows − 1, which become a clip of their own (with the init row) when
    long enough. Clips are sorted by length; ``__getitem__(item, epoch)`` is
    a function of (seed, epoch, item)."""

    def __init__(self, cfg: ExperimentConfig, mean: np.ndarray, std: np.ndarray,
                 split_file: str, times: int = 1, seed: int = 0, window: int = SINGLE_WINDOW):
        self.cfg = cfg
        self.times = times
        self.seed = seed
        self.window = window
        self.mean, self.std = mean, std
        with open(pjoin(cfg.data_root, split_file)) as f:
            names = [line.strip() for line in f if line.strip()]
        min_len = SINGLE_MIN_LEN.get(cfg.dataset_name, 24)
        self.clips = []
        for name in names:
            npy = pjoin(cfg.motion_dir, name + ".npy")
            txt = pjoin(cfg.text_dir, name + ".txt")
            if not (os.path.exists(npy) and os.path.exists(txt)):
                continue
            motion = np.load(npy).astype(np.float32)
            if motion.ndim != 2:
                continue
            rows = len(motion)
            if rows < min_len or rows >= 200:
                continue
            captions = []
            with open(txt, encoding="utf-8") as f:
                lines = f.readlines()
            for seg_i, line in enumerate(lines):
                if not line.strip():
                    continue
                parts = line.strip().split("#")
                f_tag = float(parts[2]) if len(parts) > 2 and parts[2] else 0.0
                to_tag = float(parts[3]) if len(parts) > 3 and parts[3] else 0.0
                f_tag = 0.0 if np.isnan(f_tag) else f_tag
                to_tag = 0.0 if np.isnan(to_tag) else to_tag
                if f_tag == 0.0 and to_tag == 0.0:
                    captions.append(parts[0])
                    continue
                # to_tags overshoot the clip's end: clamp to the frame rows,
                # so the init row is not taken in as a frame
                seg = motion[int(f_tag * 20): min(int(to_tag * 20), rows - 1)]
                if len(seg) < min_len or len(seg) >= 200:
                    continue
                seg = np.concatenate([seg, motion[-1:]], axis=0)
                self.clips.append(Clip(name=f"S{seg_i}_{name}", motion=seg, length=len(seg),
                                       texts=[parts[0]], class_id=0))
            if captions:
                self.clips.append(Clip(name=name, motion=motion, length=rows, texts=captions,
                                       class_id=0))
        self.clips.sort(key=lambda c: c.length)

    def real_len(self) -> int:
        return len(self.clips)

    def __len__(self) -> int:
        return self.real_len() * self.times

    def __getitem__(self, item: int, epoch: int = 0) -> dict:
        clip = self.clips[item % self.real_len()]
        rng = np.random.default_rng((self.seed, epoch, item))
        nframes = clip.motion.shape[0] - 1
        if self.window > nframes:
            padding = (nframes - 1) * np.ones(self.window - nframes, dtype=int)
            ix = np.concatenate([np.arange(nframes), padding, [nframes]])
        else:
            shift_max = nframes - self.window
            shift = int(rng.integers(0, shift_max if shift_max > 0 else 1))
            ix = np.concatenate([shift + np.arange(self.window), [nframes]])
        sample = clip.motion[ix].copy()
        sample[:-1] = (sample[:-1] - self.mean[:-3]) / self.std[:-3]
        sample[-1, :3] = (sample[-1, :3] - self.mean[-3:]) / self.std[-3:]
        caption = clip.texts[int(rng.integers(len(clip.texts)))]
        return dict(motion=sample, length=min(sample.shape[0], clip.length), caption=caption,
                    class_id=0, name=clip.name)


def collate(samples: list[dict], token_cache: dict | None = None) -> dict:
    """Stack samples into fixed-shape arrays and tokenize the captions
    (``token_cache`` keeps each caption's tokens across calls): (B, 2, 77)
    for caption pairs, (B, 77) for single-person samples; samples without
    captions (the mismatch dataset's) carry ``dummy_label``."""
    cache = {} if token_cache is None else token_cache

    def tokens(caption):
        if caption not in cache:
            cache[caption] = tokenize(caption)[0]
        return cache[caption]

    batch = dict(
        motion=np.stack([s["motion"] for s in samples]).astype(np.float32),
        lengths=np.asarray([s["length"] for s in samples], np.int32),
        class_id=np.asarray([s["class_id"] for s in samples], np.int32),
    )
    if "caption1" in samples[0]:
        batch["tokens"] = np.stack([np.stack([tokens(s["caption1"]), tokens(s["caption2"])])
                                    for s in samples]).astype(np.int32)
        batch["cap_ids"] = np.asarray([[s["cap_key1"], s["cap_key2"]] for s in samples],
                                      np.int32)
    if "caption" in samples[0]:
        batch["tokens"] = np.stack([tokens(s["caption"]) for s in samples]).astype(np.int32)
    if "dummy_label" in samples[0]:
        batch["dummy_label"] = np.asarray([s["dummy_label"] for s in samples], np.int32)
    batch["names"] = [s["name"] for s in samples]
    return batch


def epoch_batches(dataset, batch_size: int, epoch: int, shuffle: bool = True,
                  drop_last: bool = True, seed: int = 0, token_cache: dict | None = None,
                  process_index: int = 0, process_count: int = 1):
    """The batches of one epoch of any of the datasets above: the order is
    a function of (seed, epoch); with ``drop_last`` the ragged tail is
    dropped, else the order wraps round to fill the last batch.
    ``batch_size`` is the global batch: of ``process_count`` ranks, rank
    ``process_index`` reads its contiguous ``batch_size / process_count``
    slice of each (as ``hig_tpu/data/dataset.py:436-470``)."""
    if batch_size % process_count:
        raise ValueError(f"global batch {batch_size} not divisible by {process_count} "
                         "processes")
    local_bs = batch_size // process_count
    n = len(dataset)
    order = np.arange(n)
    if shuffle:
        np.random.default_rng((seed, epoch)).shuffle(order)
    if drop_last:
        order = order[: (n // batch_size) * batch_size]
    elif n % batch_size:
        order = np.concatenate([order, order[: batch_size - n % batch_size]])
    for i in range(0, len(order), batch_size):
        local = order[i + process_index * local_bs : i + (process_index + 1) * local_bs]
        samples = [dataset.__getitem__(int(j), epoch=epoch) for j in local]
        yield collate(samples, token_cache)
