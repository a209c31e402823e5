"""Synthetic NTU-format dataset generator (counterpart of
``hig_tpu/data/synthetic.py``).

Fabricates a dataset in the reference's on-disk layout — class-conditioned
two-person motions made by FK from the canonical skeleton, encoded with the
263-d codec, in ``new_joint_vecs/*.npy``, ``texts/*.txt``, the split files
and ``Mean.npy``/``Std.npy`` — so train → label → evaluate runs without the
licensed data, and without JAX. Each class has its own kinematic signature
(frequency, amplitude, approach or retreat, the second actor's phase).

The random draws are JAX's, from one ``np.random.RandomState`` in the same
order, so the same seed gives the same clips, texts and splits. The FK and
the encode run on ``device`` (the card by default): each clip's FK as it
is drawn, then every clip of one length encoded in one batched call.
"""

from __future__ import annotations

import os
from os.path import join as pjoin

import numpy as np
import torch

from hig_tpu_torch import resolve_device
from hig_tpu_torch.data.dataset import compute_mean_std
from hig_tpu_torch.data.vocab import CLASSID2CAPS, NUM_CLASSES
from hig_tpu_torch.utils import motion_codec as codec
from hig_tpu_torch.utils import quaternions as q
from hig_tpu_torch.utils import skeleton as sk
from hig_tpu_torch.utils.kinematics import T2M_KINEMATIC_CHAIN, T2M_RAW_OFFSETS

# Canonical bone lengths (roughly human-proportioned, meters).
BONE_LENGTHS = np.array(
    [0.0, 0.11, 0.11, 0.12, 0.38, 0.38, 0.14, 0.40, 0.40, 0.05, 0.13, 0.13,
     0.21, 0.15, 0.15, 0.09, 0.12, 0.12, 0.27, 0.27, 0.25, 0.25],
    dtype=np.float32,
)
REST_OFFSETS = T2M_RAW_OFFSETS * BONE_LENGTHS[:, None]
FEET_THRE = 0.002
DEFAULT_SPLITS = {"train_sub.txt": 0.6, "val_sub.txt": 0.2, "test_sub.txt": 0.2}


def _actor_joints(rng: np.random.RandomState, T: int, class_id: int, phase: float,
                  start_xz: np.ndarray, heading: float, device) -> torch.Tensor:
    """FK of one actor's smooth class-conditioned motion: (T, 22, 3) on
    ``device``."""
    J = 22
    t = np.linspace(0, 2 * np.pi, T)[:, None, None]
    freq = 0.5 + 0.15 * (class_id % 7) + 0.05 * rng.randn(1, J, 3)
    amp = 0.12 + 0.02 * (class_id % 5) + 0.02 * rng.rand(1, J, 3)
    angles = amp * np.sin(freq * t * (2 + class_id % 3) + phase + rng.rand(1, J, 3))
    axis = rng.randn(J, 3)
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    expmap = torch.from_numpy((angles * axis).reshape(-1, 3).astype(np.float32)).to(device)
    quat = q.qnormalize(q.expmap_to_quaternion(expmap).reshape(T, J, 4))
    # approach / retreat trajectory with class-dependent speed
    speed = 0.01 * (1 + class_id % 4)
    walk = speed * np.arange(T)
    root = np.stack(
        [start_xz[0] + walk * np.cos(heading),
         0.9 + 0.02 * np.sin(3 * t[:, 0, 0]),
         start_xz[1] + walk * np.sin(heading)],
        axis=-1,
    ).astype(np.float32)
    return sk.forward_kinematics(quat, torch.from_numpy(root).to(device), REST_OFFSETS,
                                 T2M_KINEMATIC_CHAIN)


def generate_pair(rng: np.random.RandomState, T: int, class_id: int, device="cpu"):
    """World-frame joints (T, 22, 3) of two interacting actors facing each
    other, on ``device``."""
    gap = 0.8 + 0.4 * rng.rand()
    j1 = _actor_joints(rng, T, class_id, 0.0, np.array([0.0, 0.0]),
                       heading=0.1 * rng.randn(), device=device)
    heading2 = np.pi + 0.1 * rng.randn()
    j2 = _actor_joints(rng, T, class_id, np.pi / 2, np.array([gap, gap]), heading=heading2,
                       device=device)
    return j1, j2


def generate_dataset(root: str, clips_per_class: int = 4, min_frames: int = 32,
                     max_frames: int = 120, seed: int = 0, splits: dict | None = None,
                     device=None) -> None:
    """Write a complete synthetic dataset to ``root``; ``splits`` maps a
    split file's name to its fraction (default train/val/test 0.6/0.2/0.2).
    ``device`` (default the card) runs the FK and the encode."""
    device = resolve_device(device)
    splits = splits or DEFAULT_SPLITS
    os.makedirs(pjoin(root, "new_joint_vecs"), exist_ok=True)
    os.makedirs(pjoin(root, "texts"), exist_ok=True)
    rng = np.random.RandomState(seed)
    spec = codec.t2m_spec()
    # a handful of lengths, so each length's clips encode in one call
    length_choices = np.unique(np.linspace(min_frames, max_frames - 1, 4).astype(int))
    names, class_of = [], {}
    by_length: dict[int, list] = {}
    for class_id in range(NUM_CLASSES):
        for k in range(clips_per_class):
            T = int(rng.choice(length_choices))
            name = f"S{seed:02d}C{class_id:03d}K{k:03d}"
            by_length.setdefault(T, []).append((name, generate_pair(rng, T + 1, class_id, device)))
            cap1, cap2 = CLASSID2CAPS[class_id]
            with open(pjoin(root, "texts", name + ".txt"), "w") as f:
                f.write(f"{cap1}_{cap2}#none#0.0#0.0\n")
            names.append(name)
            class_of[name] = class_id
    for items in by_length.values():
        j1 = torch.stack([a for _, (a, _) in items])
        j2 = torch.stack([b for _, (_, b) in items])
        clips = codec.encode_pair(j1, j2, FEET_THRE, spec).cpu().numpy()  # (n, 2, T, 263)
        for (name, _), clip in zip(items, clips):
            np.save(pjoin(root, "new_joint_vecs", name + ".npy"), clip)

    # Stratified split: every class gives each split the same fraction
    # (largest remainder; the leftover slots rotate across classes so a tiny
    # corpus still spreads every split over many classes).
    by_class: dict[int, list[str]] = {}
    for name in names:
        by_class.setdefault(class_of[name], []).append(name)
    split_list = list(splits.items())
    split_names: dict[str, list[str]] = {s: [] for s in splits}
    for ci, class_id in enumerate(sorted(by_class)):
        class_names = by_class[class_id]
        rng.shuffle(class_names)
        n = len(class_names)
        base = [int(frac * n) for _, frac in split_list]
        order = sorted(range(len(split_list)), key=lambda i: -(split_list[i][1] * n - base[i]))
        for j in range(n - sum(base)):
            base[order[(j + ci) % len(order)]] += 1
        start = 0
        for (split_name, _), cnt in zip(split_list, base):
            split_names[split_name].extend(class_names[start : start + cnt])
            start += cnt
    for split_name, chunk in split_names.items():
        rng.shuffle(chunk)
        with open(pjoin(root, split_name), "w") as f:
            f.write("\n".join(chunk) + "\n")

    # Mean/Std over every clip (the dataset-level stats the trainer loads)
    clips = [type("C", (), {"motion": np.load(pjoin(root, "new_joint_vecs", n + ".npy"))})()
             for n in names]
    mean, std = compute_mean_std(clips)
    np.save(pjoin(root, "Mean.npy"), mean)
    np.save(pjoin(root, "Std.npy"), std)
