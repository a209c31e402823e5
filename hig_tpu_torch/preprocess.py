"""Preprocess raw two-person joint clips into the 263-d feature format
(counterpart of ``tools/preprocess.py``).

Reads a directory of (2, T, 22, 3) world-frame joint ``.npy`` files and
writes (2, T, 263) feature clips (the init token the trailing row) under
``<out_root>/new_joint_vecs/``, then the dataset's ``Mean.npy``/``Std.npy``.
Clip lengths are bucketed up to multiples of ``--bucket`` and padded by
repeating the last frame; each batch of ``--batch`` clips of one bucket is
one batched ``encode_pair`` call on the device (the card unless
``--device cpu``), the counterpart of JAX's ``jit(vmap(encode_pair))``. A
clip keeps its real rows and its init row. Prints the encode rate.

    python -m hig_tpu_torch.preprocess --joints_dir joints/ --out_root data/mine
"""

from __future__ import annotations

import argparse
import os
import time
from collections import defaultdict
from os.path import join as pjoin

import numpy as np
import torch

from hig_tpu_torch import resolve_device
from hig_tpu_torch.data.dataset import compute_mean_std
from hig_tpu_torch.utils import motion_codec as codec


def encode_clips(clips: list, device, feet_thre: float = 0.002, bucket: int = 32,
                 batch: int = 64) -> tuple[list, dict]:
    """(2, T, 22, 3) joint clips → their (2, T, 263) feature clips, in order,
    and the encode's timing: clips, seconds (the batched calls, host copies
    included, the device synchronized) and clips/s."""
    spec = codec.t2m_spec()
    buckets: dict[int, list] = defaultdict(list)
    for i, arr in enumerate(clips):
        if arr.ndim != 4 or arr.shape[0] != 2:
            raise ValueError(f"clip {i}: want (2, T, 22, 3), got {arr.shape}")
        T = arr.shape[1]
        buckets[-(-T // bucket) * bucket].append((i, arr, T))
    out: list = [None] * len(clips)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for padded, items in sorted(buckets.items()):
        for lo in range(0, len(items), batch):
            chunk = items[lo : lo + batch]
            joints = np.stack([np.pad(a, ((0, 0), (0, padded - T), (0, 0), (0, 0)), mode="edge")
                               for _, a, T in chunk]).astype(np.float32)
            joints = torch.from_numpy(joints).to(device)
            feats = codec.encode_pair(joints[:, 0], joints[:, 1], feet_thre, spec).cpu().numpy()
            for (i, _, T), f in zip(chunk, feats):
                # T - 1 real feature rows, the padding's, then the init row
                out[i] = np.concatenate([f[:, : T - 1], f[:, -1:]], axis=1)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    return out, {"clips": len(clips), "seconds": dt, "clips_per_s": len(clips) / max(dt, 1e-9)}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--joints_dir", type=str, required=True,
                        help="directory of (2, T, 22, 3) npy files")
    parser.add_argument("--out_root", type=str, required=True)
    parser.add_argument("--feet_thre", type=float, default=0.002)
    parser.add_argument("--bucket", type=int, default=32,
                        help="pad clip lengths up to multiples of this")
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    out_dir = pjoin(args.out_root, "new_joint_vecs")
    os.makedirs(out_dir, exist_ok=True)
    files = sorted(f for f in os.listdir(args.joints_dir) if f.endswith(".npy"))
    clips = [np.load(pjoin(args.joints_dir, f)).astype(np.float32) for f in files]
    feats, timing = encode_clips(clips, device, args.feet_thre, args.bucket, args.batch)
    for fname, clip in zip(files, feats):
        np.save(pjoin(out_dir, fname), clip)
    print(f"encoded {timing['clips']} clips in {timing['seconds']:.1f}s "
          f"({timing['clips_per_s']:.1f} clips/s) on {device}")

    mean, std = compute_mean_std([type("C", (), {"motion": c})() for c in feats])
    np.save(pjoin(args.out_root, "Mean.npy"), mean)
    np.save(pjoin(args.out_root, "Std.npy"), std)
    print(f"wrote Mean/Std to {args.out_root}")


if __name__ == "__main__":
    main()
