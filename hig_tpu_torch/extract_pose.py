"""Assemble two-person joint clips from raw 3D pose-estimator detections
(counterpart of ``tools/extract_pose.py``; ``data/pose_tracks.py``).

Input: a directory of per-clip ``.npz`` files, each with
  frame_ids  (N,)       int frame index of each detection
  joints     (N, J, 3)  world-frame SMPL-ordered joints, J >= 22
  num_frames ()         int, optional: the video's frame count (else
                        max(frame_ids) + 1; the coverage check needs it
                        when detections stop before the video ends)
Output: ``<out_dir>/<clip>.npy`` of shape (2, T, 22, 3). A clip whose
tracks cover too few frames is dropped, and says so.

Chain: extract_pose → ``python -m hig_tpu_torch.preprocess`` →
``python -m hig_tpu_torch.train``. Track assembly is numpy on the host.
With ``--out_root`` the next step follows in the same process:
``preprocess`` of ``--out_dir`` into ``--out_root`` on ``--device`` (the
card unless ``--device cpu``).

    python -m hig_tpu_torch.extract_pose --detections_dir dets/ --out_dir joints/ \
        [--out_root data/mine]
"""

from __future__ import annotations

import argparse
import os
from os.path import join as pjoin

import numpy as np

from hig_tpu_torch import preprocess
from hig_tpu_torch.data.pose_tracks import assemble_clip


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--detections_dir", type=str, required=True,
                        help="directory of per-clip npz detection files")
    parser.add_argument("--out_dir", type=str, required=True)
    parser.add_argument("--smooth_sigma", type=float, default=1.0,
                        help="temporal gaussian smoothing (0 = off)")
    parser.add_argument("--min_coverage", type=float, default=0.5,
                        help="min fraction of frames each actor must be detected in")
    parser.add_argument("--out_root", type=str, default=None,
                        help="then encode the clips into this dataset root (preprocess)")
    parser.add_argument("--device", default="cuda", help="the encode's device (--out_root)")
    args = parser.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    files = sorted(f for f in os.listdir(args.detections_dir) if f.endswith(".npz"))
    kept = dropped = 0
    for fname in files:
        data = np.load(pjoin(args.detections_dir, fname))
        try:
            nf = int(data["num_frames"]) if "num_frames" in data else None
            clip = assemble_clip(data["frame_ids"], data["joints"], num_frames=nf,
                                 smooth_sigma=args.smooth_sigma,
                                 min_coverage=args.min_coverage)
        except ValueError as e:
            print(f"drop {fname}: {e}")
            dropped += 1
            continue
        np.save(pjoin(args.out_dir, fname[:-4] + ".npy"), clip)
        kept += 1
    print(f"assembled {kept} clips ({dropped} dropped) -> {args.out_dir}")
    if args.out_root:
        preprocess.main(["--joints_dir", args.out_dir, "--out_root", args.out_root,
                         "--device", args.device])


if __name__ == "__main__":
    main()
