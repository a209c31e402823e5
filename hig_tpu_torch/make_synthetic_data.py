"""Generate a synthetic NTU-format dataset (``hig_tpu_torch/data/synthetic.py``;
counterpart of ``tools/make_synthetic_data.py``). The FK and the encode run
on the card unless ``--device cpu`` (or ``--cpu``).

    python -m hig_tpu_torch.make_synthetic_data --root ./data/synthetic_mul
"""

from __future__ import annotations

import argparse
import time

from hig_tpu_torch.data.synthetic import generate_dataset


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--root", type=str, default="./data/synthetic_mul")
    parser.add_argument("--clips_per_class", type=int, default=8)
    parser.add_argument("--min_frames", type=int, default=30)
    parser.add_argument("--max_frames", type=int, default=120)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    t0 = time.perf_counter()
    generate_dataset(args.root, args.clips_per_class, args.min_frames, args.max_frames,
                     args.seed, device="cpu" if args.cpu else args.device)
    print(f"wrote synthetic dataset to {args.root} in {time.perf_counter() - t0:.2f}s")


if __name__ == "__main__":
    main()
