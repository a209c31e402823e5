"""Fit SMPL bodies to a generated (2, T, 22, 3) joints file (counterpart of
``tools/render_smpl.py``).

Every frame of both actors is fitted in one batch by the two-stage
SMPLify3D (``smpl/smplify.py``, optax's L-BFGS), from the mean pose and
shape of --mean_params (``neutral_smpl_mean_params.h5``, read with h5py,
when the file exists; zeros otherwise), with the feet and ankles at
confidence 1.5. Writes ``<save_dir>/<stem>.pkl`` (the two actors' vertex
arrays (T, V, 3)) and ``<stem>_params.npz`` (pose, betas, cam_t, joints),
and, with --gif (the default) and no pyrender, a matplotlib point-cloud GIF
``<stem>.gif`` (without matplotlib the run raises before fitting, naming
--no-gif). The licensed assets are not in the repository: without
--smpl_model (SMPL_NEUTRAL.pkl or an .npz export) or --gmm (gmm_08.pkl) the
synthetic model and prior stand in. Runs on the card unless --device cpu.

    python -m hig_tpu_torch.render_smpl --file_name result/joints.npy --no-gif
"""

from __future__ import annotations

import argparse
import os
import pickle
import time
from os.path import join as pjoin

import numpy as np
import torch

from hig_tpu_torch import resolve_device
from hig_tpu_torch.smpl.fit import joint_confidences, load_assets
from hig_tpu_torch.smpl.smplify import SMPLify3D
from hig_tpu_torch.visualize import require_matplotlib


def mean_params(path: str | None) -> tuple[np.ndarray, np.ndarray]:
    """The mean pose (72,) and shape (10,) of the h5 file at ``path`` when
    it exists (h5py needed then), else zeros."""
    if not path or not os.path.exists(path):
        return np.zeros(72, np.float32), np.zeros(10, np.float32)
    try:
        import h5py
    except ImportError as e:
        raise RuntimeError(f"--mean_params {path} needs h5py ({e}); install it or leave "
                           f"--mean_params unset to start from zeros") from e
    with h5py.File(path, "r") as f:
        return np.asarray(f["pose"][:], np.float32), np.asarray(f["shape"][:], np.float32)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--file_name", required=True, help="(2, T, 22, 3) joints .npy")
    parser.add_argument("--save_dir", default="./result/smpl")
    parser.add_argument("--smpl_model", default=None,
                        help="SMPL_NEUTRAL.pkl or .npz; the synthetic model if absent")
    parser.add_argument("--gmm", default=None, help="gmm_08.pkl; the synthetic prior if absent")
    parser.add_argument("--mean_params", default=None,
                        help="neutral_smpl_mean_params.h5 (read when it exists)")
    parser.add_argument("--num_smplify_iters", type=int, default=50)
    parser.add_argument("--gif", action="store_true", default=True)
    parser.add_argument("--no-gif", dest="gif", action="store_false")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    try:
        import pyrender  # noqa: F401

        have_pyrender = True
    except ImportError:
        have_pyrender = False
    if args.gif and not have_pyrender:
        require_matplotlib()
    model, prior = load_assets(args.smpl_model, args.gmm, device)
    init_pose, init_shape = mean_params(args.mean_params)

    data = np.load(args.file_name)  # (2, T, 22, 3)
    num_pers, seq_len = data.shape[:2]
    N = num_pers * seq_len
    j3d = torch.from_numpy(np.asarray(data.reshape(N, 22, 3), np.float32)).to(device)
    fitter = SMPLify3D(model=model, prior=prior, num_iters=args.num_smplify_iters)
    t0 = time.time()
    result = fitter(torch.from_numpy(np.tile(init_pose, (N, 1))).to(device),
                    torch.from_numpy(np.tile(init_shape, (N, 1))).to(device), j3d,
                    joint_confidences(device))
    evaluations = result.camera_info.evaluations + result.body_info.evaluations
    print(f"fit {N} frames in {time.time() - t0:.2f}s ({evaluations} evaluations), "
          f"final loss {float(result.final_loss):.1f}")

    os.makedirs(args.save_dir, exist_ok=True)
    stem = os.path.splitext(os.path.basename(args.file_name))[0]
    verts = result.vertices.cpu().numpy()
    mesh1, mesh2 = verts[:seq_len], verts[seq_len:]
    with open(pjoin(args.save_dir, stem + ".pkl"), "wb") as f:
        pickle.dump([mesh1, mesh2], f)
    np.savez(pjoin(args.save_dir, stem + "_params.npz"), pose=result.pose.cpu().numpy(),
             betas=result.betas.cpu().numpy(),
             cam_t=result.camera_translation.cpu().numpy(),
             joints=result.joints.cpu().numpy())
    print(f"wrote {stem}.pkl / {stem}_params.npz to {args.save_dir}")
    if args.gif and not have_pyrender:
        from hig_tpu_torch.viz import plot

        plot.plot_point_clouds(pjoin(args.save_dir, stem + ".gif"), mesh1, mesh2)
        print("pyrender not available: wrote a matplotlib point-cloud gif instead")
    return result


if __name__ == "__main__":
    main()
