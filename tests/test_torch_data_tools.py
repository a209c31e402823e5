"""The port's JAX-free data tools against hig_tpu's on the CPU.

- ``python -m hig_tpu_torch.make_synthetic_data`` against JAX's
  ``generate_dataset`` on the same seed, at one clip a class and two clip
  lengths: the same file names; every feature file within 1e-4 of JAX's
  with the foot contacts exactly equal; the text and split files byte for
  byte; Mean.npy and Std.npy within 1e-4.
- ``pose_tracks`` (association, gap filling, assembly with smoothing) and
  ``filters`` equal to JAX's numpy functions exactly on the same
  detections.
- detections → ``python -m hig_tpu_torch.extract_pose`` → ``python -m
  hig_tpu_torch.preprocess`` against ``tools/extract_pose.py`` →
  ``tools/preprocess.py`` on the same detections (the chain
  ``tests/test_pose_pipeline.py`` drives): the same joint clips exactly, the
  features within 1e-4 with equal foot contacts, Mean/Std within 1e-4; and
  ``extract_pose --out_root`` runs the encode itself, to the same files.
"""

import os

import numpy as np
import pytest
import torch

from hig_tpu.data import pose_tracks as jpt
from hig_tpu.data import synthetic as jsyn
from hig_tpu.utils import filters as jfilters
from hig_tpu_torch import extract_pose, make_synthetic_data, preprocess
from hig_tpu_torch.data import pose_tracks as tpt
from hig_tpu_torch.utils import filters as tfilters
from tests.test_pose_pipeline import run_tool, two_actor_motion

FEAT_TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def assert_clip_close(got, want):
    """Features within FEAT_TOL; the foot contacts (the last 4 channels of
    the feature rows, the init row left out) exactly equal."""
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max() <= FEAT_TOL
    assert np.array_equal(got[..., :-1, -4:], want[..., :-1, -4:])


def assert_roots_match(got_root, want_root, dirs=("new_joint_vecs",)):
    for d in dirs:
        names = sorted(os.listdir(want_root / d))
        assert sorted(os.listdir(got_root / d)) == names and names
        for name in names:
            assert_clip_close(np.load(got_root / d / name), np.load(want_root / d / name))
    for stat in ("Mean.npy", "Std.npy"):
        got, want = np.load(got_root / stat), np.load(want_root / stat)
        assert got.shape == want.shape and np.abs(got - want).max() <= FEAT_TOL, stat


def test_make_synthetic_data_matches_jax(tmp_path):
    opts = dict(clips_per_class=1, min_frames=40, max_frames=42, seed=3)
    jsyn.generate_dataset(str(tmp_path / "jax"), **opts)
    make_synthetic_data.main(["--root", str(tmp_path / "port"), "--device", "cpu",
                              *[a for k, v in opts.items() for a in (f"--{k}", str(v))]])
    got, want = tmp_path / "port", tmp_path / "jax"
    assert_roots_match(got, want)
    lengths = {np.load(want / "new_joint_vecs" / n).shape[1]
               for n in os.listdir(want / "new_joint_vecs")}
    assert len(lengths) == 2
    texts = sorted(os.listdir(want / "texts"))
    assert sorted(os.listdir(got / "texts")) == texts and len(texts) == 26
    for name in texts:
        assert (got / "texts" / name).read_bytes() == (want / "texts" / name).read_bytes()
    for split in ("train_sub.txt", "val_sub.txt", "test_sub.txt"):
        assert (got / split).read_bytes() == (want / split).read_bytes()


def detections(seed: int, drop=(), spurious_at=None):
    """Shuffled per-frame detections of two_actor_motion, actor 1 missed at
    the frames in ``drop``, and a far-away spurious one at ``spurious_at``."""
    gt = two_actor_motion()
    rng = np.random.RandomState(seed)
    frame_ids, dets = [], []
    for t in range(gt.shape[1]):
        for k in rng.permutation(2):
            if k == 1 and t in drop:
                continue
            frame_ids.append(t)
            dets.append(gt[k, t])
        if t == spurious_at:
            frame_ids.append(t)
            dets.append(gt[0, t] + np.array([10.0, 0, 10.0], np.float32))
    return np.array(frame_ids), np.stack(dets)


def test_pose_tracks_and_filters_equal_jax():
    frame_ids, dets = detections(0, drop=(10, 11, 25), spurious_at=30)
    T = two_actor_motion().shape[1]
    (tracks, observed), (want_tracks, want_obs) = (
        m.associate_two_tracks(frame_ids, dets, T) for m in (tpt, jpt))
    assert np.array_equal(tracks, want_tracks) and np.array_equal(observed, want_obs)
    assert np.array_equal(tpt.fill_gaps(tracks, observed), jpt.fill_gaps(tracks, observed))
    for sigma in (0.0, 1.5):
        assert np.array_equal(tpt.assemble_clip(frame_ids, dets, T, smooth_sigma=sigma),
                              jpt.assemble_clip(frame_ids, dets, T, smooth_sigma=sigma))
    with pytest.raises(ValueError, match="coverage"):
        tpt.assemble_clip(frame_ids[:3], dets[:3], T)
    motion = two_actor_motion()[0]
    assert np.array_equal(tfilters.motion_temporal_filter(motion, 2.0),
                          jfilters.motion_temporal_filter(motion, 2.0))
    series = list(np.random.RandomState(1).rand(23))
    for k in (1, 4):
        assert tfilters.list_cut_average(series, k) == jfilters.list_cut_average(series, k)


def test_extract_pose_then_preprocess_match_jaxs_tools(tmp_path):
    det_dir = tmp_path / "dets"
    det_dir.mkdir()
    for i, name in enumerate(("clipA", "clipB")):
        frame_ids, dets = detections(i + 1, drop=(5,) if i else ())
        np.savez(det_dir / f"{name}.npz", frame_ids=frame_ids, joints=dets)
    gt = two_actor_motion()
    np.savez(det_dir / "bad.npz", frame_ids=np.array([0, 0]),
             joints=np.stack([gt[0, 0], gt[1, 0]]), num_frames=gt.shape[1])
    run_tool("extract_pose", ["--detections_dir", str(det_dir), "--out_dir",
                              str(tmp_path / "jax_joints")])
    run_tool("preprocess", ["--joints_dir", str(tmp_path / "jax_joints"), "--out_root",
                            str(tmp_path / "jax")])
    extract_pose.main(["--detections_dir", str(det_dir), "--out_dir",
                       str(tmp_path / "joints")])
    joints = sorted(os.listdir(tmp_path / "jax_joints"))
    assert sorted(os.listdir(tmp_path / "joints")) == joints == ["clipA.npy", "clipB.npy"]
    for name in joints:
        assert np.array_equal(np.load(tmp_path / "joints" / name),
                              np.load(tmp_path / "jax_joints" / name))
    preprocess.main(["--joints_dir", str(tmp_path / "joints"), "--out_root",
                     str(tmp_path / "port"), "--device", "cpu"])
    assert_roots_match(tmp_path / "port", tmp_path / "jax")
    # the chain in one command: extract_pose --out_root encodes what it assembled
    extract_pose.main(["--detections_dir", str(det_dir), "--out_dir",
                       str(tmp_path / "joints2"), "--out_root", str(tmp_path / "chained"),
                       "--device", "cpu"])
    assert_roots_match(tmp_path / "chained", tmp_path / "jax")


def test_preprocess_refuses_a_clip_of_the_wrong_shape():
    with pytest.raises(ValueError, match="want \\(2, T, 22, 3\\)"):
        preprocess.encode_clips([np.zeros((3, 10, 22, 3), np.float32)], torch.device("cpu"))
