"""Two-person track assembly from per-frame 3D pose detections (the port's
own copy of ``hig_tpu/data/pose_tracks.py``, numpy on the host).

The post-process step that turns raw per-frame multi-person detections into
two aligned actor tracks, estimator-agnostic: any monocular 3D pose
estimator (ROMP, BEV, HybrIK, ...) that emits per-frame SMPL-topology
joints can feed it.

Input convention (one clip): detections as a flat list —
``frame_ids`` (N,) int frame index per detection (frames may hold 0, 1, 2,
or more detections) and ``joints`` (N, J, 3) world-frame joints with
SMPL joint ordering, J >= 22 (the t2m/HumanML3D skeleton is exactly the
first 22 SMPL joints; extras like BEV's hands/face rows are dropped).

Pipeline: greedy two-track association on root (pelvis) distance with the
optimal 2x2 assignment per frame → linear interpolation over missed
detections → optional temporal smoothing → ``(2, T, 22, 3)`` arrays ready
for ``python -m hig_tpu_torch.preprocess`` (joints → 263-d features).
"""

from __future__ import annotations

import numpy as np

T2M_NUM_JOINTS = 22


def _to_t2m(joints: np.ndarray) -> np.ndarray:
    """(..., J>=22, 3) SMPL-ordered joints → the 22-joint t2m skeleton."""
    if joints.shape[-2] < T2M_NUM_JOINTS:
        raise ValueError(
            f"need >= {T2M_NUM_JOINTS} SMPL-ordered joints, got {joints.shape[-2]}"
        )
    return joints[..., :T2M_NUM_JOINTS, :]


def associate_two_tracks(
    frame_ids: np.ndarray, joints: np.ndarray, num_frames: int | None = None
):
    """Assign per-frame detections to two persistent actor tracks.

    Returns ``(tracks, observed)``: tracks ``(2, T, 22, 3)`` (unobserved
    frames zero-filled — fill with :func:`fill_gaps`) and ``observed``
    ``(2, T)`` bool.

    Association: per frame, the (up to two) detections closest to the
    tracks' last known root positions are chosen under the optimal 2-track
    pairing (both pairings evaluated, min total root distance — the exact
    solution of the 2x2 assignment problem). Tracks initialize from the
    first frame with two detections; leading one-detection frames attach to
    track 0.
    """
    frame_ids = np.asarray(frame_ids, np.int64)
    joints = _to_t2m(np.asarray(joints, np.float32))
    if num_frames is None:
        num_frames = int(frame_ids.max()) + 1 if frame_ids.size else 0
    T = num_frames
    tracks = np.zeros((2, T, T2M_NUM_JOINTS, 3), np.float32)
    observed = np.zeros((2, T), bool)
    last_root = [None, None]  # last known pelvis per track

    order = np.argsort(frame_ids, kind="stable")
    frame_ids, joints = frame_ids[order], joints[order]
    bounds = np.searchsorted(frame_ids, np.arange(T + 1))

    for t in range(T):
        dets = joints[bounds[t] : bounds[t + 1]]
        if len(dets) == 0:
            continue
        roots = dets[:, 0]
        if last_root[0] is None and last_root[1] is None:
            take = min(len(dets), 2)
            for k in range(take):
                tracks[k, t], observed[k, t] = dets[k], True
                last_root[k] = roots[k]
            continue
        if len(dets) == 1:
            # one detection: to the nearer (known) track
            d = [
                np.inf if last_root[k] is None
                else float(np.linalg.norm(roots[0] - last_root[k]))
                for k in range(2)
            ]
            k = int(np.argmin(d))
            tracks[k, t], observed[k, t] = dets[0], True
            last_root[k] = roots[0]
            continue
        # two or more: pick the best detection pair for (track0, track1)
        # by exhaustive 2x2 assignment over the two closest candidates
        def dist(k, i):
            if last_root[k] is None:
                return 0.0  # unseen track takes anything
            return float(np.linalg.norm(roots[i] - last_root[k]))

        best, best_cost = None, np.inf
        for i in range(len(dets)):
            for j in range(len(dets)):
                if i == j:
                    continue
                cost = dist(0, i) + dist(1, j)
                if cost < best_cost:
                    best, best_cost = (i, j), cost
        i, j = best
        tracks[0, t], observed[0, t] = dets[i], True
        tracks[1, t], observed[1, t] = dets[j], True
        last_root[0], last_root[1] = roots[i], roots[j]
    return tracks, observed


def fill_gaps(tracks: np.ndarray, observed: np.ndarray) -> np.ndarray:
    """Linearly interpolate unobserved frames per track (edges hold the
    nearest observation). tracks (2, T, 22, 3), observed (2, T)."""
    out = tracks.copy()
    T = tracks.shape[1]
    idx = np.arange(T)
    for k in range(tracks.shape[0]):
        obs = np.flatnonzero(observed[k])
        if len(obs) == 0:
            continue
        flat = tracks[k].reshape(T, -1)
        filled = np.empty_like(flat)
        for c in range(flat.shape[1]):
            filled[:, c] = np.interp(idx, obs, flat[obs, c])
        out[k] = filled.reshape(T, T2M_NUM_JOINTS, 3)
    return out


def assemble_clip(
    frame_ids: np.ndarray,
    joints: np.ndarray,
    num_frames: int | None = None,
    smooth_sigma: float = 0.0,
    min_coverage: float = 0.5,
) -> np.ndarray:
    """Detections → a complete (2, T, 22, 3) two-person clip.

    Raises if either track was observed in fewer than ``min_coverage`` of
    the frames (the clip is not a usable interaction — the reference's
    post-process likewise drops such videos)."""
    tracks, observed = associate_two_tracks(frame_ids, joints, num_frames)
    cov = observed.mean(axis=1) if observed.shape[1] else np.zeros(2)
    if float(cov.min()) < min_coverage:
        raise ValueError(
            f"track coverage {cov.tolist()} below {min_coverage}: "
            "not a usable two-person clip"
        )
    full = fill_gaps(tracks, observed)
    if smooth_sigma > 0:
        from hig_tpu_torch.utils.filters import motion_temporal_filter

        full = np.stack(
            [motion_temporal_filter(full[k], sigma=smooth_sigma) for k in range(2)]
        )
    return full
