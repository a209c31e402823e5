"""Host-side smoothing helpers (counterpart of ``hig_tpu/utils/filters.py``):
the temporal gaussian filter applied to decoded or assembled joints, and
block averaging of a series. scipy is imported when a filter runs."""

from __future__ import annotations

import math

import numpy as np


def motion_temporal_filter(motion: np.ndarray, sigma: float = 1.0) -> np.ndarray:
    """Per-channel temporal gaussian smoothing of a (T, J, 3) motion
    (``scipy.ndimage.gaussian_filter1d``, mode "nearest")."""
    import scipy.ndimage

    T = motion.shape[0]
    flat = motion.reshape(T, -1).copy()
    for i in range(flat.shape[1]):
        flat[:, i] = scipy.ndimage.gaussian_filter1d(flat[:, i], sigma=sigma, mode="nearest")
    return flat.reshape(T, -1, 3)


def list_cut_average(values, intervals: int):
    """Downsample a 1-d series by averaging blocks of ``intervals``."""
    if intervals == 1:
        return list(values)
    bins = math.ceil(len(values) / intervals)
    return [float(np.mean(values[i * intervals : min((i + 1) * intervals, len(values))]))
            for i in range(bins)]
