"""Kinematic-tree constants of the supported skeletons (the port's own copy
of ``hig_tpu/utils/kinematics.py``): the SMPL-22 skeleton of HumanML3D and
NTU ("t2m") and the KIT-ML 21-joint skeleton — their raw offsets, chains,
face, foot and lower-leg joint indices — and :func:`parents_from_chains`.
"""

from __future__ import annotations

import numpy as np

# SMPL 22-joint skeleton used by HumanML3D and the NTU interaction data.
T2M_RAW_OFFSETS = np.array(
    [
        [0, 0, 0],
        [1, 0, 0],
        [-1, 0, 0],
        [0, 1, 0],
        [0, -1, 0],
        [0, -1, 0],
        [0, 1, 0],
        [0, -1, 0],
        [0, -1, 0],
        [0, 1, 0],
        [0, 0, 1],
        [0, 0, 1],
        [0, 1, 0],
        [1, 0, 0],
        [-1, 0, 0],
        [0, 0, 1],
        [0, -1, 0],
        [0, -1, 0],
        [0, -1, 0],
        [0, -1, 0],
        [0, -1, 0],
        [0, -1, 0],
    ],
    dtype=np.float32,
)

T2M_KINEMATIC_CHAIN = [
    [0, 2, 5, 8, 11],
    [0, 1, 4, 7, 10],
    [0, 3, 6, 9, 12, 15],
    [9, 14, 17, 19, 21],
    [9, 13, 16, 18, 20],
]

# KIT-ML 21-joint skeleton.
KIT_RAW_OFFSETS = np.array(
    [
        [0, 0, 0],
        [0, 1, 0],
        [0, 1, 0],
        [0, 1, 0],
        [0, 1, 0],
        [1, 0, 0],
        [0, -1, 0],
        [0, -1, 0],
        [-1, 0, 0],
        [0, -1, 0],
        [0, -1, 0],
        [1, 0, 0],
        [0, -1, 0],
        [0, -1, 0],
        [0, 0, 1],
        [0, 0, 1],
        [-1, 0, 0],
        [0, -1, 0],
        [0, -1, 0],
        [0, 0, 1],
        [0, 0, 1],
    ],
    dtype=np.float32,
)

KIT_KINEMATIC_CHAIN = [
    [0, 11, 12, 13, 14, 15],
    [0, 16, 17, 18, 19, 20],
    [0, 1, 2, 3, 4],
    [3, 5, 6, 7],
    [3, 8, 9, 10],
]

# Dataset-convention joint indices for the SMPL-22 skeleton (HumanML3D / NTU):
# face direction (r_hip, l_hip, sdr_r, sdr_l), feet, lower legs.
T2M_FACE_JOINT_INDICES = [2, 1, 17, 16]
T2M_FID_R = [8, 11]
T2M_FID_L = [7, 10]
T2M_LOWER_LEG_INDICES = (5, 8)

KIT_FACE_JOINT_INDICES = [11, 16, 5, 8]
KIT_FID_R = [14, 15]
KIT_FID_L = [19, 20]
KIT_LOWER_LEG_INDICES = (17, 18)


def parents_from_chains(chains: list[list[int]], n_joints: int) -> list[int]:
    """Parent index per joint from kinematic chains; root's parent is -1."""
    parents = [0] * n_joints
    parents[0] = -1
    for chain in chains:
        for j in range(1, len(chain)):
            parents[chain[j]] = chain[j - 1]
    return parents
