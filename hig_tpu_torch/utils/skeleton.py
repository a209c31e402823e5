"""Skeleton forward and inverse kinematics in PyTorch (counterpart of
``hig_tpu/utils/skeleton.py``).

JAX writes each function over one clip's (T, J, ...) and batches with
``vmap``; here each takes any leading batch dims, (..., T, J, ...), so a
batch of clips is one call on the device. The kinematic chains are static
Python structure: the walk over a chain unrolls into a few quaternion ops
on whole (..., T) slices.
"""

from __future__ import annotations

from typing import Sequence

import torch

from hig_tpu_torch.utils import quaternions as q
from hig_tpu_torch.utils.kinematics import parents_from_chains


def offsets_from_joints(joints: torch.Tensor, raw_offsets, chains: Sequence[Sequence[int]]
                        ) -> torch.Tensor:
    """Bone-length-scaled offsets from rest poses (..., J, 3):
    offsets[i] = |joints[i] − joints[parent(i)]| · raw_offsets[i], the root's
    its raw offset."""
    raw = q.const(raw_offsets, joints)
    parents = parents_from_chains([list(c) for c in chains], raw.shape[0])
    parent_idx = [max(p, 0) for p in parents]
    bone = torch.linalg.norm(joints - joints[..., parent_idx, :], dim=-1, keepdim=True)
    offsets = bone * raw
    return torch.cat([raw[:1].expand(offsets[..., :1, :].shape), offsets[..., 1:, :]], dim=-2)


def forward_direction(joints: torch.Tensor, face_joint_idx: Sequence[int], smooth: bool = False,
                      smooth_sigma: float = 20.0) -> torch.Tensor:
    """Per-frame unit forward (facing) vectors (..., T, 3) of joints (..., T,
    J, 3) from the hips and shoulders, smoothed over time with ``smooth``.
    The face joints unpack as (l_hip, r_hip, sdr_r, sdr_l), as JAX's (and
    the reference's) do here."""
    l_hip, r_hip, sdr_r, sdr_l = face_joint_idx
    across = (joints[..., r_hip, :] - joints[..., l_hip, :]) + \
        (joints[..., sdr_r, :] - joints[..., sdr_l, :])
    across = across / torch.linalg.norm(across, dim=-1, keepdim=True)
    up = q.const([0.0, 1.0, 0.0], joints)
    forward = torch.linalg.cross(up.expand(across.shape), across, dim=-1)
    if smooth:
        forward = q.gaussian_filter1d_nearest(forward, smooth_sigma, dim=-2)
    return forward / torch.linalg.norm(forward, dim=-1, keepdim=True)


def inverse_kinematics(joints: torch.Tensor, raw_offsets, chains: Sequence[Sequence[int]],
                       face_joint_idx: Sequence[int], smooth_forward: bool = False
                       ) -> torch.Tensor:
    """Joint positions (..., T, J, 3) → local joint quaternions (..., T, J,
    4). The root's rotates the facing direction onto +Z, and frame 0's root
    is the identity (the reference's quirk, kept)."""
    raw = q.const(raw_offsets, joints)
    forward = forward_direction(joints, face_joint_idx, smooth=smooth_forward)
    target = q.const([0.0, 0.0, 1.0], joints).expand(forward.shape)
    root_quat = q.qbetween(forward, target)
    identity = q.const([1.0, 0.0, 0.0, 0.0], joints)
    root_quat = torch.cat([identity.expand(root_quat[..., :1, :].shape), root_quat[..., 1:, :]],
                          dim=-2)
    quats = [None] * joints.shape[-2]
    quats[0] = root_quat
    for chain in chains:
        R = root_quat
        for j in range(len(chain) - 1):
            u = raw[chain[j + 1]].expand(forward.shape)
            v = joints[..., chain[j + 1], :] - joints[..., chain[j], :]
            v = v / torch.linalg.norm(v, dim=-1, keepdim=True)
            R_loc = q.qmul(q.qinv(R), q.qbetween(u, v))
            quats[chain[j + 1]] = R_loc
            R = q.qmul(R, R_loc)
    zeros = torch.zeros_like(root_quat)
    return torch.stack([zeros if r is None else r for r in quats], dim=-2)


def forward_kinematics(quat_params: torch.Tensor, root_pos: torch.Tensor, offsets,
                       chains: Sequence[Sequence[int]], do_root_rotation: bool = True
                       ) -> torch.Tensor:
    """Local quaternions (..., T, J, 4) and root positions (..., T, 3) →
    joints (..., T, J, 3); ``offsets`` (J, 3) or (..., J, 3)."""
    offsets = q.const(offsets, root_pos)
    joints = [None] * quat_params.shape[-2]
    joints[0] = root_pos
    identity = q.const([1.0, 0.0, 0.0, 0.0], quat_params).expand(quat_params[..., 0, :].shape)
    for chain in chains:
        R = quat_params[..., 0, :] if do_root_rotation else identity
        for i in range(1, len(chain)):
            R = q.qmul(R, quat_params[..., chain[i], :])
            offset = offsets[..., chain[i], :].unsqueeze(-2)
            joints[chain[i]] = q.qrot(R, offset) + joints[chain[i - 1]]
    zeros = torch.zeros_like(root_pos)
    return torch.stack([zeros if p is None else p for p in joints], dim=-2)


def forward_kinematics_cont6d(cont6d_params: torch.Tensor, root_pos: torch.Tensor, offsets,
                              chains: Sequence[Sequence[int]], do_root_rotation: bool = True
                              ) -> torch.Tensor:
    """Continuous 6-d rotations (..., T, J, 6) and root positions (..., T,
    3) → joints (..., T, J, 3); ``offsets`` (J, 3) or (..., J, 3)."""
    offsets = q.const(offsets, root_pos)
    joints = [None] * cont6d_params.shape[-2]
    joints[0] = root_pos
    eye = torch.eye(3, dtype=cont6d_params.dtype, device=cont6d_params.device)
    for chain in chains:
        matR = q.cont6d_to_matrix(cont6d_params[..., 0, :]) if do_root_rotation else eye
        for i in range(1, len(chain)):
            matR = matR @ q.cont6d_to_matrix(cont6d_params[..., chain[i], :])
            offset = offsets[..., chain[i], :].unsqueeze(-2)
            step = (matR * offset.unsqueeze(-2)).sum(-1)
            joints[chain[i]] = step + joints[chain[i - 1]]
    zeros = torch.zeros_like(root_pos)
    return torch.stack([zeros if p is None else p for p in joints], dim=-2)
