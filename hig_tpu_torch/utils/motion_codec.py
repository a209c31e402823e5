"""The 263-d HumanML3D-style motion codec in PyTorch (counterpart of
``hig_tpu/utils/motion_codec.py``): both halves, encode and decode.

A motion of T frames over J joints is T - 1 feature rows
``[root(4) | ric (J-1)*3 | rot6d (J-1)*6 | local_vel J*3 | foot 4]``
(263 for J = 22); the two-actor layout adds a 4-channel init token (x, z,
quat_w, quat_y) per actor, as one trailing row, that places the actor's
canonical-frame motion in the shared world frame.

Encode: :class:`CodecSpec` (:func:`t2m_spec`, :func:`kit_spec`),
:func:`uniform_skeleton` (retarget onto canonical bone lengths),
:func:`canonical_transform`, :func:`extract_features` (with
:func:`_foot_contacts`), :func:`process_file` (one actor) and
:func:`encode_pair` (two actors with their init tokens). JAX writes them
over one clip and batches with ``vmap``; here each takes leading batch dims
(joints (..., T, J, 3)), so a batch of clips is one call on the device.
Decode: :func:`recover_root_rot_pos`, :func:`recover_from_ric`,
:func:`recover_from_rot` (FK on the rot6d channels),
:func:`apply_init_token` and :func:`recover_from_ric2`, over leading batch
dims too.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from hig_tpu_torch.utils import kinematics as kin
from hig_tpu_torch.utils import quaternions as q
from hig_tpu_torch.utils import skeleton as sk


class CodecSpec(NamedTuple):
    """One skeleton family's static configuration."""

    raw_offsets: np.ndarray
    chains: tuple
    face_joint_idx: tuple
    fid_r: tuple
    fid_l: tuple
    lower_leg_idx: tuple
    joints_num: int

    @property
    def dim_pose(self) -> int:
        j = self.joints_num
        return 4 + (j - 1) * 3 + (j - 1) * 6 + j * 3 + 4


def t2m_spec() -> CodecSpec:
    """The SMPL-22 skeleton of HumanML3D and NTU (dim_pose 263)."""
    return CodecSpec(kin.T2M_RAW_OFFSETS, tuple(tuple(c) for c in kin.T2M_KINEMATIC_CHAIN),
                     tuple(kin.T2M_FACE_JOINT_INDICES), tuple(kin.T2M_FID_R),
                     tuple(kin.T2M_FID_L), kin.T2M_LOWER_LEG_INDICES, 22)


def kit_spec() -> CodecSpec:
    """The KIT-ML 21-joint skeleton (dim_pose 251)."""
    return CodecSpec(kin.KIT_RAW_OFFSETS, tuple(tuple(c) for c in kin.KIT_KINEMATIC_CHAIN),
                     tuple(kin.KIT_FACE_JOINT_INDICES), tuple(kin.KIT_FID_R),
                     tuple(kin.KIT_FID_L), kin.KIT_LOWER_LEG_INDICES, 21)


# --- encoding (joints → features) ------------------------------------------------------


def uniform_skeleton(positions: torch.Tensor, target_offsets, spec: CodecSpec) -> torch.Tensor:
    """Retarget joints (..., T, J, 3) onto the canonical bone lengths
    ``target_offsets`` (J, 3) by IK then FK, the root path scaled by the
    ratio of the lower legs' lengths."""
    l1, l2 = spec.lower_leg_idx
    target = q.const(target_offsets, positions)
    src = sk.offsets_from_joints(positions[..., 0, :, :], spec.raw_offsets, spec.chains)
    src_leg = src[..., l1, :].abs().amax(-1) + src[..., l2, :].abs().amax(-1)
    tgt_leg = target[l1].abs().max() + target[l2].abs().max()
    scale = tgt_leg / src_leg
    tgt_root_pos = positions[..., :, 0, :] * scale[..., None, None]
    quat_params = sk.inverse_kinematics(positions, spec.raw_offsets, spec.chains,
                                        spec.face_joint_idx)
    return sk.forward_kinematics(quat_params, tgt_root_pos, target, spec.chains)


def _foot_contacts(positions: torch.Tensor, thres: float, spec: CodecSpec) -> torch.Tensor:
    """(..., T - 1, 4) 0/1 foot contacts: a foot joint's squared frame-to-
    frame displacement below ``thres``, left feet first."""
    def contact(fid):
        d = positions[..., 1:, list(fid), :] - positions[..., :-1, list(fid), :]
        return ((d * d).sum(-1) < thres).to(positions.dtype)

    return torch.cat([contact(spec.fid_l), contact(spec.fid_r)], dim=-1)


def canonical_transform(positions: torch.Tensor, spec: CodecSpec):
    """Frame 0's canonicalization of joints (..., T, J, 3): the root's XZ to
    the origin, the initial facing to +Z. Returns (xz_offset (..., 3),
    rotation (..., 4)) with ``local = qrot(rotation, positions − xz)``."""
    frame0 = positions[..., 0, :, :]
    xz = frame0[..., 0, :] * q.const([1.0, 0.0, 1.0], positions)
    r_hip, l_hip, sdr_r, sdr_l = spec.face_joint_idx
    across = (frame0[..., r_hip, :] - frame0[..., l_hip, :]) + \
        (frame0[..., sdr_r, :] - frame0[..., sdr_l, :])
    across = across / torch.linalg.norm(across, dim=-1, keepdim=True)
    up = q.const([0.0, 1.0, 0.0], positions).expand(across.shape)
    forward = torch.linalg.cross(up, across, dim=-1)
    forward = forward / torch.linalg.norm(forward, dim=-1, keepdim=True)
    rot = q.qbetween(forward, q.const([0.0, 0.0, 1.0], positions).expand(forward.shape))
    return xz, rot


def extract_features(positions: torch.Tensor, feet_thre: float, spec: CodecSpec) -> torch.Tensor:
    """Canonicalized joints (..., T, J, 3) → features (..., T − 1,
    dim_pose): root yaw velocity, root XZ velocity in the facing frame and
    height; root-relative, re-faced joints (ric); the rot6d of the
    smoothed-forward IK; local joint velocities; foot contacts."""
    T, J = positions.shape[-3], positions.shape[-2]
    lead = positions.shape[:-3]
    feet = _foot_contacts(positions, feet_thre, spec)
    quat_params = sk.inverse_kinematics(positions, spec.raw_offsets, spec.chains,
                                        spec.face_joint_idx, smooth_forward=True)
    cont6d_params = q.quaternion_to_cont6d(quat_params)
    r_rot = quat_params[..., 0, :]  # (..., T, 4)
    velocity = q.qrot(r_rot[..., 1:, :], positions[..., 1:, 0, :] - positions[..., :-1, 0, :])
    r_velocity_quat = q.qmul(r_rot[..., 1:, :], q.qinv(r_rot[..., :-1, :]))
    local = positions - positions[..., :, 0:1, :] * q.const([1.0, 0.0, 1.0], positions)
    local = q.qrot(r_rot[..., :, None, :], local)
    root_y = local[..., :, 0, 1:2]
    r_velocity = torch.asin(r_velocity_quat[..., 2:3])
    l_velocity = velocity[..., [0, 2]]
    root_data = torch.cat([r_velocity, l_velocity, root_y[..., :-1, :]], dim=-1)
    ric_data = local[..., 1:, :].reshape(*lead, T, -1)
    rot_data = cont6d_params[..., 1:, :].reshape(*lead, T, -1)
    local_vel = q.qrot(r_rot[..., :-1, None, :],
                       positions[..., 1:, :, :] - positions[..., :-1, :, :])
    local_vel = local_vel.reshape(*lead, T - 1, J * 3)
    return torch.cat([root_data, ric_data[..., :-1, :], rot_data[..., :-1, :], local_vel, feet],
                     dim=-1)


def _floor(positions: torch.Tensor) -> torch.Tensor:
    """The lowest height of each clip of joints (..., T, J, 3): (...)."""
    return positions[..., 1].flatten(-2).amin(-1)


def process_file(positions: torch.Tensor, feet_thre: float, target_offsets, spec: CodecSpec):
    """Raw joints (..., T, J, 3) → (features (..., T − 1, dim_pose),
    canonical joints (..., T, J, 3)): retarget, floor, canonicalize,
    featurize."""
    positions = uniform_skeleton(positions, target_offsets, spec)
    up = q.const([0.0, 1.0, 0.0], positions)
    positions = positions - _floor(positions)[..., None, None, None] * up
    xz, rot = canonical_transform(positions, spec)
    positions = q.qrot(rot[..., None, None, :], positions - xz[..., None, None, :])
    return extract_features(positions, feet_thre, spec), positions


def encode_pair(joints1: torch.Tensor, joints2: torch.Tensor, feet_thre: float,
                spec: CodecSpec, target_offsets=None, retarget: bool = False) -> torch.Tensor:
    """Two actors' world-frame joints (..., T, J, 3) each → the clip (..., 2,
    T, dim_pose): rows 0..T − 2 each actor's features in its own canonical
    frame, row T − 1 its init token (x, z, quat_w, quat_y, zeros), which
    :func:`recover_from_ric2` reads to place it back. The actors share one
    floor, so their relative heights stay."""
    if retarget:
        if target_offsets is None:
            raise ValueError("retarget needs target_offsets")
        joints1 = uniform_skeleton(joints1, target_offsets, spec)
        joints2 = uniform_skeleton(joints2, target_offsets, spec)
    floor = torch.minimum(_floor(joints1), _floor(joints2))[..., None, None, None]
    up = q.const([0.0, 1.0, 0.0], joints1)
    joints1, joints2 = joints1 - floor * up, joints2 - floor * up

    def encode_actor(joints):
        xz, rot = canonical_transform(joints, spec)
        local = q.qrot(rot[..., None, None, :], joints - xz[..., None, None, :])
        feats = extract_features(local, feet_thre, spec)
        inv = q.qinv(rot)  # local → world: a pure yaw
        init = torch.zeros_like(feats[..., :1, :])
        init[..., 0, :4] = torch.stack([xz[..., 0], xz[..., 2], inv[..., 0], inv[..., 2]], -1)
        return torch.cat([feats, init], dim=-2)

    return torch.stack([encode_actor(joints1), encode_actor(joints2)], dim=-3)


# --- decoding (features → joints) ------------------------------------------------------


def recover_root_rot_pos(data: torch.Tensor):
    """Integrate root yaw + xz velocity back to the world root pose.

    ``data`` (..., T, D) → (r_rot_quat (..., T, 4), r_pos (..., T, 3)).
    """
    rot_vel = data[..., 0]
    zero = torch.zeros_like(rot_vel[..., :1])
    r_rot_ang = torch.cumsum(torch.cat([zero, rot_vel[..., :-1]], dim=-1), dim=-1)
    zeros = torch.zeros_like(r_rot_ang)
    r_rot_quat = torch.stack(
        [torch.cos(r_rot_ang), zeros, torch.sin(r_rot_ang), zeros], dim=-1
    )
    xz_vel = data[..., :-1, 1:3]
    step = torch.cat(
        [xz_vel[..., 0:1], torch.zeros_like(xz_vel[..., 0:1]), xz_vel[..., 1:2]], dim=-1
    )
    zero3 = torch.zeros(data.shape[:-2] + (1, 3), dtype=data.dtype, device=data.device)
    r_pos = torch.cat([zero3, step], dim=-2)
    r_pos = torch.cumsum(q.qrot(q.qinv(r_rot_quat), r_pos), dim=-2)
    r_pos = torch.cat([r_pos[..., :1], data[..., 3:4], r_pos[..., 2:]], dim=-1)
    return r_rot_quat, r_pos


def recover_from_ric(data: torch.Tensor, joints_num: int) -> torch.Tensor:
    """Features (..., T, D) → joints (..., T, J, 3) from the ric channels."""
    r_rot_quat, r_pos = recover_root_rot_pos(data)
    positions = data[..., 4 : (joints_num - 1) * 3 + 4]
    positions = positions.reshape(positions.shape[:-1] + (joints_num - 1, 3))
    positions = q.qrot(q.qinv(r_rot_quat)[..., None, :], positions)
    xz = torch.tensor([1.0, 0.0, 1.0], dtype=data.dtype, device=data.device)
    positions = positions + r_pos[..., None, :] * xz
    return torch.cat([r_pos[..., None, :], positions], dim=-2)


def recover_from_rot(data: torch.Tensor, joints_num: int, offsets, chains) -> torch.Tensor:
    """Features (..., T, D) → joints (..., T, J, 3) by FK on the rot6d
    channels and the integrated root, with bone ``offsets`` (J, 3)."""
    r_rot_quat, r_pos = recover_root_rot_pos(data)
    r_rot_cont6d = q.quaternion_to_cont6d(r_rot_quat)
    start = 1 + 2 + 1 + (joints_num - 1) * 3
    end = start + (joints_num - 1) * 6
    cont6d = torch.cat([r_rot_cont6d, data[..., start:end]], dim=-1)
    cont6d = cont6d.reshape(*cont6d.shape[:-1], joints_num, 6)
    return sk.forward_kinematics_cont6d(cont6d, r_pos, offsets, chains)


def apply_init_token(positions: torch.Tensor, init_state: torch.Tensor) -> torch.Tensor:
    """Place canonical-frame joints (..., T, J, 3) into the world frame;
    ``init_state`` (..., 4) = (x, z, quat_w, quat_y)."""
    w = init_state[..., 2]
    y = init_state[..., 3]
    zeros = torch.zeros_like(w)
    quat = torch.stack([w, zeros, y, zeros], dim=-1)
    out = q.qrot(quat[..., None, None, :], positions)
    offset = torch.stack([init_state[..., 0], zeros, init_state[..., 1]], dim=-1)
    return out + offset[..., None, None, :]


def recover_from_ric2(data1: torch.Tensor, data2: torch.Tensor, joints_num: int,
                      init_last: bool = True):
    """Two-actor decode into a shared world frame. ``data1``/``data2`` are
    (..., T+1, D) including the init-token row (last row when
    ``init_last``, first row otherwise)."""
    if init_last:
        feats1, init1 = data1[..., :-1, :], data1[..., -1, :4]
        feats2, init2 = data2[..., :-1, :], data2[..., -1, :4]
    else:
        feats1, init1 = data1[..., 1:, :], data1[..., 0, :4]
        feats2, init2 = data2[..., 1:, :], data2[..., 0, :4]
    pos1 = recover_from_ric(feats1, joints_num)
    pos2 = recover_from_ric(feats2, joints_num)
    return apply_init_token(pos1, init1), apply_init_token(pos2, init2)
