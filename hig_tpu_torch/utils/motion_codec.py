"""Decode half of the 263-d HumanML3D-style motion codec (counterpart of
``hig_tpu/utils/motion_codec.py:259-357``).

A motion of T frames over J joints is T feature rows
``[root(4) | ric (J-1)*3 | rot6d (J-1)*6 | local_vel J*3 | foot 4]``; the
two-actor layout adds a 4-channel init token (x, z, quat_w, quat_y) per
actor that places the actor's canonical-frame motion in the shared world
frame. Decoders broadcast over leading batch dims.
"""

from __future__ import annotations

import torch

from hig_tpu_torch.utils import quaternions as q


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
