"""SMPLify 3D: SMPL bodies fitted to generated joints with L-BFGS
(counterpart of ``hig_tpu/smpl/smplify.py``).

The two stages of the reference's SMPLify3D over every frame of both actors
in one batch: (1) the camera translation and global orientation against the
torso joints, (2) the body pose, orientation, translation and, with
``optimize_betas``, the shape against the Geman-McClure joint term, the GMM
pose prior, the knee and elbow angle prior, the shape prior and the
pose-preserving term, plus, with ``use_collision``, the cross-part
interpenetration penalty on every ``collision_stride``-th vertex. Each
stage runs :func:`~hig_tpu_torch.smpl.lbfgs.lbfgs_run`, optax's L-BFGS.
Where a stage's objective reads only the joints (the camera stage, and the
body stage without collision) it computes them with ``lbs_joints``: the V
vertices are skinned once, for the result. The objectives copy nothing from
the host (indices through ``lbs.device_index``), so on the card each
evaluation replays one CUDA graph of the objective and its gradient
(``lbfgs_run``'s doc).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from hig_tpu_torch.smpl.lbfgs import LBFGSInfo, lbfgs_run
from hig_tpu_torch.smpl.lbs import SMPLModel, device_index, lbs, lbs_joints
from hig_tpu_torch.smpl.prior import GMMPrior

# SMPL joint indices of (RHip, LHip, RShoulder, LShoulder)
TORSO_SMPL_IDX = (2, 1, 17, 16)


def gmof(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """The Geman-McClure robust error."""
    x2, s2 = x ** 2, sigma ** 2
    return (s2 * x2) / (s2 + x2)


def collision_loss(vertices: torch.Tensor, part_ids: torch.Tensor, margin: float = 0.02,
                   weight: float = 1000.0) -> torch.Tensor:
    """weight · Σ_{i<j, part_i ≠ part_j} relu(margin² − ‖v_i − v_j‖²) over
    vertices (..., K, 3) with body-part ids (K,)."""
    sq = (vertices ** 2).sum(dim=-1)
    d2 = sq[..., :, None] + sq[..., None, :] - 2.0 * torch.einsum(
        "...kc,...lc->...kl", vertices, vertices)
    cross_part = (part_ids[:, None] != part_ids[None, :]).to(vertices.dtype)
    pen = torch.relu(margin ** 2 - d2) * cross_part
    return 0.5 * weight * pen.sum()  # the symmetric matrix counts each pair twice


def vertex_parts(model: SMPLModel) -> torch.Tensor:
    """Each vertex's body part: its dominant skinning joint."""
    return torch.argmax(model.lbs_weights, dim=-1)


def angle_prior(body_pose: torch.Tensor) -> torch.Tensor:
    """The knee and elbow bending prior of body_pose (..., 69) → (..., 4):
    exp(±θ)² of the knees' and elbows' bending angles, signs (+, −, −, −)."""
    bend = torch.stack([body_pose[..., 55 - 3], -body_pose[..., 58 - 3],
                        -body_pose[..., 12 - 3], -body_pose[..., 15 - 3]], dim=-1)
    return torch.exp(bend) ** 2


def _torso(joints: torch.Tensor) -> torch.Tensor:
    return joints.index_select(-2, device_index(TORSO_SMPL_IDX, joints.device))


def guess_init_3d(model_joints: torch.Tensor, j3d: torch.Tensor) -> torch.Tensor:
    """The initial camera translation from the torso joints: model_joints
    (..., 24, 3), j3d (..., 22, 3) → (..., 3)."""
    return (_torso(j3d) - _torso(model_joints)).mean(dim=-2)


def camera_fitting_loss_3d(model_joints, camera_t, camera_t_est, j3d,
                           depth_loss_weight: float = 100.0):
    """The camera stage's objective (the AMASS category)."""
    mj = model_joints + camera_t[..., None, :]
    j3d_err = (_torso(j3d) - _torso(mj)) ** 2
    depth = (depth_loss_weight ** 2) * (camera_t - camera_t_est) ** 2
    # the reference broadcasts the depth term over the 4 torso joints
    return (j3d_err + depth[..., None, :]).sum()


def body_fitting_loss_3d(body_pose, preserve_pose, betas, model_joints, camera_t, j3d,
                         pose_prior: GMMPrior, joints3d_conf, sigma: float = 100.0,
                         pose_prior_weight: float = 4.78 * 1.5,
                         shape_prior_weight: float = 5.0, angle_prior_weight: float = 15.2,
                         joint_loss_weight: float = 500.0, pose_preserve_weight: float = 0.0):
    """The body stage's objective; model_joints and j3d (..., 22, 3)."""
    err = gmof(model_joints + camera_t[..., None, :] - j3d, sigma)
    joint_loss = (joint_loss_weight ** 2) * (joints3d_conf ** 2) * err.sum(dim=-1)
    prior_loss = (pose_prior_weight ** 2) * pose_prior(body_pose)
    ang_loss = (angle_prior_weight ** 2) * angle_prior(body_pose).sum(dim=-1)
    shape_loss = (shape_prior_weight ** 2) * (betas ** 2).sum(dim=-1)
    preserve = (pose_preserve_weight ** 2) * ((body_pose - preserve_pose) ** 2).sum(dim=-1)
    return (joint_loss.sum(dim=-1) + prior_loss + ang_loss + shape_loss + preserve).sum()


class SMPLifyResult(NamedTuple):
    vertices: torch.Tensor
    joints: torch.Tensor
    pose: torch.Tensor  # (N, 72)
    betas: torch.Tensor  # (N, 10)
    camera_translation: torch.Tensor  # (N, 3)
    final_loss: torch.Tensor
    camera_info: LBFGSInfo
    body_info: LBFGSInfo


@dataclasses.dataclass
class SMPLify3D:
    """The two-stage fit; the model and the prior on the device the fit
    runs on."""

    model: SMPLModel
    prior: GMMPrior
    num_iters: int = 100
    camera_outer: int = 10
    joint_loss_weight: float = 600.0  # the render path's (smplify.py:227 of the reference)
    pose_preserve_weight: float = 5.0
    use_collision: bool = False
    collision_weight: float = 1000.0
    collision_margin: float = 0.02
    collision_stride: int = 8  # vertex downsampling for the pairwise matrix

    def __call__(self, init_pose: torch.Tensor, init_betas: torch.Tensor, j3d: torch.Tensor,
                 conf_3d: torch.Tensor, optimize_betas: bool = True) -> SMPLifyResult:
        """init_pose (N, 72), init_betas (N, 10), j3d (N, 22, 3), conf_3d
        (22,) or a scalar, all on the model's device."""
        model = self.model
        body_pose, global_orient, betas = init_pose[:, 3:], init_pose[:, :3], init_betas
        preserve_pose = body_pose
        with torch.no_grad():
            model_joints = lbs_joints(model, betas, torch.cat([global_orient, body_pose], -1))
        init_cam_t = guess_init_3d(model_joints, j3d)

        def cam_loss(p):
            pose = torch.cat([p["global_orient"], body_pose], dim=-1)
            mj = lbs_joints(model, betas, pose)
            return camera_fitting_loss_3d(mj[:, :22], p["cam_t"], init_cam_t, j3d)

        cam_params, _, camera_info = lbfgs_run(
            cam_loss, {"global_orient": global_orient, "cam_t": init_cam_t},
            self.camera_outer * self.num_iters)
        parts = (vertex_parts(model)[:: self.collision_stride] if self.use_collision
                 else None)

        def body_loss(p):
            b = p["betas"] if optimize_betas else betas
            pose = torch.cat([p["global_orient"], p["body_pose"]], dim=-1)
            if self.use_collision:
                mv, mj = lbs(model, b, pose)
            else:
                mj = lbs_joints(model, b, pose)
            loss = body_fitting_loss_3d(
                p["body_pose"], preserve_pose, b, mj[:, :22], p["cam_t"], j3d, self.prior,
                conf_3d, joint_loss_weight=self.joint_loss_weight,
                pose_preserve_weight=self.pose_preserve_weight)
            if self.use_collision:
                loss = loss + collision_loss(mv[:, :: self.collision_stride], parts,
                                             margin=self.collision_margin,
                                             weight=self.collision_weight)
            return loss

        body_params = {"body_pose": body_pose, "global_orient": cam_params["global_orient"],
                       "cam_t": cam_params["cam_t"]}
        if optimize_betas:
            body_params["betas"] = betas
        body_params, _, body_info = lbfgs_run(body_loss, body_params, self.num_iters)
        if optimize_betas:
            betas = body_params["betas"]
        pose = torch.cat([body_params["global_orient"], body_params["body_pose"]], dim=-1)
        with torch.no_grad():
            vertices, joints = lbs(model, betas, pose, body_params["cam_t"])
            final_loss = body_loss(body_params)
        return SMPLifyResult(vertices=vertices, joints=joints, pose=pose, betas=betas,
                             camera_translation=body_params["cam_t"], final_loss=final_loss,
                             camera_info=camera_info, body_info=body_info)
