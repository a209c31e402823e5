"""The SMPL body model: linear blend skinning in PyTorch (counterpart of
``hig_tpu/smpl/lbs.py``).

:func:`lbs` maps betas (..., 10), an axis-angle pose (..., 72) and a
translation (..., 3) to vertices (..., V, 3) and joints (..., 24, 3), over
any leading axes (JAX ``vmap``s its single-frame function). The joints are
the forward-kinematics transforms' origins over the model's parent chain.
:func:`lbs_joints` computes those joints alone: the FK from the regressed
rest joints of the shaped template, whose regression (``J_regressor`` @
template and @ shape directions) is done once per model, so a fit that reads
only the joints (SMPLify's camera stage and its body stage without the
collision term, where XLA drops the skinning as dead code) never touches
the V vertices.

The model comes from ``SMPL_NEUTRAL.pkl`` (chumpy-free unpickling) or an
``.npz`` with the same field names (:func:`save_smpl_npz` writes one), or
is synthetic (:func:`synthetic_smpl_model`, the JAX package's draws, equal
to its arrays bit for bit) when the licensed asset is absent.
"""

from __future__ import annotations

import dataclasses
import io
import pickle

import numpy as np
import torch

NUM_JOINTS = 24
NUM_BETAS = 10

# the standard SMPL kinematic parents
SMPL_PARENTS = np.array(
    [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19, 20, 21]
)
FIELDS = ("v_template", "shapedirs", "posedirs", "j_regressor", "lbs_weights")


@dataclasses.dataclass
class SMPLModel:
    """SMPL's arrays as float32 tensors: v_template (V, 3), shapedirs (V,
    3, 10), posedirs (207, V·3), j_regressor (24, V), lbs_weights (V, 24);
    ``parents`` the static kinematic chain, ``faces`` (F, 3) int32 or None."""

    v_template: torch.Tensor
    shapedirs: torch.Tensor
    posedirs: torch.Tensor
    j_regressor: torch.Tensor
    lbs_weights: torch.Tensor
    parents: tuple = tuple(SMPL_PARENTS.tolist())
    faces: torch.Tensor | None = None

    def to(self, device) -> "SMPLModel":
        """The same model with its arrays on ``device``."""
        moved = {f: getattr(self, f).to(device) for f in FIELDS}
        faces = None if self.faces is None else self.faces.to(device)
        return SMPLModel(**moved, parents=self.parents, faces=faces)

    @property
    def num_vertices(self) -> int:
        return self.v_template.shape[0]

    def joint_regression(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(J_regressor @ v_template (24, 3), J_regressor @ shapedirs (24,
        3, 10)), computed at the first call and kept."""
        cached = getattr(self, "_joint_regression", None)
        if cached is None:
            template = self.j_regressor @ self.v_template
            shapedirs = torch.einsum("jv,vck->jck", self.j_regressor, self.shapedirs)
            cached = self._joint_regression = (template, shapedirs)
        return cached


def _to_np(x) -> np.ndarray:
    # chumpy arrays expose .r; plain arrays pass through
    return np.asarray(getattr(x, "r", x), dtype=np.float64)


class _ChumpyShim:
    """Unpickles a chumpy array without chumpy installed."""

    def __setstate__(self, state):
        self.__dict__.update(state)

    @property
    def r(self):
        return np.asarray(self.__dict__.get("x"))


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.startswith("chumpy"):
            return _ChumpyShim
        if module in ("scipy.sparse.csc", "scipy.sparse._csc"):
            import scipy.sparse

            return scipy.sparse.csc_matrix
        return super().find_class(module, name)


def load_smpl_model(path: str) -> SMPLModel:
    """SMPL_NEUTRAL.pkl, or an .npz with the same field names."""
    if path.endswith(".npz"):
        d = dict(np.load(path))
    else:
        with open(path, "rb") as f:
            d = _Unpickler(io.BytesIO(f.read())).load()
    j_reg = d["J_regressor"]
    if hasattr(j_reg, "toarray"):
        j_reg = j_reg.toarray()
    shapedirs = _to_np(d["shapedirs"])[..., :NUM_BETAS]
    posedirs = _to_np(d["posedirs"])
    posedirs = posedirs.reshape(-1, posedirs.shape[-1]).T  # (207, V*3)
    parents = SMPL_PARENTS[1:].tolist()
    if "kintree_table" in d:
        parents = _to_np(d["kintree_table"])[0].astype(np.int64)[1:].tolist()

    def f32(a):
        return torch.from_numpy(np.ascontiguousarray(_to_np(a), dtype=np.float32))

    return SMPLModel(
        v_template=f32(d["v_template"]), shapedirs=f32(shapedirs), posedirs=f32(posedirs),
        j_regressor=f32(j_reg), lbs_weights=f32(d["weights"]), parents=tuple([-1] + parents),
        faces=torch.from_numpy(np.asarray(d["f"], np.int32)) if "f" in d else None,
    )


def save_smpl_npz(model: SMPLModel, path: str) -> None:
    """``model`` as an .npz in SMPL's field layout, which
    :func:`load_smpl_model` reads back to the same arrays."""
    V = model.num_vertices
    posedirs = model.posedirs.cpu().numpy().T.reshape(V, 3, -1)
    arrays = dict(v_template=model.v_template.cpu().numpy(),
                  shapedirs=model.shapedirs.cpu().numpy(), posedirs=posedirs,
                  J_regressor=model.j_regressor.cpu().numpy(),
                  weights=model.lbs_weights.cpu().numpy(),
                  kintree_table=np.stack([np.asarray(model.parents), np.arange(NUM_JOINTS)]))
    if model.faces is not None:
        arrays["f"] = model.faces.cpu().numpy()
    np.savez(path, **arrays)


def synthetic_smpl_model(n_vertices: int = 512, seed: int = 0) -> SMPLModel:
    """A random SMPL-like model for tests and asset-free runs, from the JAX
    package's ``RandomState`` draws in its order: the same arrays."""
    rng = np.random.RandomState(seed)
    joints = np.zeros((NUM_JOINTS, 3), np.float32)
    offsets = rng.randn(NUM_JOINTS, 3).astype(np.float32) * 0.12
    for j in range(1, NUM_JOINTS):
        joints[j] = joints[SMPL_PARENTS[j]] + offsets[j]
    assign = rng.randint(0, NUM_JOINTS, n_vertices)
    v_template = joints[assign] + 0.05 * rng.randn(n_vertices, 3).astype(np.float32)
    j_reg = np.zeros((NUM_JOINTS, n_vertices), np.float32)
    for j in range(NUM_JOINTS):
        idx = np.where(assign == j)[0]
        if len(idx) == 0:
            idx = np.array([j % n_vertices])
        j_reg[j, idx] = 1.0 / len(idx)
    w = np.full((n_vertices, NUM_JOINTS), 1e-3, np.float32)
    w[np.arange(n_vertices), assign] = 1.0
    w /= w.sum(-1, keepdims=True)
    shapedirs = np.asarray(0.01 * rng.randn(n_vertices, 3, NUM_BETAS), np.float32)
    posedirs = np.asarray(0.001 * rng.randn(207, n_vertices * 3), np.float32)
    return SMPLModel(
        v_template=torch.from_numpy(np.asarray(v_template, np.float32)),
        shapedirs=torch.from_numpy(shapedirs), posedirs=torch.from_numpy(posedirs),
        j_regressor=torch.from_numpy(j_reg), lbs_weights=torch.from_numpy(w),
    )


def rodrigues(rot_vecs: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) → rotation matrices (..., 3, 3)."""
    angle = torch.linalg.vector_norm(rot_vecs + 1e-8, dim=-1, keepdim=True)
    axis = rot_vecs / angle
    cos = torch.cos(angle)[..., None]
    sin = torch.sin(angle)[..., None]
    rx, ry, rz = axis.unbind(-1)
    zeros = torch.zeros_like(rx)
    K = torch.stack([zeros, -rz, ry, rz, zeros, -rx, -ry, rx, zeros],
                    dim=-1).reshape(*rot_vecs.shape[:-1], 3, 3)
    eye = torch.eye(3, dtype=rot_vecs.dtype, device=rot_vecs.device)
    return eye + sin * K + (1 - cos) * (K @ K)


_INDICES: dict = {}


def device_index(values: tuple, device) -> torch.Tensor:
    """``values`` as an int64 tensor on ``device``, made once per device and
    kept: indexing with it copies nothing from the host, so a CUDA graph of
    a fit's objective (``smpl/lbfgs.py``) can capture it."""
    key = (tuple(values), str(device))
    if key not in _INDICES:
        _INDICES[key] = torch.tensor(values, dtype=torch.int64, device=device)
    return _INDICES[key]


def _forward_kinematics(parents: tuple, rot_mats: torch.Tensor,
                        joints_rest: torch.Tensor) -> torch.Tensor:
    """The world transforms (..., 24, 4, 4) of the chain: each joint's
    rotation about its rest offset from its parent, composed root first."""
    parent_idx = device_index(parents[1:], joints_rest.device)
    rel = torch.cat([joints_rest[..., :1, :],
                     joints_rest[..., 1:, :] - joints_rest.index_select(-2, parent_idx)], dim=-2)
    top = torch.cat([rot_mats, rel[..., None]], dim=-1)  # (..., 24, 3, 4)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    local = torch.cat([top, bottom], dim=-2)
    transforms = [local[..., 0, :, :]]
    for j in range(1, NUM_JOINTS):
        transforms.append(transforms[parents[j]] @ local[..., j, :, :])
    return torch.stack(transforms, dim=-3)


def lbs(model: SMPLModel, betas: torch.Tensor, pose: torch.Tensor,
        transl: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The SMPL forward over leading axes: (vertices (..., V, 3), joints
    (..., 24, 3))."""
    lead = pose.shape[:-1]
    v_shaped = model.v_template + torch.einsum("vck,...k->...vc", model.shapedirs, betas)
    joints_rest = model.j_regressor @ v_shaped  # (..., 24, 3)
    rot_mats = rodrigues(pose.reshape(*lead, NUM_JOINTS, 3))
    eye = torch.eye(3, dtype=pose.dtype, device=pose.device)
    pose_feature = (rot_mats[..., 1:, :, :] - eye).reshape(*lead, -1)  # (..., 207)
    v_posed = v_shaped + (pose_feature @ model.posedirs).reshape(v_shaped.shape)
    A = _forward_kinematics(model.parents, rot_mats, joints_rest)
    joints = A[..., :3, 3]
    # the skinning transforms: the rest-pose joint locations taken out
    correction = torch.einsum("...jab,...jb->...ja", A[..., :3, :3], joints_rest)
    A_skin = torch.cat([A[..., :3, :3], (A[..., :3, 3] - correction)[..., None]], dim=-1)
    T = torch.einsum("vj,...jab->...vab", model.lbs_weights, A_skin)  # (..., V, 3, 4)
    vertices = torch.einsum("...vab,...vb->...va", T[..., :3], v_posed) + T[..., 3]
    if transl is not None:
        vertices = vertices + transl[..., None, :]
        joints = joints + transl[..., None, :]
    return vertices, joints


def lbs_joints(model: SMPLModel, betas: torch.Tensor, pose: torch.Tensor,
               transl: torch.Tensor | None = None) -> torch.Tensor:
    """The joints of :func:`lbs` (..., 24, 3) alone: the FK from the shaped
    template's regressed rest joints, without the vertices."""
    template, shapedirs = model.joint_regression()
    joints_rest = template + torch.einsum("jck,...k->...jc", shapedirs, betas)
    rot_mats = rodrigues(pose.reshape(*pose.shape[:-1], NUM_JOINTS, 3))
    joints = _forward_kinematics(model.parents, rot_mats, joints_rest)[..., :3, 3]
    return joints if transl is None else joints + transl[..., None, :]
