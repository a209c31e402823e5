"""The port's motion geometry against hig_tpu on the CPU: quaternions,
skeleton FK/IK and the motion codec's encode side and ``recover_from_rot``.

The same numpy inputs (seeded random ones and ``tests/golden/geometry.npz``,
the inputs ``tests/test_geometry.py`` uses) go through the JAX function and
the port's. Quaternion, FK and IK outputs within 1e-5 absolute; codec
features within 1e-4 with the foot-contact channels exactly equal; the
port's batched calls (leading clip axes, one call) equal to JAX's clip by
clip within the same tolerances. Float32 throughout, as both run it.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hig_tpu.utils import kinematics as jkin
from hig_tpu.utils import motion_codec as jcodec
from hig_tpu.utils import quaternions as jq
from hig_tpu.utils import skeleton as jsk
from hig_tpu_torch.utils import kinematics as tkin
from hig_tpu_torch.utils import motion_codec as tcodec
from hig_tpu_torch.utils import quaternions as tq
from hig_tpu_torch.utils import skeleton as tsk

GOLD = np.load(os.path.join(os.path.dirname(__file__), "golden", "geometry.npz"))
GEOM_TOL = 1e-5
FEAT_TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def t_(a):
    return torch.from_numpy(np.array(a, np.float32))


def close(got, want, tol=GEOM_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= tol, err


def unit_quats(n, seed):
    a = np.random.RandomState(seed).randn(n, 4).astype(np.float32)
    return a / np.linalg.norm(a, axis=-1, keepdims=True)


RNG = np.random.RandomState(0)
QA, QB, V = unit_quats(64, 1), unit_quats(64, 2), RNG.randn(64, 3).astype(np.float32)
E3 = (0.8 * RNG.randn(64, 3)).astype(np.float32)

# name → (JAX call, port call, numpy inputs): each run on the same inputs
QUAT_CASES = {
    "qnormalize": (jq.qnormalize, tq.qnormalize, (3 * QA,)),
    "qinv": (jq.qinv, tq.qinv, (QA,)),
    "qmul": (jq.qmul, tq.qmul, (QA, QB)),
    "qmul_golden": (jq.qmul, tq.qmul, (GOLD["q_a"], GOLD["q_b"])),
    "qrot": (jq.qrot, tq.qrot, (QA, V)),
    "qrot_golden": (jq.qrot, tq.qrot, (GOLD["q_a"], GOLD["v"])),
    "qfix": (jq.qfix, tq.qfix, (GOLD["qfix_in"],)),
    "qbetween": (jq.qbetween, tq.qbetween, (V, E3)),
    "qbetween_golden": (jq.qbetween, tq.qbetween, (GOLD["v"], GOLD["qbetween_v1_in"])),
    "expmap_to_quaternion": (jq.expmap_to_quaternion, tq.expmap_to_quaternion,
                             (np.concatenate([E3, np.zeros((2, 3), np.float32)]),)),
    "quaternion_to_matrix": (jq.quaternion_to_matrix, tq.quaternion_to_matrix, (QA,)),
    "quaternion_to_cont6d": (jq.quaternion_to_cont6d, tq.quaternion_to_cont6d, (QA,)),
    "cont6d_to_matrix": (jq.cont6d_to_matrix, tq.cont6d_to_matrix,
                         (GOLD["quat_to_cont6d"],)),
    "qpow": (lambda a: jq.qpow(a, jnp.asarray([0.0, 0.3, 1.0])),
             lambda a: tq.qpow(a, torch.tensor([0.0, 0.3, 1.0])), (QA,)),
    "qslerp": (lambda a, b: jq.qslerp(a, b, jnp.asarray([0.25, 0.5])),
               lambda a, b: tq.qslerp(a, b, torch.tensor([0.25, 0.5])), (QA, QB)),
    "lerp": (lambda a, b: jq.lerp(a, b, jnp.asarray([0.25, 0.75])),
             lambda a, b: tq.lerp(a, b, torch.tensor([0.25, 0.75])), (V, E3)),
    "gaussian_filter1d_nearest": (lambda x: jq.gaussian_filter1d_nearest(x, 2.0),
                                  lambda x: tq.gaussian_filter1d_nearest(x, 2.0),
                                  (RNG.randn(40, 3, 2).astype(np.float32),)),
    "gaussian_filter1d_sigma20": (lambda x: jq.gaussian_filter1d_nearest(x, 20.0),
                                  lambda x: tq.gaussian_filter1d_nearest(x, 20.0),
                                  (RNG.randn(48, 3).astype(np.float32),)),
}
for _order in ("xyz", "yzx", "zxy", "xzy", "yxz", "zyx"):
    QUAT_CASES[f"qeuler_{_order}"] = (lambda a, o=_order: jq.qeuler(a, o),
                                      lambda a, o=_order: tq.qeuler(a, o, deg=False) * 57.29578,
                                      (QA,))
    QUAT_CASES[f"euler_to_quaternion_{_order}"] = (
        lambda e, o=_order: jq.euler_to_quaternion(e, o),
        lambda e, o=_order: tq.euler_to_quaternion(e, o), (E3,))


@pytest.mark.parametrize("case", list(QUAT_CASES))
def test_quaternion_function_matches_jax(case):
    jfn, tfn, args = QUAT_CASES[case]
    want = np.asarray(jfn(*[jnp.asarray(a) for a in args]))
    got = tfn(*[t_(a) for a in args]).numpy()
    tol = GEOM_TOL * (60 if case.startswith("qeuler") else 1)  # degrees
    close(got, want, tol)


def test_qeuler_in_degrees_and_the_unknown_order():
    close(tq.qeuler(t_(QA), "xyz"), np.asarray(jq.qeuler(jnp.asarray(QA), "xyz")), 60 * GEOM_TOL)
    with pytest.raises(ValueError, match="unknown euler order"):
        tq.qeuler(t_(QA), "xxy")


def test_kinematics_constants_are_jaxs():
    for name in ("T2M_RAW_OFFSETS", "KIT_RAW_OFFSETS", "T2M_KINEMATIC_CHAIN",
                 "KIT_KINEMATIC_CHAIN", "T2M_FACE_JOINT_INDICES", "T2M_FID_R", "T2M_FID_L",
                 "T2M_LOWER_LEG_INDICES", "KIT_FACE_JOINT_INDICES", "KIT_FID_R", "KIT_FID_L",
                 "KIT_LOWER_LEG_INDICES"):
        got, want = getattr(tkin, name), getattr(jkin, name)
        assert np.array_equal(got, want) if isinstance(want, np.ndarray) else got == want
    for chains, n in ((jkin.T2M_KINEMATIC_CHAIN, 22), (jkin.KIT_KINEMATIC_CHAIN, 21)):
        assert tkin.parents_from_chains(chains, n) == jkin.parents_from_chains(chains, n)


def smooth_fk_inputs(T, J, seed):
    """Local rotations of smooth per-joint sinusoids and a slow root walk."""
    rs = np.random.RandomState(seed)
    t = np.linspace(0, 2 * np.pi, T)[:, None, None]
    angles = 0.2 * np.sin(t * rs.uniform(0.5, 1.5, (1, J, 3)) + rs.rand(1, J, 3))
    quat = np.asarray(jq.expmap_to_quaternion(jnp.asarray(angles.reshape(-1, 3), jnp.float32)))
    root = np.stack([0.01 * np.arange(T), 0.9 + 0.02 * np.sin(t[:, 0, 0]), np.zeros(T)], -1)
    return quat.reshape(T, J, 4), root.astype(np.float32)


T2M = (jkin.T2M_RAW_OFFSETS, jkin.T2M_KINEMATIC_CHAIN, jkin.T2M_FACE_JOINT_INDICES)
KIT = (jkin.KIT_RAW_OFFSETS, jkin.KIT_KINEMATIC_CHAIN, jkin.KIT_FACE_JOINT_INDICES)
REST = GOLD["rest_offsets"]


def kit_rest():
    bone = 0.2 + 0.1 * np.random.RandomState(0).rand(21)
    bone[0] = 0.0
    return (jkin.KIT_RAW_OFFSETS * bone[:, None]).astype(np.float32)


def skeleton_case(case):
    """(joints, raw offsets, chains, face joints, rest offsets): the golden
    t2m clip, or a seeded random KIT motion made by JAX's FK."""
    if case == "golden_t2m":
        return GOLD["joints"], *T2M, REST
    quat, root = smooth_fk_inputs(30, 21, 3)
    joints = np.asarray(jsk.forward_kinematics(jnp.asarray(quat), jnp.asarray(root),
                                               jnp.asarray(kit_rest()), KIT[1]))
    return joints, *KIT, kit_rest()


@pytest.mark.parametrize("case", ["golden_t2m", "kit"])
def test_skeleton_matches_jax_clip_by_clip_and_batched(case):
    """offsets_from_joints, forward_direction (smoothed or not), IK (smoothed
    or not), FK and FK on cont6d, the port's over two clips at once."""
    joints, raw, chains, face, rest = skeleton_case(case)
    pair = np.stack([joints, joints[::-1].copy() * 1.1])
    rest_j = jnp.asarray(rest)
    for smooth in (False, True):
        want_dir = [np.asarray(jsk.forward_direction(jnp.asarray(j), face, smooth)) for j in pair]
        close(tsk.forward_direction(t_(pair), face, smooth), np.stack(want_dir))
        want = [np.asarray(jsk.inverse_kinematics(jnp.asarray(j), jnp.asarray(raw), chains, face,
                                                  smooth)) for j in pair]
        got = tsk.inverse_kinematics(t_(pair), raw, chains, face, smooth)
        close(got, np.stack(want))
    close(tsk.offsets_from_joints(t_(pair[:, 0]), raw, chains),
          np.stack([np.asarray(jsk.offsets_from_joints(jnp.asarray(j[0]), jnp.asarray(raw),
                                                       chains)) for j in pair]))
    quat = np.stack(want)
    fk = [np.asarray(jsk.forward_kinematics(jnp.asarray(qq), jnp.asarray(j[:, 0]), rest_j,
                                            chains)) for qq, j in zip(quat, pair)]
    close(tsk.forward_kinematics(t_(quat), t_(pair[:, :, 0]), rest, chains), np.stack(fk))
    c6 = np.asarray(jq.quaternion_to_cont6d(jnp.asarray(quat)))
    fk6 = [np.asarray(jsk.forward_kinematics_cont6d(jnp.asarray(c), jnp.asarray(j[:, 0]), rest_j,
                                                    chains, do_root_rotation=root))
           for c, j, root in zip(c6, pair, (True, True))]
    close(tsk.forward_kinematics_cont6d(t_(c6), t_(pair[:, :, 0]), rest, chains), np.stack(fk6))
    no_root = np.asarray(jsk.forward_kinematics(jnp.asarray(quat[0]), jnp.asarray(pair[0, :, 0]),
                                                rest_j, chains, do_root_rotation=False))
    close(tsk.forward_kinematics(t_(quat[0]), t_(pair[0, :, 0]), rest, chains,
                                 do_root_rotation=False), no_root)


def actor_pair(joints):
    """A second actor: the motion turned and shifted in the world."""
    yaw = jnp.asarray([np.cos(0.4), 0.0, np.sin(0.4), 0.0], jnp.float32)
    j1 = jnp.asarray(joints)
    j2 = jq.qrot(jnp.broadcast_to(yaw, j1.shape[:-1] + (4,)), j1) + jnp.asarray([1.2, 0.0, 0.7])
    return np.asarray(j1), np.asarray(j2, np.float32)


# foot-contact thresholds at which some frames of each clip touch and some
# do not (the golden clip's 0.002 of the codec's default)
FEET_THRE = {"t2m": 0.002, "kit": 0.002}


def assert_features_close(got, want, spec):
    """Features within FEAT_TOL, the foot contacts (the last 4 channels of
    every row but an init row) exactly equal."""
    close(got, want, FEAT_TOL)
    assert np.array_equal(np.asarray(got)[..., -4:], np.asarray(want)[..., -4:])


@pytest.mark.parametrize("family", ["t2m", "kit"])
def test_process_file_and_encode_pair_match_jax(family):
    """process_file and encode_pair for each skeleton (t2m also retargeted),
    the port's encode_pair batched over two clips; then recover_from_rot of
    the features."""
    if family == "t2m":
        spec_j, spec_t, joints, rest = jcodec.t2m_spec(), tcodec.t2m_spec(), GOLD["joints"], REST
    else:
        spec_j, spec_t = jcodec.kit_spec(), tcodec.kit_spec()
        joints, rest = skeleton_case("kit")[0], kit_rest()
    thre = FEET_THRE[family]
    feats, canon = jcodec.process_file(jnp.asarray(joints), thre, jnp.asarray(rest), spec_j)
    got, got_canon = tcodec.process_file(t_(joints), thre, rest, spec_t)
    assert_features_close(got, feats, spec_t)
    close(got_canon, canon, FEAT_TOL)
    assert 0 < float(np.asarray(feats)[:, -4:].sum()) < feats.shape[0] * 4
    j1, j2 = actor_pair(joints)
    j1b, j2b = np.stack([j1, j2[::-1]]), np.stack([j2, j1[::-1]])
    for retarget in (False, True) if family == "t2m" else (False,):
        want = [np.asarray(jcodec.encode_pair(jnp.asarray(a), jnp.asarray(b), thre, spec_j,
                                              jnp.asarray(rest), retarget))
                for a, b in zip(j1b, j2b)]
        got = tcodec.encode_pair(t_(j1b), t_(j2b), thre, spec_t, rest, retarget)
        assert got.shape == (2, 2, joints.shape[0], spec_t.dim_pose)
        assert_features_close(got[..., :-1, :], np.stack(want)[..., :-1, :], spec_t)
        close(got[..., -1, :], np.stack(want)[..., -1, :], FEAT_TOL)
    chains = spec_j.chains
    want_rot = jcodec.recover_from_rot(feats, spec_j.joints_num, jnp.asarray(rest), chains)
    got_rot = tcodec.recover_from_rot(t_(np.asarray(feats)), spec_t.joints_num, rest, chains)
    close(got_rot, want_rot, FEAT_TOL)
    batched = tcodec.recover_from_rot(t_(np.stack([feats, feats])), spec_t.joints_num, rest,
                                      chains)
    close(batched, np.stack([want_rot, want_rot]), FEAT_TOL)


def test_encode_pair_without_offsets_refuses_retargeting():
    j1, j2 = actor_pair(GOLD["joints"])
    with pytest.raises(ValueError, match="target_offsets"):
        tcodec.encode_pair(t_(j1), t_(j2), 0.002, tcodec.t2m_spec(), retarget=True)
