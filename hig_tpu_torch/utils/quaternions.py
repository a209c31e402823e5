"""Quaternion and rotation math in PyTorch (counterpart of
``hig_tpu/utils/quaternions.py``). Quaternions are (..., 4) with the scalar
part first (w, x, y, z); every function broadcasts over leading dims and
runs on the device of its inputs. ``qmul`` keeps the reference's component
formula, on which the codec's root velocity and the IK chains depend.
"""

from __future__ import annotations

import math

import torch


def const(values, like: torch.Tensor) -> torch.Tensor:
    """``values`` as a tensor of ``like``'s dtype on its device."""
    return torch.as_tensor(values, dtype=like.dtype, device=like.device)


def qnormalize(q: torch.Tensor) -> torch.Tensor:
    """Quaternions scaled to unit length."""
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def qinv(q: torch.Tensor) -> torch.Tensor:
    """Conjugate of unit quaternion(s): negate the vector part."""
    return q * const([1.0, -1.0, -1.0, -1.0], q)


def qmul(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Compose quaternions with the reference's component formula."""
    q0, q1, q2, q3 = q.unbind(-1)
    r0, r1, r2, r3 = r.unbind(-1)
    w = r0 * q0 - r1 * q1 - r2 * q2 - r3 * q3
    x = r0 * q1 + r1 * q0 - r2 * q3 + r3 * q2
    y = r0 * q2 + r1 * q3 + r2 * q0 - r3 * q1
    z = r0 * q3 - r1 * q2 + r2 * q1 + r3 * q0
    return torch.stack([w, x, y, z], dim=-1)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def qrot(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors ``v`` (..., 3) by quaternions ``q`` (..., 4):
    v' = v + 2 (w (u × v) + u × (u × v)) with u the vector part."""
    u = q[..., 1:]
    w = q[..., :1]
    uv = _cross(u, v)
    uuv = _cross(u, uv)
    return v + 2.0 * (w * uv + uuv)


def qfix(q: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Antipodal continuity along the time axis ``dim`` (JAX: axis 0): flip
    q[t] wherever the count of negative dot products of consecutive
    quaternions up to t is odd."""
    q = q.movedim(dim, 0)
    dots = (q[1:] * q[:-1]).sum(-1)
    flip = torch.cumsum((dots < 0).to(torch.int32), dim=0) % 2
    sign = torch.where(flip.bool(), -1.0, 1.0)[..., None].to(q.dtype)
    return torch.cat([q[:1], q[1:] * sign], dim=0).movedim(0, dim)


def qbetween(v0: torch.Tensor, v1: torch.Tensor) -> torch.Tensor:
    """Quaternion rotating ``v0`` onto ``v1``."""
    v = _cross(v0, v1)
    w = torch.sqrt((v0 * v0).sum(-1, keepdim=True) * (v1 * v1).sum(-1, keepdim=True)) \
        + (v0 * v1).sum(-1, keepdim=True)
    return qnormalize(torch.cat([w.expand(v.shape[:-1] + (1,)), v], dim=-1))


def qeuler(q: torch.Tensor, order: str, epsilon: float = 0.0, deg: bool = True) -> torch.Tensor:
    """Quaternion → Euler angles for the six axis orders."""
    q0, q1, q2, q3 = q.unbind(-1)
    lo, hi = -1.0 + epsilon, 1.0 - epsilon
    atan2, asin = torch.atan2, torch.asin

    def clip(x):
        return torch.clamp(x, lo, hi)

    if order == "xyz":
        x = atan2(2 * (q0 * q1 - q2 * q3), 1 - 2 * (q1 * q1 + q2 * q2))
        y = asin(clip(2 * (q1 * q3 + q0 * q2)))
        z = atan2(2 * (q0 * q3 - q1 * q2), 1 - 2 * (q2 * q2 + q3 * q3))
    elif order == "yzx":
        x = atan2(2 * (q0 * q1 - q2 * q3), 1 - 2 * (q1 * q1 + q3 * q3))
        y = atan2(2 * (q0 * q2 - q1 * q3), 1 - 2 * (q2 * q2 + q3 * q3))
        z = asin(clip(2 * (q1 * q2 + q0 * q3)))
    elif order == "zxy":
        x = asin(clip(2 * (q0 * q1 + q2 * q3)))
        y = atan2(2 * (q0 * q2 - q1 * q3), 1 - 2 * (q1 * q1 + q2 * q2))
        z = atan2(2 * (q0 * q3 - q1 * q2), 1 - 2 * (q1 * q1 + q3 * q3))
    elif order == "xzy":
        x = atan2(2 * (q0 * q1 + q2 * q3), 1 - 2 * (q1 * q1 + q3 * q3))
        y = atan2(2 * (q0 * q2 + q1 * q3), 1 - 2 * (q2 * q2 + q3 * q3))
        z = asin(clip(2 * (q0 * q3 - q1 * q2)))
    elif order == "yxz":
        x = asin(clip(2 * (q0 * q1 - q2 * q3)))
        y = atan2(2 * (q1 * q3 + q0 * q2), 1 - 2 * (q1 * q1 + q2 * q2))
        z = atan2(2 * (q1 * q2 + q0 * q3), 1 - 2 * (q1 * q1 + q3 * q3))
    elif order == "zyx":
        x = atan2(2 * (q0 * q1 + q2 * q3), 1 - 2 * (q1 * q1 + q2 * q2))
        y = asin(clip(2 * (q0 * q2 - q1 * q3)))
        z = atan2(2 * (q0 * q3 + q1 * q2), 1 - 2 * (q2 * q2 + q3 * q3))
    else:
        raise ValueError(f"unknown euler order: {order}")
    out = torch.stack([x, y, z], dim=-1)
    return out * (180.0 / math.pi) if deg else out


def euler_to_quaternion(e: torch.Tensor, order: str, deg: bool = False) -> torch.Tensor:
    """Euler angles → quaternion, composing per-axis rotations in ``order``
    (the reference's antipodal flip for the orders xyz, yzx and zxy kept)."""
    if deg:
        e = e * (math.pi / 180.0)
    x, y, z = e.unbind(-1)
    zeros = torch.zeros_like(x)
    axis_quats = {
        "x": torch.stack([torch.cos(x / 2), torch.sin(x / 2), zeros, zeros], dim=-1),
        "y": torch.stack([torch.cos(y / 2), zeros, torch.sin(y / 2), zeros], dim=-1),
        "z": torch.stack([torch.cos(z / 2), zeros, zeros, torch.sin(z / 2)], dim=-1),
    }
    result = None
    for axis in order:
        r = axis_quats[axis]
        result = r if result is None else qmul(result, r)
    return -result if order in ("xyz", "yzx", "zxy") else result


def expmap_to_quaternion(e: torch.Tensor) -> torch.Tensor:
    """Axis-angle (exponential map) → quaternion, stable near zero."""
    theta = torch.linalg.norm(e, dim=-1, keepdim=True)
    w = torch.cos(0.5 * theta)
    xyz = 0.5 * torch.sinc(0.5 * theta / math.pi) * e
    return torch.cat([w, xyz], dim=-1)


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Quaternion → 3×3 rotation matrix."""
    r, i, j, k = q.unbind(-1)
    two_s = 2.0 / (q * q).sum(-1)
    o = torch.stack([
        1 - two_s * (j * j + k * k), two_s * (i * j - k * r), two_s * (i * k + j * r),
        two_s * (i * j + k * r), 1 - two_s * (i * i + k * k), two_s * (j * k - i * r),
        two_s * (i * k - j * r), two_s * (j * k + i * r), 1 - two_s * (i * i + j * j),
    ], dim=-1)
    return o.reshape(q.shape[:-1] + (3, 3))


def quaternion_to_cont6d(q: torch.Tensor) -> torch.Tensor:
    """Quaternion → continuous 6-d rotation (the matrix's first two columns)."""
    m = quaternion_to_matrix(q)
    return torch.cat([m[..., 0], m[..., 1]], dim=-1)


def cont6d_to_matrix(c: torch.Tensor) -> torch.Tensor:
    """Continuous 6-d → rotation matrix by Gram-Schmidt."""
    x_raw, y_raw = c[..., 0:3], c[..., 3:6]
    x = x_raw / torch.linalg.norm(x_raw, dim=-1, keepdim=True)
    z = _cross(x, y_raw)
    z = z / torch.linalg.norm(z, dim=-1, keepdim=True)
    y = _cross(z, x)
    return torch.stack([x, y, z], dim=-1)


def qpow(q0: torch.Tensor, t) -> torch.Tensor:
    """Unit quaternion(s) to the power(s) ``t``; for a tensor ``t`` the
    result has shape t.shape + q0.shape."""
    q0 = qnormalize(q0)
    theta0 = torch.acos(torch.clamp(q0[..., 0], -1.0, 1.0))
    theta0 = torch.where(theta0.abs() <= 1e-9, torch.full_like(theta0, 1e-9), theta0)
    v0 = q0[..., 1:] / torch.sin(theta0)[..., None]
    t = torch.as_tensor(t, dtype=q0.dtype, device=q0.device)
    theta = t.reshape(t.shape + (1,) * theta0.ndim) * theta0
    w = torch.cos(theta)[..., None]
    xyz = v0 * torch.sin(theta)[..., None]
    return torch.cat([w, xyz.expand(theta.shape + (3,))], dim=-1)


def qslerp(q0: torch.Tensor, q1: torch.Tensor, t) -> torch.Tensor:
    """Spherical interpolation at the fractions ``t``."""
    q0, q1 = qnormalize(q0), qnormalize(q1)
    q_ = qpow(qmul(q1, qinv(q0)), t)
    t = torch.as_tensor(t, dtype=q0.dtype, device=q0.device)
    return qmul(q_, q0.expand(t.shape + q0.shape))


def lerp(p0: torch.Tensor, p1: torch.Tensor, t) -> torch.Tensor:
    """Linear interpolation, ``t``'s shape leading."""
    t = torch.as_tensor(t, dtype=p0.dtype, device=p0.device)
    return p0 + t.reshape(t.shape + (1,) * p0.ndim) * (p1 - p0)


def gaussian_filter1d_nearest(x: torch.Tensor, sigma: float, truncate: float = 4.0,
                              dim: int = 0) -> torch.Tensor:
    """``scipy.ndimage.gaussian_filter1d(mode="nearest")`` along ``dim``
    (JAX: axis 0): a correlation with scipy's truncated kernel (radius
    int(truncate σ + 0.5), float32 weights normalized to sum 1), the edges
    replicated."""
    radius = int(truncate * sigma + 0.5)
    i = torch.arange(-radius, radius + 1, dtype=torch.float32, device=x.device)
    kernel = torch.exp(-0.5 * (i / sigma) ** 2)
    kernel = (kernel / kernel.sum()).to(x.dtype)
    xt = x.movedim(dim, -1)
    xp = torch.cat([xt[..., :1].expand(*xt.shape[:-1], radius), xt,
                    xt[..., -1:].expand(*xt.shape[:-1], radius)], dim=-1)
    out = xp.unfold(-1, 2 * radius + 1, 1) @ kernel
    return out.movedim(-1, dim)
