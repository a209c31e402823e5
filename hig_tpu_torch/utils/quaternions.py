"""Quaternion helpers for decoding (counterpart of
``hig_tpu/utils/quaternions.py:28-61``). Quaternions are (..., 4) with the
scalar part first (w, x, y, z); every function broadcasts over leading dims.
"""

from __future__ import annotations

import torch


def qinv(q: torch.Tensor) -> torch.Tensor:
    """Conjugate of unit quaternion(s): negate the vector part."""
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def qrot(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors ``v`` (..., 3) by quaternions ``q`` (..., 4):
    v' = v + 2 (w (u × v) + u × (u × v)) with u the vector part."""
    u = q[..., 1:]
    w = q[..., :1]
    u, v = torch.broadcast_tensors(u, v)
    uv = torch.linalg.cross(u, v, dim=-1)
    uuv = torch.linalg.cross(u, uv, dim=-1)
    return v + 2.0 * (w * uv + uuv)
