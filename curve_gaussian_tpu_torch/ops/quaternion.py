"""Quaternion / rotation utilities (batched, differentiable).

Quaternions are (w, x, y, z), real part first.  Mirrors
``curve_gaussian_tpu/ops/quaternion.py``.
"""
from __future__ import annotations

import torch


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] (w,x,y,z) -> [..., 3, 3] rotation matrix (callers pass unit
    quaternions)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1.0 - 2.0 * (y * y + z * z)
    r01 = 2.0 * (x * y - w * z)
    r02 = 2.0 * (x * z + w * y)
    r10 = 2.0 * (x * y + w * z)
    r11 = 1.0 - 2.0 * (x * x + z * z)
    r12 = 2.0 * (y * z - w * x)
    r20 = 2.0 * (x * z - w * y)
    r21 = 2.0 * (y * z + w * x)
    r22 = 1.0 - 2.0 * (x * x + y * y)
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def _sqrt_positive_part(x: torch.Tensor) -> torch.Tensor:
    # double-where keeps the gradient finite at x <= 0
    pos = x > 0
    safe = torch.where(pos, x, torch.ones_like(x))
    return torch.where(pos, torch.sqrt(safe), torch.zeros_like(x))


def standardize_quaternion(q: torch.Tensor) -> torch.Tensor:
    """Force a non-negative real part (q and -q encode the same rotation)."""
    return torch.where(q[..., 0:1] < 0, -q, q)


def rotmat_to_quat(rot: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 4] unit quaternion (branch-free: all four
    candidates are built and the best-conditioned one is taken)."""
    batch_shape = rot.shape[:-2]
    m = rot.reshape(batch_shape + (9,))
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = [m[..., i] for i in range(9)]

    q_abs = _sqrt_positive_part(
        torch.stack(
            [
                1.0 + m00 + m11 + m22,
                1.0 + m00 - m11 - m22,
                1.0 - m00 + m11 - m22,
                1.0 - m00 - m11 + m22,
            ],
            dim=-1,
        )
    )
    quat_by_rijk = torch.stack(
        [
            torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], dim=-1),
            torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], dim=-1),
            torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], dim=-1),
            torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], dim=-1),
        ],
        dim=-2,
    )
    flr = torch.full((), 0.1, dtype=q_abs.dtype, device=q_abs.device)
    quat_candidates = quat_by_rijk / (2.0 * torch.maximum(q_abs[..., None], flr))
    best = torch.argmax(q_abs, dim=-1)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    out = torch.gather(quat_candidates, -2, idx)[..., 0, :]
    return standardize_quaternion(out)


def quat_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product, [..., 4] x [..., 4] -> [..., 4]."""
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def rotate_by_quat(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Rotate points p [..., 3] by unit quaternions q [..., 4]."""
    pq = torch.cat([torch.zeros_like(p[..., :1]), p], dim=-1)
    q_conj = torch.cat([q[..., 0:1], -q[..., 1:4]], dim=-1)
    return quat_multiply(quat_multiply(q, pq), q_conj)[..., 1:]
