"""Cubic Bézier / line-segment geometry (differentiable).

Curves are stored as 4 control points [N, 4, 3]; straight segments use rows
0 and 3 only.  Each curve is sampled into M Gaussians at t_j = (j + 0.5)/M
with long-axis scale |B(t_j) - B(t_j - 0.5/M)|, both short axes equal to
the curve width, and a rotation whose first axis is the tangent.  Mirrors
``curve_gaussian_tpu/ops/bezier.py``; the JAX version's transposed
"packed-lane" layout is TPU layout and is not copied, but the basis
matrices keep its float32-rounded coefficients so that both packages
sample the same points.

The evaluation helpers (``bezier_point`` ... ``curve_tangent``), De
Casteljau split and trim and ``curve_lengths`` keep the JAX signatures;
topology surgery runs on the host with the numpy versions in
``models/surgery.py``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def safe_norm(x: torch.Tensor, dim=-1, keepdim: bool = False, eps: float = 1e-12):
    """L2 norm with a finite gradient at 0 (returns 0 there)."""
    sq = torch.sum(x * x, dim=dim, keepdim=keepdim)
    pos = sq > eps
    return torch.where(
        pos, torch.sqrt(torch.where(pos, sq, torch.ones_like(sq))), torch.zeros_like(sq)
    )


def safe_normalize(x: torch.Tensor, dim=-1, eps: float = 1e-12):
    """x/|x| with zero output (and finite gradient) for zero input."""
    n = safe_norm(x, dim=dim, keepdim=True, eps=eps)
    return x / torch.where(n > 0, n, torch.ones_like(n))


def bezier_point(cp: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Cubic Béziers at parameters t: cp [..., 4, 3], t [T] -> [..., T, 3]."""
    t = t[..., :, None]
    p0, p1, p2, p3 = (cp[..., i, None, :] for i in range(4))
    u = 1.0 - t
    return u**3 * p0 + 3.0 * u**2 * t * p1 + 3.0 * u * t**2 * p2 + t**3 * p3


def bezier_tangent(cp: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Derivative of cubic Béziers; [..., 4, 3], [T] -> [..., T, 3]."""
    t = t[..., :, None]
    p0, p1, p2, p3 = (cp[..., i, None, :] for i in range(4))
    u = 1.0 - t
    return 3.0 * u**2 * (p1 - p0) + 6.0 * u * t * (p2 - p1) + 3.0 * t**2 * (p3 - p2)


def line_point(cp: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Linear interpolation between control rows 0 and 3."""
    t = t[..., :, None]
    p0, p3 = cp[..., 0, None, :], cp[..., 3, None, :]
    return (1.0 - t) * p0 + t * p3


def line_tangent(cp: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    d = cp[..., 3, None, :] - cp[..., 0, None, :]
    return d.expand(d.shape[:-2] + (t.shape[-1], 3))


def curve_point(cp: torch.Tensor, t: torch.Tensor, is_bezier: torch.Tensor) -> torch.Tensor:
    """Mixed Bézier/line evaluation; is_bezier [...] bool -> [..., T, 3]."""
    return torch.where(is_bezier[..., None, None], bezier_point(cp, t), line_point(cp, t))


def curve_tangent(cp: torch.Tensor, t: torch.Tensor, is_bezier: torch.Tensor) -> torch.Tensor:
    return torch.where(is_bezier[..., None, None], bezier_tangent(cp, t), line_tangent(cp, t))


def sample_t_midpoints(n_gaussians: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """t_j = (j + 0.5)/M, j = 0..M-1."""
    m = n_gaussians
    return (torch.arange(m, dtype=dtype, device=device) + 0.5) / m


def tangent_frame(tangent: torch.Tensor) -> torch.Tensor:
    """[..., 3] tangent -> [..., 3, 3] orthonormal frame whose first column
    is the tangent direction (up vector z, falling back to y when the
    tangent is parallel to z)."""
    v0 = safe_normalize(tangent)
    up1 = torch.tensor([0.0, 0.0, 1.0], dtype=tangent.dtype, device=tangent.device)
    up2 = torch.tensor([0.0, 1.0, 0.0], dtype=tangent.dtype, device=tangent.device)
    a1 = torch.linalg.cross(v0, up1.expand(v0.shape))
    a2 = torch.linalg.cross(v0, up2.expand(v0.shape))
    n1 = safe_norm(a1, keepdim=True)
    a = torch.where(n1 < 1e-4, a2, a1)
    v1 = safe_normalize(a)
    v2 = torch.linalg.cross(v0, v1)
    return torch.stack([v0, v1, v2], dim=-1)


def _elevate_lines(cp: torch.Tensor, is_bezier: torch.Tensor) -> torch.Tensor:
    """Replace line rows by their exact cubic form (p1 = p0 + d/3,
    p2 = p0 + 2d/3), so one Bézier basis evaluates both kinds; a line's
    stored rows 1-2 are ignored."""
    p0, p3 = cp[:, 0], cp[:, 3]
    d = (p3 - p0) / 3.0
    cp_lin = torch.stack([p0, p0 + d, p0 + 2.0 * d, p3], dim=1)
    return torch.where(is_bezier[:, None, None], cp, cp_lin)


@functools.lru_cache(maxsize=None)
def _bases(m: int):
    """(position, half-step-back position, tangent) bases, each [M, 4],
    rounded to float32 like the JAX package's constants."""
    t = (np.arange(m, dtype=np.float64) + 0.5) / m

    def pos(tv):
        u = 1.0 - tv
        return np.stack([u**3, 3 * u**2 * tv, 3 * u * tv**2, tv**3], axis=-1)

    def tan(tv):
        u = 1.0 - tv
        return np.stack(
            [-3 * u**2, 3 * u**2 - 6 * u * tv, 6 * u * tv - 3 * tv**2, 3 * tv**2],
            axis=-1,
        )

    return tuple(b.astype(np.float32) for b in (pos(t), pos(t - 0.5 / m), tan(t)))


@functools.lru_cache(maxsize=None)
def _bases_on(m: int, dtype, device):
    """_bases(m) as tensors on `device`, copied there once: a copy from
    host memory synchronises the stream, which a training step must not do."""
    return tuple(torch.as_tensor(b, device=device).to(dtype) for b in _bases(m))


def curve_gaussians(
    cp: torch.Tensor,
    width: torch.Tensor,
    is_bezier: torch.Tensor,
    n_gaussians: int,
    eps: float = 1e-8,
):
    """Per-Gaussian (xyz, quat, scale, tangent) from curve parameters.

    cp [N,4,3], width [N] (> 0), is_bezier [N] bool.  Returns a dict of
    xyz [N,M,3], quat [N,M,4], scale [N,M,3] = (arc spacing, width, width)
    and the unnormalised tangent [N,M,3].  Because both short axes share
    the width, the covariance depends only on the tangent axis, so the
    quaternion is the minimal rotation taking e_x to the tangent.
    """
    N = cp.shape[0]
    m = n_gaussians
    Bp, Bb, Bt = _bases_on(m, cp.dtype, cp.device)
    cpe = _elevate_lines(cp, is_bezier)  # [N, 4, 3]
    xyz = torch.einsum("mk,nkc->nmc", Bp, cpe)
    back = torch.einsum("mk,nkc->nmc", Bb, cpe)
    tan = torch.einsum("mk,nkc->nmc", Bt, cpe)

    s0 = safe_norm(xyz - back, dim=-1)  # [N, M]
    tn = safe_norm(tan, dim=-1)
    tnz = torch.where(tn > 0, tn, torch.ones_like(tn))
    v0x, v0y, v0z = tan[..., 0] / tnz, tan[..., 1] / tnz, tan[..., 2] / tnz
    # minimal rotation e_x -> v0: q ~ (1 + v0x, 0, -v0z, v0y); the v0x ~ -1
    # pole falls back to a half-turn about y
    w = 1.0 + v0x
    qn_sq = w * w + v0z * v0z + v0y * v0y
    ok = qn_sq > eps
    one = torch.ones_like(qn_sq)
    zero = torch.zeros_like(qn_sq)
    qn = torch.where(ok, torch.sqrt(torch.where(ok, qn_sq, one)), one)
    qw = torch.where(ok, w / qn, zero)
    qy = torch.where(ok, -v0z / qn, one)
    qz = torch.where(ok, v0y / qn, zero)
    quat = torch.stack([qw, zero, qy, qz], dim=-1)
    s12 = width[:, None].expand(N, m)
    scale = torch.stack([s0, s12, s12], dim=-1)
    return {"xyz": xyz, "quat": quat, "scale": scale, "tangent": tan}


def initialize_bezier_curves(points: torch.Tensor, bound: torch.Tensor) -> torch.Tensor:
    """One Y-aligned Bézier per seed point: control points at
    center ± {1, 0.5} * bound along +Y.  points [N,3], bound [N]."""
    zero = torch.zeros_like(bound)
    direction = torch.stack([zero, bound, zero], dim=-1)
    return torch.stack(
        [
            points - direction,
            points - 0.5 * direction,
            points + 0.5 * direction,
            points + direction,
        ],
        dim=1,
    )


def de_casteljau_split(cp: torch.Tensor, t: torch.Tensor, is_bezier: torch.Tensor):
    """Split curves at parameter t: cp [N, 4, 3], t [N] (or [N, 1]),
    is_bezier [N] -> (left, right), each [N, 4, 3].  A line splits
    linearly, with its interior control points at thirds."""
    t = torch.reshape(t, (-1, 1))
    c0, c1, c2, c3 = cp[:, 0], cp[:, 1], cp[:, 2], cp[:, 3]
    q0 = (1 - t) * c0 + t * c1
    q1 = (1 - t) * c1 + t * c2
    q2 = (1 - t) * c2 + t * c3
    r0 = (1 - t) * q0 + t * q1
    r1 = (1 - t) * q1 + t * q2
    s = (1 - t) * r0 + t * r1
    left_b = torch.stack([c0, q0, r0, s], dim=1)
    right_b = torch.stack([s, r1, q2, c3], dim=1)

    sl = (1 - t) * c0 + t * c3
    left_l = torch.stack(
        [c0, (2 / 3) * c0 + (1 / 3) * sl, (1 / 3) * c0 + (2 / 3) * sl, sl], dim=1
    )
    right_l = torch.stack(
        [sl, (2 / 3) * sl + (1 / 3) * c3, (1 / 3) * sl + (2 / 3) * c3, c3], dim=1
    )
    sel = is_bezier[:, None, None]
    return torch.where(sel, left_b, left_l), torch.where(sel, right_b, right_l)


def de_casteljau_trim(cp: torch.Tensor, from_t: torch.Tensor, end_t: torch.Tensor,
                      is_bezier: torch.Tensor) -> torch.Tensor:
    """The [from_t, end_t] portion of each curve: split at from_t, keep the
    right part, split it at the original end_t (the reference's semantics:
    end_t on the right part lands at another arclength)."""
    from_t = torch.clamp(torch.reshape(from_t, (-1,)), 0.0, 1.0)
    end_t = torch.clamp(torch.reshape(end_t, (-1,)), 0.0, 1.0)
    _, right = de_casteljau_split(cp, from_t, is_bezier)
    left, _ = de_casteljau_split(right, end_t, is_bezier)
    return left


def curve_lengths(cp: torch.Tensor, is_bezier: torch.Tensor, n_samples: int = 64) -> torch.Tensor:
    """Polyline arclength approximation, [N, 4, 3] -> [N]."""
    t = torch.linspace(0.0, 1.0, n_samples, dtype=cp.dtype, device=cp.device)
    pts = curve_point(cp, t, is_bezier)
    return torch.linalg.norm(torch.diff(pts, dim=-2), dim=-1).sum(dim=-1)
