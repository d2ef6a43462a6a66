"""Per-Gaussian preprocessing: projection + EWA 2D covariance.

Mirrors ``curve_gaussian_tpu/ops/projection.py``: near-plane cull at
z_view <= 0.2, EWA x/y clamp at 1.3 * tanfov, +0.3 px low-pass dilation,
optional antialiasing compensation, conic, radius = ceil(3 sqrt(lambda_max))
and the exact alpha-support extent.  The backward is torch autograd through
these formulas.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .camera import Camera
from .quaternion import quat_to_rotmat

NEAR_CULL_Z = 0.2
H_VAR = 0.3
FRUSTUM_CLAMP = 1.3


class Preprocessed(NamedTuple):
    mean2d: torch.Tensor  # [P, 2] pixel coords
    conic: torch.Tensor  # [P, 3] inverse 2D covariance (a, b, c)
    depth: torch.Tensor  # [P] view-space z
    opacity: torch.Tensor  # [P] effective opacity (AA compensation applied)
    radius: torch.Tensor  # [P] int32 screen radius (0 => culled)
    extent: torch.Tensor  # [P, 2] half-extent of the alpha-support ellipse (px)
    valid: torch.Tensor  # [P] bool


def intrinsics(height: int, width: int, tanfovx: float, tanfovy: float) -> tuple:
    """The per-view constants of the EWA Jacobian, (focal_x, focal_y,
    1.3 tanfovx, 1.3 tanfovy), as float64 Python numbers.  Stored in a
    tensor of the state's dtype they give the same products bit for bit:
    a float32 kernel rounds a Python scalar operand to float32 too."""
    return (width / (2.0 * tanfovx), height / (2.0 * tanfovy), FRUSTUM_CLAMP * tanfovx,
            FRUSTUM_CLAMP * tanfovy)


def _jacobian_rows(mean3d: torch.Tensor, cam: Camera):
    """The two image rows of J @ W as per-component [P] tensors, with the
    1.3 * tanfov frustum clamp inside J."""
    Wv = cam.world_to_cam[:3, :3]
    tview = mean3d @ Wv.T + cam.world_to_cam[:3, 3]
    tz = tview[:, 2]
    fx, fy, limx, limy = (intrinsics(cam.height, cam.width, cam.tanfovx, cam.tanfovy)
                          if cam.intrinsics is None else cam.intrinsics.unbind())
    tx = clip(tview[:, 0] / tz, -limx, limx) * tz
    ty = clip(tview[:, 1] / tz, -limy, limy) * tz
    inv_z = 1.0 / tz
    inv_z2 = inv_z * inv_z
    j00 = fx * inv_z
    j02 = -fx * tx * inv_z2
    j11 = fy * inv_z
    j12 = -fy * ty * inv_z2
    T0 = tuple(j00 * Wv[0, i] + j02 * Wv[2, i] for i in range(3))
    T1 = tuple(j11 * Wv[1, i] + j12 * Wv[2, i] for i in range(3))
    return T0, T1


def build_cov3d(scale: torch.Tensor, quat: torch.Tensor, modifier: float = 1.0) -> torch.Tensor:
    """[P,3] scales, [P,4] unit quats -> [P,3,3] world covariance R S^2 R^T."""
    R = quat_to_rotmat(quat)
    s2 = (modifier * scale) ** 2
    return torch.einsum("pij,pj,pkj->pik", R, s2, R)


def ewa_cov2d(mean3d: torch.Tensor, cov3d: torch.Tensor, cam: Camera) -> torch.Tensor:
    """World covariance [P,3,3] projected to the 2D pixel covariance [P,3]
    = (cxx, cxy, cyy) = T Sigma T^T, without the low-pass dilation.  The
    general form for an explicit cov3d; ``preprocess`` uses
    ``ewa_cov2d_direct``, which never builds the 3x3s."""
    (t00, t01, t02), (t10, t11, t12) = _jacobian_rows(mean3d, cam)
    T0 = torch.stack([t00, t01, t02], dim=-1)
    T1 = torch.stack([t10, t11, t12], dim=-1)
    S0 = torch.einsum("pi,pij->pj", T0, cov3d)
    S1 = torch.einsum("pi,pij->pj", T1, cov3d)
    cxx = torch.einsum("pj,pj->p", S0, T0)
    cxy = torch.einsum("pj,pj->p", S0, T1)
    cyy = torch.einsum("pj,pj->p", S1, T1)
    return torch.stack([cxx, cxy, cyy], dim=-1)


def clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """min(max(x, lo), hi) with JAX's gradient rule at the bounds (half the
    gradient passes at a tie; ``torch.clamp`` passes all of it).  The bounds
    are numbers or 0-dim tensors of x's dtype on x's device."""
    lo_t = lo if torch.is_tensor(lo) else torch.full((), lo, dtype=x.dtype, device=x.device)
    hi_t = hi if torch.is_tensor(hi) else torch.full((), hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo_t), hi_t)


def ewa_cov2d_direct(
    mean3d: torch.Tensor,
    scale: torch.Tensor,
    quat: torch.Tensor,
    cam: Camera,
    modifier: float = 1.0,
) -> torch.Tensor:
    """EWA 2D covariance [P,3] = (cxx, cxy, cyy) straight from (scale, quat):
    with M = R diag(s), cov2d = (T M)(T M)^T needs only the rows T0 M, T1 M."""
    w, x, y, z = quat[:, 0], quat[:, 1], quat[:, 2], quat[:, 3]
    r00 = 1.0 - 2.0 * (y * y + z * z)
    r01 = 2.0 * (x * y - w * z)
    r02 = 2.0 * (x * z + w * y)
    r10 = 2.0 * (x * y + w * z)
    r11 = 1.0 - 2.0 * (x * x + z * z)
    r12 = 2.0 * (y * z - w * x)
    r20 = 2.0 * (x * z - w * y)
    r21 = 2.0 * (y * z + w * x)
    r22 = 1.0 - 2.0 * (x * x + y * y)
    s0 = modifier * scale[:, 0]
    s1 = modifier * scale[:, 1]
    s2 = modifier * scale[:, 2]
    (t00, t01, t02), (t10, t11, t12) = _jacobian_rows(mean3d, cam)
    u0 = (t00 * r00 + t01 * r10 + t02 * r20) * s0
    u1 = (t00 * r01 + t01 * r11 + t02 * r21) * s1
    u2 = (t00 * r02 + t01 * r12 + t02 * r22) * s2
    v0 = (t10 * r00 + t11 * r10 + t12 * r20) * s0
    v1 = (t10 * r01 + t11 * r11 + t12 * r21) * s1
    v2 = (t10 * r02 + t11 * r12 + t12 * r22) * s2
    cxx = u0 * u0 + u1 * u1 + u2 * u2
    cxy = u0 * v0 + u1 * v1 + u2 * v2
    cyy = v0 * v0 + v1 * v1 + v2 * v2
    return torch.stack([cxx, cxy, cyy], dim=-1)


def ndc2pix(v: torch.Tensor, size: int) -> torch.Tensor:
    return ((v + 1.0) * size - 1.0) * 0.5


def preprocess(
    mean3d: torch.Tensor,
    scale: torch.Tensor,
    quat: torch.Tensor,
    opacity: torch.Tensor,
    cam: Camera,
    scale_modifier: float = 1.0,
    antialiasing: bool = False,
    alive: torch.Tensor | None = None,
) -> Preprocessed:
    """mean3d [P,3], scale [P,3], quat [P,4], opacity [P]; `alive` masks
    out capacity padding."""
    hom = mean3d @ cam.full_proj[:3, :3].T + cam.full_proj[:3, 3]
    w = mean3d @ cam.full_proj[3, :3] + cam.full_proj[3, 3]
    inv_w = 1.0 / (w + 1e-7)
    ndc_xy = hom[:, :2] * inv_w[:, None]
    z_view = mean3d @ cam.world_to_cam[2, :3] + cam.world_to_cam[2, 3]

    cov = ewa_cov2d_direct(mean3d, scale, quat, cam, scale_modifier)
    det_raw = cov[:, 0] * cov[:, 2] - cov[:, 1] ** 2
    cxx = cov[:, 0] + H_VAR
    cyy = cov[:, 2] + H_VAR
    cxy = cov[:, 1]
    det = cxx * cyy - cxy * cxy
    if antialiasing:
        compensation = torch.sqrt(torch.clamp(det_raw / det, min=2.5e-5))
    else:
        compensation = torch.ones_like(det)

    det_inv = 1.0 / det
    conic = torch.stack([cyy * det_inv, -cxy * det_inv, cxx * det_inv], dim=-1)

    mid = 0.5 * (cxx + cyy)
    lam_max = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius_f = torch.ceil(3.0 * torch.sqrt(lam_max))
    mean2d = torch.stack(
        [ndc2pix(ndc_xy[:, 0], cam.width), ndc2pix(ndc_xy[:, 1], cam.height)], dim=-1
    )
    opa_eff = opacity * compensation
    # per-axis reach of the exact alpha >= 1/255 support ellipse
    reach = torch.sqrt(
        2.0 * torch.clamp(torch.log(torch.clamp(opa_eff, min=1e-12) * 255.0), min=0.0)
    )
    ext = reach[:, None] * torch.sqrt(
        torch.clamp(torch.stack([cxx, cyy], dim=-1), min=0.0)
    )

    valid = (z_view > NEAR_CULL_Z) & (det > 0.0) & (radius_f > 0.0)
    if alive is not None:
        valid = valid & alive
    radius = torch.where(valid, radius_f, torch.zeros_like(radius_f)).to(torch.int32)
    return Preprocessed(
        mean2d=mean2d,
        conic=conic,
        depth=z_view,
        opacity=opa_eff,
        radius=radius,
        extent=ext,
        valid=valid,
    )
