"""Training loss, as ``curve_gaussian_tpu/models/losses.py``: edge-aware
weighted MSE, SSIM, mask sparsity, opacity log penalty, curve smoothness,
width and endpoint connectivity.  Every mean excludes capacity padding."""
from __future__ import annotations

from typing import Dict

import torch

from ..config import OptimizationConfig
from ..ops.bezier import safe_normalize
from ..ops.ssim import ssim
from . import curve_state as cs


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    w = mask.to(x.dtype)
    return torch.sum(x * w) / torch.clamp(torch.sum(w), min=1.0)


def edge_aware_loss(image: torch.Tensor, gt: torch.Tensor, threshold: float = 0.1):
    """Class-balanced weighted MSE: edge pixels (gt > threshold) weigh
    5 (Nneg + 1) / N, background (Npos + 1) / N."""
    pos = gt > threshold
    num_pos = pos.sum().to(image.dtype)
    num_neg = (~pos).sum().to(image.dtype)
    n = num_pos + num_neg
    w_pos = 5.0 * (num_neg + 1.0) / n
    w_neg = (num_pos + 1.0) / n
    mask = torch.where(pos, w_pos, w_neg)
    return torch.mean((image - gt) ** 2 * mask)


def l1_loss(a, b):
    return torch.abs(a - b).mean()


def psnr(a, b):
    mse = torch.mean((a - b) ** 2)
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse + 1e-12))


def curve_smoothness(tangent: torch.Tensor, alive: torch.Tensor, n_gaussians: int):
    """mean(1 - |cos|) of consecutive Gaussian main axes of live curves."""
    t = safe_normalize(tangent.reshape(-1, n_gaussians, 3))
    cos = torch.abs(torch.sum(t[:, :-1] * t[:, 1:], dim=-1))
    per_pair = 1.0 - cos  # [C, M-1]
    return masked_mean(per_pair, alive[:, None].expand(per_pair.shape))


def connectivity_loss(curve_points: torch.Tensor, alive: torch.Tensor, dist_threshold: float = 0.05):
    """Mean distance between nearby endpoint pairs of different curves.  The
    proximity mask carries no gradient; the distances do.  Builds dense
    [2C, 2C] matrices."""
    pts = torch.cat([curve_points[:, 0], curve_points[:, 3]], dim=0)  # [2C, 3]
    C = curve_points.shape[0]
    same = torch.eye(C, dtype=torch.bool, device=pts.device).repeat(2, 2)
    d = torch.sqrt(torch.sum((pts[:, None, :] - pts[None, :, :]) ** 2, dim=-1) + 1e-12)
    pair_alive = torch.cat([alive, alive])
    ok = pair_alive[:, None] & pair_alive[None, :] & ~same
    sel = ((d < dist_threshold) & ok).detach()
    return masked_mean(d, sel)


def width_loss(state: cs.CurveState, floor: float):
    """Penalise widths above the floor."""
    w = cs.curve_width(state)
    return masked_mean(w - floor, (w >= floor) & state.alive)


def opacity_log_penalty(opacity: torch.Tensor, visible: torch.Tensor):
    """mean(log(1 + o^2 / 0.5)) over the visible Gaussians."""
    return masked_mean(torch.log1p(opacity**2 / 0.5), visible)


def total_loss(
    state: cs.CurveState,
    render_out: Dict[str, torch.Tensor],
    gauss: Dict[str, torch.Tensor],
    gt_image: torch.Tensor,
    opt: OptimizationConfig,
    use_mask: bool,
    conn_on: bool | None = None,
):
    """The full objective; returns (loss, aux dict of every term).

    use_mask gates the mask sparsity term; conn_on gates the connectivity
    term and defaults to use_mask."""
    if conn_on is None:
        conn_on = use_mask
    image = render_out["render"]
    ll1 = edge_aware_loss(image, gt_image)
    ssim_v = ssim(image, gt_image)
    loss = opt.lambda_mse * ((1.0 - opt.lambda_dssim) * ll1 + opt.lambda_dssim * (1.0 - ssim_v))
    aux = {"edge_l1": ll1, "ssim": ssim_v}

    if use_mask and opt.lambda_mask > 0:
        mask_term = masked_mean(
            torch.sigmoid(state.mask_raw), state.alive[:, None].expand(state.mask_raw.shape)
        )
        loss = loss + opt.lambda_mask * mask_term
        aux["mask"] = mask_term

    visible = render_out["visibility"] & gauss["alive"]
    opa_term = opacity_log_penalty(gauss["opacity"], visible)
    loss = loss + opt.opacity_loss_weight * opa_term
    aux["opacity_pen"] = opa_term

    if opt.lambda_curve_smo > 0:
        smo = curve_smoothness(gauss["tangent"], state.alive, state.n_gaussians)
        loss = loss + opt.lambda_curve_smo * smo
        aux["curve_smo"] = smo

    if opt.lambda_width > 0:
        wl = width_loss(state, opt.width_floor)
        loss = loss + opt.lambda_width * wl
        aux["width"] = wl

    if opt.lambda_points_conn > 0 and conn_on:
        conn = connectivity_loss(state.curve_points, state.alive, opt.conn_dist_threshold)
        loss = loss + opt.lambda_points_conn * conn
        aux["curve_conn"] = conn

    aux["total"] = loss
    return loss, aux
