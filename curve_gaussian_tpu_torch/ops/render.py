"""Render pass: Gaussian attributes -> single-channel edge image, plus the
inverse-depth, alpha and world-space direction maps, as
``curve_gaussian_tpu/ops/render.py``:

    preprocess (autograd) -> bin_gaussians (integer, no gradient)
        -> stack_fields -> tile blend (kernels) -> exposure -> clip
        -> direction map back to world space

``mean2d_offset`` is a zeros [P, 2] input added to the projected means; its
gradient is the screen-space statistic the densification reads.  The
allmap payload is the view-space main axis, flipped toward the camera, and
a one, whose channel renders the alpha map.

Routing of the tile blend (``backend="pallas"``, the name the JAX package's
configurations carry):

- the training channel set (``render_geo=False``, ``compute_invdepth=False``,
  ones colour) takes ``blend_train`` (K1 + K2) when ``CGT_BLEND_FLAVOR`` is
  unset, empty or ``"train"``; ``"table"`` takes ``tile_blend`` with K3 + K4,
  ``"indirect"`` K3 + K5;
- every other channel set takes ``tile_blend`` with K3 + K4, whatever the
  flavor.

An unknown flavor raises; the flavor is read only on this backend, as in
the JAX package.  Where this differs from the JAX package: its
flavors select TPU memory layouts (a payload table or in-kernel indirection)
and it chooses between them by TPU rules, which are not copied here: the
indirect kernels need K % 1024 == 0 (other capacities fall back to the
table), the automatic choice takes the indirect kernels for P <= 16384,
and the training route needs K <= 1024.  Here every kernel reads the
fields through ``gather_idx``, any K works, and the flavor names only the
backward kernel.

``backend="reference"`` renders through ``rasterize_reference`` with the
binning's tile membership, so both backends see the same candidates.
"""
from __future__ import annotations

import os
from typing import Optional

import torch

from .binning import bin_gaussians
from .camera import Camera
from .projection import clip, preprocess
from .quaternion import quat_to_rotmat
from .rasterize_cuda import blend_train, stack_fields
from .rasterize_ref import membership, rasterize_reference
from .tile_blend_cuda import tile_blend

_FLAVORS = ("", "table", "indirect", "train")


def _flavor() -> str:
    """The ``CGT_BLEND_FLAVOR`` override, read at each call; raises on a
    value outside ``_FLAVORS`` rather than falling back quietly."""
    f = os.environ.get("CGT_BLEND_FLAVOR", "")
    if f not in _FLAVORS:
        raise ValueError(f"CGT_BLEND_FLAVOR={f!r} is not one of {_FLAVORS}")
    return f


def main_axis_allmap(xyz: torch.Tensor, quat: torch.Tensor, cam: Camera) -> torch.Tensor:
    """[P, 4]: the view-space main axis, flipped toward the camera, and ones."""
    dir_global = quat_to_rotmat(quat)[..., :, 0]
    to_cam = cam.cam_center[None, :] - xyz
    flip = torch.sum(dir_global * to_cam, dim=-1, keepdim=True) < 0.0
    dir_global = torch.where(flip, -dir_global, dir_global)
    local = dir_global @ cam.world_to_cam[:3, :3].T
    return torch.cat([local, torch.ones_like(local[:, :1])], dim=-1)


def render(
    xyz: torch.Tensor,  # [P,3]
    scale: torch.Tensor,  # [P,3]
    quat: torch.Tensor,  # [P,4]
    opacity: torch.Tensor,  # [P]
    cam: Camera,
    bg=0.0,
    color: Optional[torch.Tensor] = None,  # [P]
    alive: Optional[torch.Tensor] = None,  # [P] bool, capacity padding mask
    mean2d_offset: Optional[torch.Tensor] = None,  # [P,2]
    scale_modifier: float = 1.0,
    antialiasing: bool = False,
    render_geo: bool = True,
    compute_invdepth: bool = True,
    capacity: int = 1024,
    big_capacity: int = 1024,
    backend: str = "pallas",
    exposure: Optional[torch.Tensor] = None,  # [2] (scale, offset)
):
    """Returns dict(render [H,W], invdepth [H,W], final_T [H,W], alpha [H,W],
    dir [3,H,W], radii [P] int32, visibility [P] bool, overflow, tile_peak,
    big_peak, big_overflow)."""
    if backend not in ("pallas", "reference"):
        raise ValueError(f"backend={backend!r} is not 'pallas' or 'reference'")
    H, W = cam.height, cam.width
    pre = preprocess(
        xyz, scale, quat, opacity, cam,
        scale_modifier=scale_modifier, antialiasing=antialiasing, alive=alive,
    )
    if mean2d_offset is not None:
        pre = pre._replace(mean2d=pre.mean2d + mean2d_offset)
    dt, dev = pre.mean2d.dtype, pre.mean2d.device
    P = xyz.shape[0]
    color_ones = color is None
    if torch.is_tensor(bg):
        bg_t = bg.to(device=dev, dtype=dt).reshape(1)
    else:  # filled on the device: a host copy would synchronise the stream
        bg_t = torch.full((1,), float(bg), dtype=dt, device=dev)
    binning = bin_gaussians(pre, H, W, capacity=capacity, big_capacity=big_capacity)
    train_cfg = not render_geo and not compute_invdepth and color_ones
    flavor = _flavor() if backend == "pallas" else ""  # the oracle has no flavors

    if backend == "pallas" and train_cfg and flavor in ("", "train"):
        img, finT = blend_train(stack_fields(pre), binning.gather_idx, binning.counts, bg_t, H, W)
        invd = img.new_zeros((H, W))
        am = img.new_zeros((4, H, W))
    else:
        if color_ones:
            color = torch.ones_like(opacity)
        allmap = (main_axis_allmap(xyz, quat, cam) if render_geo
                  else torch.zeros((P, 4), dtype=dt, device=dev))
        if backend == "reference":
            out = rasterize_reference(
                pre, color, allmap, bg_t[0], H, W, render_geo=render_geo,
                member=membership(binning, P),
            )
            img, invd, finT, am = out["render"], out["invdepth"], out["final_T"], out["allmap"]
        else:
            fields = stack_fields(pre, color, allmap, geo=render_geo, invd=compute_invdepth,
                                  ones=color_ones)
            img, invd, finT, am = tile_blend(
                fields, binning.gather_idx, binning.counts, bg_t, H, W, render_geo,
                compute_invdepth, color_ones, moment_bwd=train_cfg and flavor == "indirect",
            )

    if exposure is not None:
        img = img * exposure[0] + exposure[1]
    img = clip(img, 0.0, 1.0)  # JAX's clip: half the gradient passes at a bound
    # the rendered direction from view back to world space: Wv^T am[:3]
    rend_dir = torch.einsum("ij,ihw->jhw", cam.world_to_cam[:3, :3], am[:3])
    return {
        "render": img,
        "invdepth": invd,
        "final_T": finT,
        "alpha": am[3],
        "dir": rend_dir,
        "radii": pre.radius,
        "visibility": pre.radius > 0,
        "overflow": binning.overflow,
        "tile_peak": binning.peak,
        "big_peak": binning.big_count,
        "big_overflow": binning.big_overflow,
    }
