"""Render pass for the training configuration: Gaussian attributes ->
single-channel edge image, as ``curve_gaussian_tpu/ops/render.py`` renders
with ``render_geo=False``, ``compute_invdepth=False`` and ones colour:

    preprocess (autograd) -> bin_gaussians (integer, no gradient)
        -> stack_fields -> blend_train (kernels K1/K2) -> exposure -> clip

``mean2d_offset`` is a zeros [P, 2] input added to the projected means; its
gradient is the screen-space statistic the densification reads.  The
full-channel render (inverse depth, the allmap's direction and alpha maps,
per-splat colour) and the reference backend belong to the full-channel
slice and raise here; nothing falls back quietly.
"""
from __future__ import annotations

from typing import Optional

import torch

from .binning import bin_gaussians
from .camera import Camera
from .projection import clip, preprocess
from .rasterize_cuda import blend_train, stack_fields

_LATER = "belongs to the full-channel render slice of the port and is not ported yet"


def render(
    xyz: torch.Tensor,  # [P,3]
    scale: torch.Tensor,  # [P,3]
    quat: torch.Tensor,  # [P,4]
    opacity: torch.Tensor,  # [P]
    cam: Camera,
    bg=0.0,
    color: Optional[torch.Tensor] = None,
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
    """Returns dict(render [H,W], final_T [H,W], radii [P] int32,
    visibility [P] bool, overflow, tile_peak, big_peak, big_overflow)."""
    if render_geo:
        raise NotImplementedError(f"render_geo=True {_LATER}")
    if compute_invdepth:
        raise NotImplementedError(f"compute_invdepth=True {_LATER}")
    if color is not None:
        raise NotImplementedError(f"a per-splat colour {_LATER}")
    if backend != "pallas":
        raise NotImplementedError(f"backend={backend!r} {_LATER}")
    H, W = cam.height, cam.width
    pre = preprocess(
        xyz, scale, quat, opacity, cam,
        scale_modifier=scale_modifier, antialiasing=antialiasing, alive=alive,
    )
    if mean2d_offset is not None:
        pre = pre._replace(mean2d=pre.mean2d + mean2d_offset)
    dt, dev = pre.mean2d.dtype, pre.mean2d.device
    if torch.is_tensor(bg):
        bg_t = bg.to(device=dev, dtype=dt).reshape(1)
    else:  # filled on the device: a host copy would synchronise the stream
        bg_t = torch.full((1,), float(bg), dtype=dt, device=dev)
    binning = bin_gaussians(pre, H, W, capacity=capacity, big_capacity=big_capacity)
    img, finT = blend_train(
        stack_fields(pre), binning.gather_idx, binning.counts, bg_t, H, W
    )
    if exposure is not None:
        img = img * exposure[0] + exposure[1]
    img = clip(img, 0.0, 1.0)  # JAX's clip: half the gradient passes at a bound
    return {
        "render": img,
        "final_T": finT,
        "radii": pre.radius,
        "visibility": pre.radius > 0,
        "overflow": binning.overflow,
        "tile_peak": binning.peak,
        "big_peak": binning.big_count,
        "big_overflow": binning.big_overflow,
    }
