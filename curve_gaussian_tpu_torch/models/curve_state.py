"""CurveState: the model as fixed-capacity tensors.

Learnable leaves (the ``trainable`` dict):

  curve_points [C,4,3]   Bézier control points / line endpoints (rows 0,3)
  opacity_raw  [C]       inverse-sigmoid of per-curve opacity
  width_raw    [C]       log of the perpendicular Gaussian width
  mask_raw     [C,M]     per-Gaussian pruning-mask logits
  features_dc  [C,M,1]   SH degree-0 colour (the renderer forces ones)
  exposure     [V,2]     per-view scalar affine (scale, offset)

Topology leaves: is_bezier [C] bool, alive [C] bool.  The curve count
lives in a fixed capacity C with an ``alive`` mask, as in
``curve_gaussian_tpu/models/curve_state.py``; topology surgery
(``models/surgery.py``) repacks the state at a power-of-two capacity.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

import numpy as np
import torch

from .. import resolve_device
from ..ops import bezier
from ..ops.knn import mean_knn_sq_dist

INIT_OPACITY = 0.6
INIT_WIDTH = 5e-3
INIT_HALF_LEN = 0.5
MIN_CAPACITY = 256

TRAINABLE_FIELDS = (
    "curve_points",
    "opacity_raw",
    "width_raw",
    "mask_raw",
    "features_dc",
    "exposure",
)


@dataclasses.dataclass
class CurveState:
    curve_points: torch.Tensor
    opacity_raw: torch.Tensor
    width_raw: torch.Tensor
    mask_raw: torch.Tensor
    features_dc: torch.Tensor
    exposure: torch.Tensor
    is_bezier: torch.Tensor
    alive: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.curve_points.shape[0]

    @property
    def n_gaussians(self) -> int:
        return self.mask_raw.shape[1]


def trainable(state: CurveState) -> Dict[str, torch.Tensor]:
    return {k: getattr(state, k) for k in TRAINABLE_FIELDS}


def with_trainable(state: CurveState, t: Dict[str, torch.Tensor]) -> CurveState:
    """`state` with its trainable leaves replaced by those in `t`."""
    return dataclasses.replace(state, **t)


def curve_state_of(ts) -> CurveState:
    """The CurveState of a training state (its params and topology masks)."""
    return CurveState(**ts.params, is_bezier=ts.is_bezier, alive=ts.alive)


def inverse_sigmoid(x):
    return torch.log(x / (1.0 - x))


def inverse_sigmoid_np(x):
    return np.log(x / (1.0 - x))


def round_capacity(n: int) -> int:
    c = MIN_CAPACITY
    while c < n:
        c *= 2
    return c


def init_state(
    points: np.ndarray,
    n_views: int,
    n_gaussians: int = 12,
    capacity: int | None = None,
    dtype=torch.float32,
    device="cuda",
) -> CurveState:
    """One Bézier per seed point, half-length 0.5 * sqrt(mean 3-NN squared
    distance), padded to the capacity."""
    dev = resolve_device(device)
    pts = torch.as_tensor(np.asarray(points), device=dev).to(dtype)
    n = pts.shape[0]
    d2 = torch.clamp(mean_knn_sq_dist(pts, k=3), min=1e-7)
    bound = INIT_HALF_LEN * torch.sqrt(d2)
    cp = bezier.initialize_bezier_curves(pts, bound)
    cap = capacity or round_capacity(n)
    m = n_gaussians

    def padc(x, fill=0):
        out = torch.full((cap,) + tuple(x.shape[1:]), fill, dtype=x.dtype, device=dev)
        out[:n] = x
        return out

    def full(shape, v):
        return torch.full(shape, v, dtype=dtype, device=dev)

    return CurveState(
        curve_points=padc(cp),
        opacity_raw=padc(full((n,), math.log(INIT_OPACITY / (1.0 - INIT_OPACITY)))),
        width_raw=padc(full((n,), float(np.log(INIT_WIDTH)))),
        mask_raw=padc(full((n, m), 1.0)),
        features_dc=padc(full((n, m, 1), 0.0)),
        exposure=torch.tensor([1.0, 0.0], dtype=dtype, device=dev).repeat(max(n_views, 1), 1),
        is_bezier=padc(torch.ones((n,), dtype=torch.bool, device=dev), fill=False),
        alive=padc(torch.ones((n,), dtype=torch.bool, device=dev), fill=False),
    )


def curve_opacity(state: CurveState) -> torch.Tensor:
    return torch.sigmoid(state.opacity_raw)


def curve_width(state: CurveState) -> torch.Tensor:
    return torch.exp(state.width_raw)


def mask_sigmoid(state: CurveState) -> torch.Tensor:
    return torch.sigmoid(state.mask_raw)


def gaussians(state: CurveState, use_mask: bool = False, mask_threshold: float = 0.01):
    """Flattened per-Gaussian attributes: xyz [C*M,3], scale [C*M,3],
    quat [C*M,4], opacity [C*M], alive [C*M] bool, tangent [C*M,3].  With
    use_mask the straight-through hard mask gates scale and opacity."""
    m = state.n_gaussians
    g = bezier.curve_gaussians(state.curve_points, curve_width(state), state.is_bezier, m)
    opa = curve_opacity(state)[:, None].expand(state.capacity, m)
    scale = g["scale"]
    if use_mask:
        s = torch.sigmoid(state.mask_raw)
        hard = (s > mask_threshold).to(s.dtype)
        st = s + (hard - s).detach()
        scale = scale * st[..., None]
        opa = opa * st
    alive_g = state.alive[:, None].expand(state.capacity, m)
    return {
        "xyz": g["xyz"].reshape(-1, 3),
        "scale": scale.reshape(-1, 3),
        "quat": g["quat"].reshape(-1, 4),
        "opacity": opa.reshape(-1),
        "alive": alive_g.reshape(-1),
        "tangent": g["tangent"].reshape(-1, 3),
    }
