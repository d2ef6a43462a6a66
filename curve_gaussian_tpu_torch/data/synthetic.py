"""Synthetic scene pieces, as ``curve_gaussian_tpu/data/synthetic.py``: the
ring of cameras and the reference's grid seed cloud.  ``make_scene`` renders
ground truth with the full-channel render and belongs to a later slice."""
from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

from ..ops.camera import Camera, look_at_camera


def ring_cameras(
    n_views: int,
    height: int,
    width: int,
    radius: float = 2.2,
    center=(0.5, 0.5, 0.5),
    fovx_deg: float = 45.0,
    elevations=(-0.35, 0.0, 0.45),
    dtype=torch.float32,
    device="cuda",
) -> List[Camera]:
    """n_views cameras on a ring around `center`, looking at it."""
    cams = []
    center = np.asarray(center, np.float64)
    for i in range(n_views):
        theta = 2 * math.pi * i / n_views
        elev = elevations[i % len(elevations)]
        eye = center + radius * np.asarray(
            [math.cos(theta) * math.cos(elev), math.sin(elev), math.sin(theta) * math.cos(elev)]
        )
        cams.append(
            look_at_camera(
                eye=eye, target=center, fovx=math.radians(fovx_deg),
                height=height, width=width, dtype=dtype, device=device,
            )
        )
    return cams


def grid_seed_points(n_per_axis: int = 15) -> np.ndarray:
    """The reference's init cloud: an n^3 grid over [-0.05, 1.05]^3."""
    x = np.linspace(-0.05, 1.05, n_per_axis)
    xx, yy, zz = np.meshgrid(x, x, x)
    return np.vstack([xx.ravel(), yy.ravel(), zz.ravel()]).T.astype(np.float32)
