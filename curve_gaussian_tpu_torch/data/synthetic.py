"""Synthetic curve scenes, as ``curve_gaussian_tpu/data/synthetic.py``:
random smooth Béziers and line segments in the unit cube, rendered from a
ring of cameras with the full-channel render into ground-truth edge maps,
and the reference's grid seed cloud.

The random numbers come from one numpy ``Generator`` in the JAX package's
order (the curves first, then each view's noise in view order), so one seed
gives both packages the same curves and the same noise.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np
import torch

from .. import resolve_device
from ..ops import bezier
from ..ops.camera import Camera, look_at_camera
from ..ops.render import render


@dataclasses.dataclass
class SyntheticScene:
    curves: np.ndarray  # [N, 4, 3] ground-truth control points (unit cube)
    is_bezier: np.ndarray  # [N] bool
    cameras: List[Camera]
    edge_maps: List[torch.Tensor]  # [H, W] float32 in [0, 1], on the scene's device


def random_curves(rng: np.random.Generator, n_curves: int, n_lines: int = 0):
    """Smooth random cubic Béziers and straight segments in [0,1]^3:
    (control points [N, 4, 3] float32, is_bezier [N] bool)."""
    n = n_curves + n_lines
    p0 = rng.uniform(0.15, 0.85, size=(n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    length = rng.uniform(0.2, 0.45, size=(n, 1))
    p3 = np.clip(p0 + d * length, 0.02, 0.98)
    # interior control points near the chord, bent sideways
    bend1 = rng.normal(0, 0.06, size=(n, 3))
    bend2 = rng.normal(0, 0.06, size=(n, 3))
    p1 = p0 + (p3 - p0) / 3 + bend1
    p2 = p0 + 2 * (p3 - p0) / 3 + bend2
    cp = np.stack([p0, p1, p2, p3], axis=1).astype(np.float32)
    is_bez = np.ones(n, bool)
    if n_lines:
        is_bez[n_curves:] = False
        cp[n_curves:, 1] = cp[n_curves:, 0]
        cp[n_curves:, 2] = cp[n_curves:, 3]
    return cp, is_bez


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


def make_scene(
    seed: int = 0,
    n_curves: int = 6,
    n_lines: int = 2,
    n_views: int = 12,
    height: int = 200,
    width: int = 200,
    gt_width: float = 0.004,
    gt_opacity: float = 0.95,
    samples_per_curve: int = 48,
    backend: str = "pallas",
    capacity: int = 512,
    noise: float = 0.0,
    device="cuda",
) -> SyntheticScene:
    """Random curves rendered from a ring of ``n_views`` cameras by the
    default full-channel render; with ``noise`` > 0 each edge map gets a
    detector-like corruption (multiplicative jitter and sparse speckle),
    drawn in numpy in view order on the host."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    cp, is_bez = random_curves(rng, n_curves, n_lines)
    cams = ring_cameras(n_views, height, width, device=dev)

    g = bezier.curve_gaussians(
        torch.as_tensor(cp, device=dev),  # float32, as random_curves makes it
        torch.full((cp.shape[0],), gt_width, dtype=torch.float32, device=dev),
        torch.as_tensor(is_bez, device=dev),
        samples_per_curve,
    )
    xyz = g["xyz"].reshape(-1, 3)
    scale = g["scale"].reshape(-1, 3)
    quat = g["quat"].reshape(-1, 4)
    opa = torch.full((xyz.shape[0],), gt_opacity, dtype=torch.float32, device=dev)

    edge_maps = []
    with torch.no_grad():
        for cam in cams:
            img = render(xyz, scale, quat, opa, cam, bg=0.0, capacity=capacity,
                         backend=backend)["render"]
            if noise > 0:
                x = img.cpu().numpy()
                x = x * rng.uniform(1 - noise, 1 + noise, x.shape)
                x = x + noise * 0.3 * (rng.uniform(size=x.shape) < 0.02)
                img = torch.as_tensor(np.clip(x, 0.0, 1.0).astype(np.float32), device=dev)
            edge_maps.append(img)
    return SyntheticScene(curves=cp, is_bezier=is_bez, cameras=cams, edge_maps=edge_maps)


def grid_seed_points(n_per_axis: int = 15) -> np.ndarray:
    """The reference's init cloud: an n^3 grid over [-0.05, 1.05]^3."""
    x = np.linspace(-0.05, 1.05, n_per_axis)
    xx, yy, zz = np.meshgrid(x, x, x)
    return np.vstack([xx.ravel(), yy.ravel(), zz.ravel()]).T.astype(np.float32)
