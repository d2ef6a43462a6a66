"""Ellipsoid-mesh view of the Gaussian set, as
``curve_gaussian_tpu/models/ellipsoids.py``: one unit UV sphere instanced
for every Gaussian in one vectorised transform, coloured per curve (lines
black, mask-pruned Gaussians white, sphere radius 1.2), written as one
binary mesh PLY.  Host numpy."""
from __future__ import annotations

import colorsys

import numpy as np
import torch

from ..data.ply import write_ply_mesh
from ..ops.quaternion import quat_to_rotmat


def unit_sphere(resolution: int = 10):
    """UV sphere: `resolution` latitude bands, 2 * resolution longitude
    steps, the two poles first."""
    res = resolution
    lats = np.pi * (np.arange(1, res) / res)  # exclude poles
    lons = 2 * np.pi * (np.arange(2 * res) / (2 * res))
    lat, lon = np.meshgrid(lats, lons, indexing="ij")
    ring = np.stack(
        [np.sin(lat) * np.cos(lon), np.sin(lat) * np.sin(lon), np.cos(lat)], axis=-1
    ).reshape(-1, 3)
    verts = np.concatenate([np.array([[0.0, 0.0, 1.0], [0.0, 0.0, -1.0]]), ring], axis=0)
    L = 2 * res
    faces = []
    for j in range(L):  # pole caps
        faces.append([0, 2 + j, 2 + (j + 1) % L])
        base = 2 + (res - 2) * L
        faces.append([1, base + (j + 1) % L, base + j])
    for i in range(res - 2):  # quad bands
        for j in range(L):
            a = 2 + i * L + j
            b = 2 + i * L + (j + 1) % L
            faces.append([a, b, b + L])
            faces.append([a, b + L, a + L])
    return verts.astype(np.float32), np.asarray(faces, np.int32)


def fancy_colors(n: int, seed: int = 0) -> np.ndarray:
    """Distinct per-curve colours (golden-ratio hues), randomly permuted."""
    hues = (np.arange(n) * 0.61803398875) % 1.0
    cols = np.array([colorsys.hsv_to_rgb(h, 0.75, 0.95) for h in hues], np.float32)
    return cols[np.random.default_rng(seed).permutation(n)]


def save_ellipsoid_mesh(
    path: str,
    xyz: np.ndarray,  # [P, 3]
    quat: np.ndarray,  # [P, 4] (w,x,y,z)
    scale: np.ndarray,  # [P, 3]
    is_bezier: np.ndarray,  # [C]
    mask_sigmoid: np.ndarray,  # [C, M]
    radius: float = 1.2,
    resolution: int = 10,
) -> None:
    """One combined ellipsoid mesh for all Gaussians: per-curve palette,
    straight-line curves black, mask-pruned Gaussians (sigmoid < 0.01)
    white."""
    P = xyz.shape[0]
    C, M = mask_sigmoid.shape
    sv, sf = unit_sphere(resolution)
    R = quat_to_rotmat(torch.as_tensor(np.asarray(quat))).numpy()  # [P, 3, 3]
    # v' = R @ (scale * radius * v) + xyz, batched over P x V
    scaled = sv[None, :, :] * (scale[:, None, :] * radius)  # [P, V, 3]
    verts = np.einsum("pij,pvj->pvi", R, scaled) + xyz[:, None, :]

    per_g = np.repeat(fancy_colors(C), M, axis=0)[:P]  # [P, 3]
    per_g[np.repeat(~np.asarray(is_bezier, bool), M)[:P]] = 0.0
    per_g[(np.asarray(mask_sigmoid).reshape(-1) < 0.01)[:P]] = 1.0
    vcols = np.repeat(per_g, sv.shape[0], axis=0)

    V = sv.shape[0]
    all_faces = (sf[None, :, :] + (np.arange(P) * V)[:, None, None]).reshape(-1, 3)
    write_ply_mesh(path, verts.reshape(-1, 3), all_faces, vcols)
