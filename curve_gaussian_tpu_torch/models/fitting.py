"""Host-side curve and line fitting (numpy and scipy), as
``curve_gaussian_tpu/models/fitting.py``, whose numbers it reproduces:

  * fit_line_pca      PCA line fit returning the clamped segment and frame
  * fit_bezier_lsq    cubic Bézier by closed-form linear least squares at
                      uniform t
  * ransac_line       2-point RANSAC line consensus from a seeded numpy
                      generator
  * pairwise segment distance and direction-cosine matrices
  * merge_endpoints   connected-component endpoint snapping
"""
from __future__ import annotations

from typing import Optional

import numpy as np
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import connected_components

BEZIER_W = np.array(
    [[-1, 3, -3, 1], [3, -6, 3, 0], [-3, 3, 0, 0], [1, 0, 0, 0]], dtype=np.float64
)


def bezier_design_matrix(t: np.ndarray) -> np.ndarray:
    """[n] -> [n, 4] basis: rows (t^3, t^2, t, 1) @ W."""
    T = np.stack([t**3, t**2, t, np.ones_like(t)], axis=1)
    return T @ BEZIER_W


def sample_bezier(cp: np.ndarray, t: np.ndarray) -> np.ndarray:
    """cp [4,3] (or [N,4,3]), t [n] -> points [n,3] (or [N,n,3])."""
    return bezier_design_matrix(t) @ cp


def fit_line_pca(points: np.ndarray):
    """PCA line fit: (start, end, direction, mean_point, t_min, t_max)."""
    mean = points.mean(axis=0)
    centered = points - mean
    cov = centered.T @ centered / len(points)
    w, v = np.linalg.eigh(cov)
    direction = v[:, np.argmax(w)]
    direction = direction / (np.linalg.norm(direction) + 1e-12)
    proj = centered @ direction
    t_min, t_max = proj.min(), proj.max()
    return (
        mean + t_min * direction,
        mean + t_max * direction,
        direction,
        mean,
        t_min,
        t_max,
    )


def fit_bezier_lsq(points: np.ndarray, error_threshold: float = 0.02) -> Optional[np.ndarray]:
    """Least-squares cubic Bézier through ordered points (float32 [4, 3]);
    None if the RMSE exceeds the threshold."""
    n = len(points)
    if n < 4:
        return None
    t = np.linspace(0.0, 1.0, n)
    A = bezier_design_matrix(t)  # [n, 4]
    cp, *_ = np.linalg.lstsq(A, points, rcond=None)
    resid = points - A @ cp
    rmse = float(np.sqrt(np.mean(np.sum(resid**2, axis=1))))
    if rmse > error_threshold:
        return None
    return cp.astype(np.float32)


def ransac_line(
    points: np.ndarray,
    residual_threshold: float,
    max_trials: int = 200,
    seed: int = 0,
) -> np.ndarray:
    """Inlier mask of the best 2-point consensus line; the trials come from
    ``np.random.default_rng(seed)``."""
    n = len(points)
    if n < 2:
        return np.ones(n, bool)
    rng = np.random.default_rng(seed)
    i = rng.integers(0, n, size=max_trials)
    j = rng.integers(0, n, size=max_trials)
    j = np.where(i == j, (j + 1) % n, j)
    p0 = points[i]  # [T,3]
    d = points[j] - p0
    d /= np.linalg.norm(d, axis=1, keepdims=True) + 1e-12
    # distance of every point to each trial line: || (x-p0) - ((x-p0).d) d ||
    rel = points[None, :, :] - p0[:, None, :]  # [T,n,3]
    along = np.einsum("tnc,tc->tn", rel, d)
    perp = rel - along[..., None] * d[:, None, :]
    inliers = np.linalg.norm(perp, axis=-1) < residual_threshold
    return inliers[np.argmax(inliers.sum(axis=1))]


def segment_point_distances(segments: np.ndarray, points: np.ndarray) -> np.ndarray:
    """segments [N,6], points [M,3] -> [N,M] min distances."""
    p1 = segments[:, :3][:, None, :]
    p2 = segments[:, 3:][:, None, :]
    delta = p2 - p1
    denom = np.sum(delta * delta, axis=-1)
    denom = np.where(denom < 1e-18, 1.0, denom)
    u = np.clip(np.sum((points[None] - p1) * delta, axis=-1) / denom, 0.0, 1.0)
    closest = p1 + u[..., None] * delta
    return np.linalg.norm(closest - points[None], axis=-1)


def pairwise_segment_distances(segments: np.ndarray) -> np.ndarray:
    """Symmetric [N,N] of min(seg_i to the endpoints of seg_j)."""
    d = segment_point_distances(segments, segments.reshape(-1, 3))  # [N, 2N]
    n = len(segments)
    d = d.reshape(n, n, 2).min(axis=-1)
    out = np.triu(d, 1)
    return out + out.T


def pairwise_cosine_similarity(segments: np.ndarray) -> np.ndarray:
    dirs = segments[:, 3:] - segments[:, :3]
    dirs = dirs / (np.linalg.norm(dirs, axis=1, keepdims=True) + 1e-12)
    return dirs @ dirs.T


def merge_endpoints(line_segments: np.ndarray, bezier_curves: np.ndarray,
                    distance_threshold: float = 0.015):
    """Snap all endpoints within the threshold to their component mean.
    line_segments [L,6], bezier_curves [B,12]."""
    n_lines = len(line_segments)
    n_curves = len(bezier_curves)
    if n_lines == 0 and n_curves == 0:
        return line_segments, bezier_curves
    parts = []
    if n_lines:
        parts.append(np.asarray(line_segments).reshape(-1, 3))
    if n_curves:
        parts.append(np.asarray(bezier_curves)[:, [0, 1, 2, -3, -2, -1]].reshape(-1, 3))
    pts = np.concatenate(parts, axis=0)
    d = np.linalg.norm(pts[:, None] - pts[None, :], axis=-1)
    ncomp, labels = connected_components(csr_matrix(d <= distance_threshold))
    for c in range(ncomp):
        idx = np.where(labels == c)[0]
        if len(idx) > 1:
            pts[idx] = pts[idx].mean(axis=0)
    lines_out = line_segments
    curves_out = bezier_curves
    if n_lines:
        lines_out = pts[: n_lines * 2].reshape(-1, 6)
    if n_curves:
        ce = pts[n_lines * 2:].reshape(-1, 6)
        curves_out = np.array(bezier_curves, copy=True)
        curves_out[:, :3] = ce[:, :3]
        curves_out[:, 9:] = ce[:, 3:]
    return lines_out, curves_out
