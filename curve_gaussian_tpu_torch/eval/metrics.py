"""Curve-reconstruction metrics, as ``curve_gaussian_tpu/eval/metrics.py``:
Chamfer distance with accuracy and completeness, precision / recall /
F-score / IOU at 5, 10 and 20 mm, tangent-direction similarity, and the
256^3 voxel-average downsample applied to predictions before matching.

Nearest neighbours come from ``scipy.spatial.cKDTree`` on float32 points,
the JAX package's fallback when its C++ library is absent; that library is
not ported (it computes the same distances in float32, ~1e-7 apart).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
from scipy.spatial import cKDTree

DEFAULT_THRESHOLDS = (0.005, 0.01, 0.02)


def nn1(base: np.ndarray, query: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Nearest neighbour in `base` of each row of `query`: (dists, idx)."""
    base = np.ascontiguousarray(base, np.float32)
    query = np.ascontiguousarray(query, np.float32)
    return cKDTree(base).query(query, k=1)


def downsample_voxel_average(points: np.ndarray, num_voxels_per_axis: int = 256,
                             min_bound=None, max_bound=None) -> np.ndarray:
    """The mean of the points inside each occupied voxel."""
    if len(points) == 0:
        return points
    mn = np.asarray(min_bound if min_bound is not None else points.min(0), float)
    mx = np.asarray(max_bound if max_bound is not None else points.max(0), float)
    size = (mx - mn) / num_voxels_per_axis
    size = np.where(size <= 0, 1.0, size)
    ids = np.clip(np.floor((points - mn) / size).astype(np.int64), 0, num_voxels_per_axis - 1)
    key = (ids[:, 0] * num_voxels_per_axis + ids[:, 1]) * num_voxels_per_axis + ids[:, 2]
    order = np.argsort(key)
    key_s = key[order]
    groups = np.split(points[order], np.flatnonzero(np.diff(key_s)) + 1)
    return np.stack([g.mean(axis=0) for g in groups]).astype(points.dtype)


def chamfer(pred: np.ndarray, gt: np.ndarray):
    """(chamfer, accuracy, completeness): accuracy is the mean pred -> gt
    distance, completeness the mean gt -> pred distance."""
    if len(pred) == 0 or len(gt) == 0:
        return float("inf"), float("inf"), float("inf")
    acc = float(np.mean(nn1(gt, pred)[0]))
    comp = float(np.mean(nn1(pred, gt)[0]))
    return acc + comp, acc, comp


def precision_recall_iou(pred: np.ndarray, gt: np.ndarray,
                         thresholds=DEFAULT_THRESHOLDS) -> Dict[str, float]:
    out: Dict[str, float] = {}
    if len(pred) == 0 or len(gt) == 0:
        for t in thresholds:
            for k in ("precision", "recall", "fscore", "IOU"):
                out[f"{k}_{t}"] = 0.0
        return out
    d_pred, _ = nn1(gt, pred)
    d_gt, _ = nn1(pred, gt)
    for t in thresholds:
        correct_pred = int(np.sum(d_pred < t))
        correct_gt = int(np.sum(d_gt < t))
        precision = correct_pred / len(d_pred)
        recall = correct_gt / len(d_gt)
        f = 2 * precision * recall / (precision + recall) if precision + recall else 0.0
        union = len(d_pred) + len(d_gt) - max(correct_pred, correct_gt)
        out[f"precision_{t}"] = precision
        out[f"recall_{t}"] = recall
        out[f"fscore_{t}"] = f
        out[f"IOU_{t}"] = min(correct_pred, correct_gt) / union if union else 0.0
    return out


def direction_similarity(pred_points: np.ndarray, pred_dirs: np.ndarray,
                         gt_points: np.ndarray, gt_dirs: np.ndarray) -> float:
    """Mean |cos| between each predicted tangent and its nearest GT
    point's tangent."""
    if len(pred_points) == 0 or len(gt_points) == 0:
        return 0.0
    _, idx = nn1(gt_points, pred_points)
    g = gt_dirs[idx]
    num = np.abs(np.sum(pred_dirs * g, axis=1))
    den = np.linalg.norm(pred_dirs, axis=1) * np.linalg.norm(g, axis=1) + 1e-12
    return float(np.mean(num / den))


def evaluate_edges(
    pred_points: np.ndarray,
    gt_points: np.ndarray,
    pred_dirs: Optional[np.ndarray] = None,
    gt_dirs: Optional[np.ndarray] = None,
    thresholds=DEFAULT_THRESHOLDS,
    voxel_downsample: bool = True,
) -> Dict[str, float]:
    """The whole metric sweep on a unit-cube scene."""
    pred_ds = (
        downsample_voxel_average(pred_points, 256, min_bound=(0, 0, 0), max_bound=(1, 1, 1))
        if voxel_downsample and len(pred_points)
        else pred_points
    )
    ch, acc, comp = chamfer(pred_ds, gt_points)
    out = {"chamfer": ch, "accuracy": acc, "completeness": comp}
    out.update(precision_recall_iou(pred_ds, gt_points, thresholds))
    if pred_dirs is not None and gt_dirs is not None and len(pred_points):
        out["direction_sim"] = direction_similarity(pred_points, pred_dirs, gt_points, gt_dirs)
    return out
