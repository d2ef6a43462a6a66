"""Parametric-edge extraction: trained curves -> ``parametric_edges.json``,
as ``curve_gaussian_tpu/eval/extract.py``: endpoint snapping, then
arc-length sampling of curves and lines at 5 mm.  Host numpy."""
from __future__ import annotations

import json
import math
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..data.ply import write_ply
from ..models import fitting
from ..models.surgery import HostCurves

SAMPLE_RESOLUTION = 0.005  # 5 mm in the unit cube


def host_array(a) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array."""
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def curves_to_edge_dict(host: HostCurves, merge_endpoints_flag: bool = True,
                        distance_threshold: float = 0.015) -> Dict:
    """Bézier rows [B,12] and line endpoint rows [L,6], with nearby
    endpoints snapped together when ``merge_endpoints_flag``."""
    cp = host.params["curve_points"]
    bez = cp[host.is_bezier].reshape(-1, 12)
    lines = cp[~host.is_bezier][:, [0, 3], :].reshape(-1, 6)
    if merge_endpoints_flag:
        lines, bez = fitting.merge_endpoints(lines, bez, distance_threshold)
    return {
        "lines_end_pts": np.asarray(lines).tolist() if len(lines) else [],
        "curves_ctl_pts": np.asarray(bez).tolist() if len(bez) else [],
    }


def bezier_length(cp: np.ndarray, num_samples: int = 100) -> float:
    pts = fitting.sample_bezier(cp, np.linspace(0.0, 1.0, num_samples))
    return float(np.linalg.norm(np.diff(pts, axis=0), axis=1).sum())


def sample_edge_dict(edge_dict: Dict, sample_resolution: float = SAMPLE_RESOLUTION,
                     with_directions: bool = False) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Arc-length sampling at `sample_resolution` (length // resolution
    samples at uniform t): (points [N,3], unit directions [N,3] or None)."""
    pts_out, dir_out = [], []
    curves = np.array(edge_dict.get("curves_ctl_pts", [])).reshape(-1, 4, 3)
    for cp in curves:
        n = int(bezier_length(cp) // sample_resolution)
        if n <= 0:
            continue
        t = np.linspace(0.0, 1.0, n)
        pts_out.append(fitting.sample_bezier(cp, t))
        if with_directions:
            u = 1 - t
            d = (
                3 * (u**2)[:, None] * (cp[1] - cp[0])
                + 6 * (u * t)[:, None] * (cp[2] - cp[1])
                + 3 * (t**2)[:, None] * (cp[3] - cp[2])
            )
            dir_out.append(d / (np.linalg.norm(d, axis=1, keepdims=True) + 1e-12))
    lines = np.array(edge_dict.get("lines_end_pts", [])).reshape(-1, 2, 3)
    for seg in lines:
        n = int(np.linalg.norm(seg[1] - seg[0]) // sample_resolution)
        if n <= 0:
            continue
        t = np.linspace(0.0, 1.0, n)
        pts_out.append(seg[0] + t[:, None] * (seg[1] - seg[0]))
        if with_directions:
            d = seg[1] - seg[0]
            dir_out.append(np.tile(d / (np.linalg.norm(d) + 1e-6), (n, 1)))
    if not pts_out:
        empty = np.zeros((0, 3), np.float32)
        return empty, (empty if with_directions else None)
    pts = np.concatenate(pts_out).astype(np.float32)
    dirs = np.concatenate(dir_out).astype(np.float32) if with_directions else None
    return pts, dirs


def filter_visible_edges(
    edge_dict: Dict,
    cameras,
    edge_maps,
    edge_visibility_threshold: float = 0.1,
    frames_ratio: float = 0.05,
    sample_resolution: float = SAMPLE_RESOLUTION,
) -> Dict:
    """Drop edges seen 'on' in too few views: an edge is visible in a view
    when the mean edge-map response at its projected samples exceeds the
    threshold and the max exceeds 0.5; it is kept when visible in at least
    ceil(frames_ratio * views) views.  Cameras and edge maps may live on
    the card; they are read on the host."""
    curves = np.array(edge_dict.get("curves_ctl_pts", [])).reshape(-1, 4, 3)
    lines = np.array(edge_dict.get("lines_end_pts", [])).reshape(-1, 2, 3)
    per_edge_pts = []
    for cp in curves:
        n = max(int(bezier_length(cp) // sample_resolution), 2)
        per_edge_pts.append(fitting.sample_bezier(cp, np.linspace(0, 1, n)))
    for seg in lines:
        n = max(int(np.linalg.norm(seg[1] - seg[0]) // sample_resolution), 2)
        t = np.linspace(0, 1, n)
        per_edge_pts.append(seg[0] + t[:, None] * (seg[1] - seg[0]))
    if not per_edge_pts:
        return edge_dict
    needed = math.ceil(frames_ratio * len(cameras))
    visible_count = np.zeros(len(per_edge_pts), int)
    for cam, emap in zip(cameras, edge_maps):
        emap = host_array(emap)
        h, w = emap.shape
        proj = host_array(cam.full_proj)
        for e, pts in enumerate(per_edge_pts):
            hom = pts @ proj[:3, :3].T + proj[:3, 3]
            ww = pts @ proj[3, :3] + proj[3, 3]
            ok = ww > 1e-6
            ndc = hom[:, :2] / np.maximum(ww[:, None], 1e-6)
            u = ((ndc[:, 0] + 1) * w - 1) * 0.5
            v = ((ndc[:, 1] + 1) * h - 1) * 0.5
            ui, vi = np.round(u).astype(int), np.round(v).astype(int)
            ok &= (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h)
            if not ok.any():
                continue
            resp = emap[vi[ok], ui[ok]]
            if resp.mean() > edge_visibility_threshold and resp.max() > 0.5:
                visible_count[e] += 1
    keep = visible_count >= needed
    return {
        "curves_ctl_pts": curves[keep[: len(curves)]].reshape(-1, 12).tolist(),
        "lines_end_pts": lines[keep[len(curves):]].reshape(-1, 6).tolist(),
    }


def save_parametric_edges(edge_dict: Dict, model_path: str) -> str:
    os.makedirs(model_path, exist_ok=True)
    path = os.path.join(model_path, "parametric_edges.json")
    with open(path, "w") as f:
        json.dump(edge_dict, f)
    return path


def save_edge_points_ply(points: np.ndarray, model_path: str) -> str:
    path = os.path.join(model_path, "edge_points.ply")
    write_ply(path, points)
    return path
