"""ABC-NEF evaluation harness, as ``curve_gaussian_tpu/eval/abc.py``
(reference edge_extraction/eval_ABC.py and eval_utils.get_gt_points); host
numpy.

The ground-truth sharp edges come from the ABC CAD data: each scan's .obj
vertices and the chunk_0000_feats.json curve annotations (BSpline, Circle,
Ellipse -> 'curve'; Line -> 'line'); vertex chains are resampled at 5 mm
and put into the unit cube with the scan's bbox from
chunk_0000_stats.json.  Predictions come from parametric_edges.json.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..data.png import write_png
from .extract import sample_edge_dict
from .metrics import evaluate_edges

CURVE_TYPE_RENAME = {
    "BSpline": "curve",
    "Circle": "curve",
    "Ellipse": "curve",
    "Line": "line",
}


def load_obj_vertices(path: str) -> np.ndarray:
    verts = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            t = line.split()
            if t and t[0] == "v":
                verts.append([float(t[1]), float(t[2]), float(t[3])])
    return np.asarray(verts, np.float64)


def get_gt_points(
    scan_name: str,
    data_base_dir: str,
    edge_type: str = "all",
    interval: float = 0.005,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(points [N,3], directions [N,3]) of the GT sharp edges in the unit
    cube, or None when the scan has none of `edge_type`."""
    objs_dir = os.path.join(data_base_dir, "obj")
    index = {n[:8]: n for n in sorted(os.listdir(objs_dir))}
    with open(os.path.join(data_base_dir, "chunk_0000_feats.json")) as f:
        feats = json.load(f)
    with open(os.path.join(data_base_dir, "chunk_0000_stats.json")) as f:
        stats = json.load(f)
    x_min, y_min, z_min, x_max, y_max, z_max, xr, yr, zr = stats[scan_name]["bbox"]
    scale = 1.0 / max(xr, yr, zr)
    center = np.array([(x_min + x_max) / 2, (y_min + y_max) / 2, (z_min + z_max) / 2]) * scale
    offset = np.array([0.5, 0.5, 0.5]) - center

    verts = load_obj_vertices(os.path.join(objs_dir, index[scan_name]))
    pts_out, dir_out = [], []
    for curve in feats[scan_name]:
        if edge_type != "all" and CURVE_TYPE_RENAME[curve["type"]] != edge_type:
            continue
        if not curve["sharp"]:
            continue
        chain = verts[np.asarray(curve["vert_indices"], int)]
        for a, b in zip(chain[:-1], chain[1:]):
            seg = np.linalg.norm(b - a)
            num = int(seg // interval)
            if num <= 0:
                continue
            # the reference samples linspace * current + (1 - linspace) * next:
            # t = 0 lands on the next vertex
            t = np.linspace(0.0, 1.0, num)
            pts_out.append(t[:, None] * a + (1 - t)[:, None] * b)
            dir_out.append(np.tile((b - a) / seg, (num, 1)))
    if not pts_out:
        return None
    pts = np.concatenate(pts_out) * scale + offset
    dirs = np.concatenate(dir_out)
    return pts.astype(np.float32), dirs.astype(np.float32)


def evaluate_scan(
    pred_json_path: str,
    scan_name: str,
    data_base_dir: str,
    thresholds=(0.005, 0.01, 0.02),
) -> Dict[str, float]:
    """Every metric for one scan (eval_ABC.process_scan), with per-type
    (curve, line) accuracy and completeness."""
    with open(pred_json_path) as f:
        edge_dict = json.load(f)
    pred_pts, pred_dirs = sample_edge_dict(edge_dict, with_directions=True)
    gt = get_gt_points(scan_name, data_base_dir)
    if gt is None:
        return {}
    gt_pts, gt_dirs = gt
    out = evaluate_edges(pred_pts, gt_pts, pred_dirs, gt_dirs, thresholds)
    out["n_curves"] = len(edge_dict.get("curves_ctl_pts", []))
    out["n_lines"] = len(edge_dict.get("lines_end_pts", []))
    # per type, all predictions against that type's GT (eval_ABC.py:225-240)
    for etype in ("curve", "line"):
        gt_t = get_gt_points(scan_name, data_base_dir, edge_type=etype)
        if gt_t is None:
            continue
        res_t = evaluate_edges(pred_pts, gt_t[0], thresholds=thresholds)
        out[f"acc_{etype}"] = res_t["accuracy"]
        out[f"comp_{etype}"] = res_t["completeness"]
    return out


PANEL = 256  # pixels a side of one projection in the diagnostic
GT_RGB = (31, 119, 180)
PRED_RGB = (214, 39, 40)


def scatter_diagnostic(pred_pts: np.ndarray, gt_pts: np.ndarray, out_png: str) -> None:
    """A per-scan picture of prediction against GT for eyeballing a batch
    run (the reference's matplotlib scatter, eval_utils.py:17-62, drawn as
    a numpy point raster): rows are the xy, xz and yz orthographic
    projections, GT (blue) on the left and the prediction (red) on the
    right, both panels of a row on one scale with equal axes; no labels.
    Writes a [3 PANEL + 4, 2 PANEL + 3] RGB PNG (grey 1-pixel rules
    between panels)."""
    rows = []
    for i, j in ((0, 1), (0, 2), (1, 2)):
        both = [p[:, [i, j]] for p in (gt_pts, pred_pts) if len(p)]
        lo = np.min([b.min(0) for b in both], 0) if both else np.zeros(2)
        hi = np.max([b.max(0) for b in both], 0) if both else np.ones(2)
        span = max(float((hi - lo).max()), 1e-9)
        mid = (lo + hi) / 2
        tiles = []
        for pts, rgb in ((gt_pts, GT_RGB), (pred_pts, PRED_RGB)):
            tile = np.full((PANEL, PANEL, 3), 255, np.uint8)
            if len(pts):
                uv = (pts[:, [i, j]] - mid) / span * (PANEL - 3) + (PANEL - 1) / 2
                u = np.clip(np.round(uv[:, 0]).astype(int), 0, PANEL - 1)
                v = np.clip(np.round(PANEL - 1 - uv[:, 1]).astype(int), 0, PANEL - 1)
                tile[v, u] = rgb
            tiles.append(tile)
        rows.append(np.concatenate([tiles[0], np.full((PANEL, 1, 3), 128, np.uint8),
                                    tiles[1]], axis=1))
    rule = np.full((1, 2 * PANEL + 1, 3), 128, np.uint8)
    img = np.concatenate([rule, rows[0], rule, rows[1], rule, rows[2], rule], axis=0)
    img = np.pad(img, ((0, 0), (1, 1), (0, 0)), constant_values=128)
    write_png(out_png, img)


def evaluate_batch(
    output_dir: str,
    scan_names: List[str],
    data_base_dir: str,
    log_path: Optional[str] = None,
) -> Dict[str, float]:
    """Mean metrics over scans, each scan's prediction read from
    <output_dir>/<scan>/parametric_edges.json (eval_ABC.main); a
    ``pred_vs_gt.png`` diagnostic is written beside each prediction."""
    per_scan = {}
    for scan in scan_names:
        p = os.path.join(output_dir, scan, "parametric_edges.json")
        if not os.path.exists(p):
            continue
        per_scan[scan] = evaluate_scan(p, scan, data_base_dir)
        with open(p) as f:
            pred_pts, _ = sample_edge_dict(json.load(f))
        gt = get_gt_points(scan, data_base_dir)
        if gt is not None:
            scatter_diagnostic(pred_pts, gt[0], os.path.join(output_dir, scan, "pred_vs_gt.png"))
    agg: Dict[str, float] = {}
    if per_scan:
        keys = set().union(*(set(v) for v in per_scan.values()))
        for k in keys:
            vals = np.array([v[k] for v in per_scan.values() if k in v], float)
            vals[np.isnan(vals)] = 0
            agg[k] = round(float(vals.mean()), 4)
    if log_path:
        with open(log_path, "w") as f:
            json.dump({"mean": agg, "per_scan": per_scan}, f, indent=1)
    return agg
