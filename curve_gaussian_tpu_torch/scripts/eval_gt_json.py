"""Evaluate a parametric_edges.json against a ground-truth edge JSON, as the
repository's ``scripts/eval_gt_json.py`` does with the JAX package.

Both files use the extraction format ({curves_ctl_pts, lines_end_pts});
the metrics are the ABC harness's (Chamfer, P/R/F1/IOU at 5/10/20 mm,
direction similarity; ``eval/metrics.py``).  For fabricated scenes that
ship a gt_edges.json (``scripts/make_ref_scale_scene.py``).  Host only.

    python -m curve_gaussian_tpu_torch.scripts.eval_gt_json --pred <run>/parametric_edges.json \\
        --gt <scene>/gt_edges.json [--out eval.json]
"""
from __future__ import annotations

import argparse
import json

from ..eval import metrics as M
from ..eval.extract import sample_edge_dict


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="evaluate predicted edges against a GT edge JSON")
    p.add_argument("--pred", required=True)
    p.add_argument("--gt", required=True)
    p.add_argument("--out", default=None)
    return p.parse_args(argv)


def eval_gt_json(argv=None) -> dict:
    """The metrics dict the script prints (and writes to ``--out``)."""
    args = parse_args(argv)
    with open(args.pred) as f:
        pred = json.load(f)
    with open(args.gt) as f:
        gt = json.load(f)
    pred_pts, pred_dirs = sample_edge_dict(pred, with_directions=True)
    gt_pts, gt_dirs = sample_edge_dict(gt, with_directions=True)
    res = M.evaluate_edges(pred_pts, gt_pts, pred_dirs, gt_dirs)
    res["n_pred_curves"] = len(pred.get("curves_ctl_pts", []))
    res["n_pred_lines"] = len(pred.get("lines_end_pts", []))
    for k, v in res.items():
        print(f"{k}: {v:.4f}" if isinstance(v, float) else f"{k}: {v}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    eval_gt_json()
